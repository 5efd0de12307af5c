"""DIEN taken in as new files only (``reference/dien.py``,
``generators/behavior.py`` and the test's configuration, cell and mix
under ``tests/data``), run through the port's own entry
(``modelzoo/DIEN/train.py``) and the CLI's device-index loop at a size the
CPU holds: ``correct`` under Adagrad and Adam, and not under half of each
batch left out or a step that returns its state unchanged. The reference's
equations against the port's model and against finite differences, at
float64."""
import json
import re
import time
from pathlib import Path

import pytest
import torch

from perfbench.core import session
from perfbench.reference import ctr, dien
from deeprec_tpu_torch.models import sequence
from deeprec_tpu_torch.modelzoo.DIEN import train as dien_entry
from deeprec_tpu_torch.train.trainer import Trainer

DATA = Path(__file__).resolve().parent / "data"
PB = Path(__file__).resolve().parents[1]
BENCH = session.benchmark()
OPTIMIZERS = {"adagrad": {"optimizer": "adagrad", "learning_rate": 0.05},
              "adam": {}}


def load(kind: str, name: str) -> dict:
    return json.loads((DATA / kind / f"{name}.json").read_text())


@pytest.fixture
def files(monkeypatch):
    """The tiny cell, its configuration and mix; the entry's history
    length set to the mix's (the entry fixes it at 32)."""
    cell = load("cells", "dien_tiny.train")
    cfg = load("configs", cell["config"])
    mix = load("traffic", cell["traffic"])
    monkeypatch.setattr(dien_entry, "MAX_LEN", mix["max_len"])
    return cell, cfg, mix


def _run(cell, cfg, mix, seed):
    return session.run(cell, cfg, mix, seed, 0.3, False, "cpu",
                       time.perf_counter(), BENCH, lambda m: None)


@pytest.mark.parametrize("seed", [2 ** 31 + 5, 3000000011, 17])
@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_dien_from_new_files_is_correct(files, opt, seed):
    cell, cfg, mix = files
    out = _run(cell, {**cfg, **OPTIMIZERS[opt]}, mix, seed)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert out["table"]["keys"] == sum(s["count"] for s in mix["spaces"])


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_dien_half_a_batch_left_out_is_caught(files, monkeypatch, opt):
    step = Trainer._train_step

    def half(self, state, dense, cats, labels):
        n = labels.shape[0] // 2
        return step(self, state, None if dense is None else dense[:n],
                    {k: v[..., :n] for k, v in cats.items()}, labels[:n])
    monkeypatch.setattr(Trainer, "_train_step", half)
    cell, cfg, mix = files
    out = _run(cell, {**cfg, **OPTIMIZERS[opt]}, mix, 2 ** 31 + 5)
    assert not out["correct"]
    c = out["checks"]
    assert c["loss_gap"]["value"] > c["loss_gap"]["limit"]


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_dien_step_that_returns_its_state_unchanged_is_caught(
        files, monkeypatch, opt):
    monkeypatch.setattr(Trainer, "_train_step",
                        lambda self, state, *item: state)
    cell, cfg, mix = files
    out = _run(cell, {**cfg, **OPTIMIZERS[opt]}, mix, 2 ** 31 + 5)
    assert not out["correct"]
    assert out["checks"]["loss_gap"]["value"] == pytest.approx(1.0)


def test_no_harness_file_names_the_model_or_its_generator():
    names = re.compile(r"\bdien\b|\bbehaviou?r\b", re.IGNORECASE)
    for f in sorted((PB / "core").glob("*.py")):
        assert not names.search(f.read_text()), f.name


def _inputs(cfg, b=6, L=5, seed=0, dtype=torch.float64):
    """One-id rows, histories with ragged lengths (one of length 1), and
    weights from the reference's parameter list."""
    g = torch.Generator().manual_seed(seed)
    e = cfg["emb_dim"]
    lengths = torch.tensor([L, 1, 3, L, 2, 4][:b])
    mask = torch.arange(L)[None, :] < lengths[:, None]
    seq = {c: (torch.randn((b, L, e), generator=g, dtype=dtype)
               * mask[..., None], mask) for c in cfg["history"]}
    names = cfg["candidate"] + cfg["context"]
    inputs = {"names": names, "seq": seq, "dense": None,
              "emb": torch.randn((b, len(names), e), generator=g,
                                 dtype=dtype)}
    w = {}
    for name, shape, init in dien.params(cfg):
        w[name] = torch.randn(shape, generator=g, dtype=dtype) * 0.3
    return inputs, w


def _small_cfg():
    return {**load("configs", "dien_tiny"), "emb_dim": 2, "gru_units": 3,
            "att_units": [5, 4], "hidden_units": [6, 3]}


def test_the_reference_is_the_port_model_at_float64():
    cfg = load("configs", "dien_tiny")
    inputs, w = _inputs(cfg)
    model = sequence.DIEN(
        candidate_name="item", seq_name="hist_item", emb_dim=cfg["emb_dim"],
        candidate_context_names=["cate"], seq_context_names=["hist_cate"],
        context_names=["uid"], gru_units=cfg["gru_units"],
        hidden_units=tuple(cfg["hidden_units"]),
        att_units=tuple(cfg["att_units"]), use_aux_loss=True).double()
    assert [(n, tuple(p.shape)) for n, p in model.named_parameters()] == \
        [(n, tuple(s)) for n, s, _ in dien.params(cfg)]
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(w[n])
    emb = {n: inputs["emb"][:, i] for i, n in enumerate(inputs["names"])}
    logits, aux = model(None, emb, inputs["seq"], train=True,
                        return_aux=True)
    ref_logits, ref_aux = ctr.model(cfg).forward(cfg, w, inputs, True)
    torch.testing.assert_close(ref_logits, logits, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(ref_aux, aux, rtol=1e-12, atol=1e-12)


def test_the_reference_gradients_are_autograd_of_its_loss_at_float64():
    """Autograd through the reference's loss against central finite
    differences, for the rows and for every parameter."""
    cfg = _small_cfg()
    inputs, w = _inputs(cfg)
    names = list(w)
    y = torch.tensor([1.0, 0.0, 1.0, 1.0, 0.0, 0.0], dtype=torch.float64)

    def loss(emb, hist, *params):
        x = {**inputs, "emb": emb,
             "seq": {**inputs["seq"],
                     "hist_item": (hist, inputs["seq"]["hist_item"][1])}}
        z, aux = dien.forward(cfg, dict(zip(names, params)), x, True)
        bce = torch.nn.functional.binary_cross_entropy_with_logits(z, y)
        return bce + cfg["aux_loss_weight"] * aux
    args = [inputs["emb"].clone().requires_grad_(True),
            inputs["seq"]["hist_item"][0].clone().requires_grad_(True)]
    args += [w[n].clone().requires_grad_(True) for n in names]
    assert torch.autograd.gradcheck(loss, args, eps=1e-6, atol=1e-7)
