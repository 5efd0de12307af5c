"""The step bisect (``deeprec_tpu_torch/probes/step_bisect.py``), the
probe that finds where two runs of one training step part, on the CPU at
a small size: it restores the whole state between its two runs (so two
runs of a deterministic step compare bit-equal in every tensor they
make), it names the first tensor that differs when one run is perturbed
(a pooled row, a rows' cotangent), and the finder restores the
deterministic-algorithms mode it sets. On the card ``chip_smoke.py``'s
``determinism`` phase runs the bisect on every one-card path."""
import pytest
import torch

from deeprec_tpu_torch import config as cfg
from deeprec_tpu_torch import feature_column as fc
from deeprec_tpu_torch.data.criteo import (CAT_NAMES, DENSE_NAMES,
                                           SyntheticCriteo)
from deeprec_tpu_torch.host_index import HostIndexEmbeddingCollection
from deeprec_tpu_torch.models.ctr import DLRM
from deeprec_tpu_torch.ops import fused_lookup
from deeprec_tpu_torch.optim.dense import Adagrad
from deeprec_tpu_torch.optim.sparse import sparse_adagrad
from deeprec_tpu_torch.probes import step_bisect as sb
from deeprec_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)


def _trainer(engine):
    """A small DLRM (B 64, emb 8) on either engine, two steps trained."""
    torch.manual_seed(0)
    cols = [fc.EmbeddingColumn(fc.CategoricalColumn(n), 8)
            for n in CAT_NAMES]
    init = cfg.Initializer("normal", scale=0.05)
    if engine == "host_index":
        coll = HostIndexEmbeddingCollection(cols, name="emb",
                                            capacity=1 << 12,
                                            initializer=init)
    else:
        coll = fc.EmbeddingCollection(cols, name="emb", capacity=1 << 12,
                                      initializer=init)
    tr = Trainer(DLRM(CAT_NAMES, 8, bottom_units=(16, 8),
                      top_units=(16, 8), dense_dim=len(DENSE_NAMES)),
                 [fc.NumericColumn(n, log_normalize=True)
                  for n in DENSE_NAMES], {"emb": coll},
                 {"emb": sparse_adagrad(0.05)}, Adagrad(0.05), device="cpu")
    batches = list(SyntheticCriteo(batch_size=64, seed=3).take(3))
    st = tr.init(batches[0])
    for b in batches[:2]:
        st = tr.train_step(st, b)
    args = tr.prepare_batch(batches[2])
    return tr, st, lambda: args


@pytest.mark.parametrize("engine", ["host_index", "device_index"])
def test_two_runs_of_a_step_compare_equal(engine):
    tr, st, args = _trainer(engine)
    before = [x.clone() for x in tr.model.parameters()]
    diff, n, new = sb.bisect(tr, st, args)
    assert diff is None
    assert n > 60  # inputs, every module's output, cotangents, grads, state
    assert new.step == st.step + 1
    # each run stepped a copy of the state; the model is left as the
    # second run updated it
    assert not any(torch.equal(a, b) for a, b in
                   zip(before, tr.model.parameters()))
    _, rec = sb.capture_step(tr, sb.clone_state(st), args())
    names = [name for name, _ in rec]
    assert names[0].startswith("emb embeddings")  # the pooling comes first
    assert any(name.startswith("model input") for name in names)
    assert any(name.startswith("cotangent emb rows") for name in names)
    assert any(name.startswith("grad ") for name in names)
    assert names.index(next(x for x in names if x.startswith("cotangent"))) \
        < names.index(next(x for x in names if x.startswith("grad ")))


@pytest.mark.parametrize("where", ["backward", "forward"])
def test_a_perturbed_run_is_named(where, monkeypatch):
    """One ulp added on every other call of K2's plain backward (or
    forward) makes the second run differ first at the rows' cotangent (or
    the pooled rows the model reads)."""
    tr, st, args = _trainer("host_index")
    name = ("fused_pooled_lookup_backward_plain" if where == "backward"
            else "fused_pooled_lookup_plain")
    real, calls = getattr(fused_lookup, name), [0]

    def nudged(*a, **k):
        out = real(*a, **k)
        calls[0] += 1
        if calls[0] % 2 == 0:
            out = out.clone()
            out.view(torch.int32).view(-1)[3] += 1
        return out
    monkeypatch.setattr(fused_lookup, name, nudged)
    diff, _, _ = sb.bisect(tr, st, args)
    assert diff is not None
    first, d = diff
    if where == "backward":
        assert first.startswith("cotangent emb rows")
    else:
        assert first.startswith("emb embeddings") or \
            first.startswith("model input")
    assert 0 < d < 1e-6


def test_finder_restores_the_mode():
    tr, st, args = _trainer("device_index")
    saved = [x.clone() for x in tr.model.parameters()]
    found = sb.finder(tr, st, args())
    assert isinstance(found, list)
    assert not torch.are_deterministic_algorithms_enabled()
    assert all(torch.equal(a, b) for a, b in
               zip(saved, tr.model.parameters()))


def test_first_difference_compares_bits():
    a = [("x", torch.tensor([0.0, 1.0])), ("y", torch.tensor([1, 2]))]
    assert sb.first_difference(a, [(n, t.clone()) for n, t in a]) is None
    neg = [("x", torch.tensor([-0.0, 1.0])), ("y", torch.tensor([1, 2]))]
    assert sb.first_difference(a, neg)[0] == "x"  # -0.0 is not 0.0
    assert sb.first_difference(a, a[:1])[0].startswith("the two runs")
    c = [("x", torch.tensor([0.0, 1.0])), ("y", torch.tensor([1, 3]))]
    assert sb.first_difference(a, c) == ("y", 1.0)
