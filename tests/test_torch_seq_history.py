"""The behaviour models' history length and DIEN's spans, on the CPU.

``--max_len`` (``train/cli.py``) reaches DIN's, DIEN's and DSSM's history
columns and the behaviour streams; without it the entries keep their
``MAX_LEN`` (32), read when ``build`` runs, so a patched value is
honoured. With the recorder on (``utils/spans.py``), a DIEN step records
its forward's five spans inside ``step.forward_backward`` and its three
counters; on or off, the step makes the same ATen operations and gives
bit-equal losses, gradients and updates."""
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from deeprec_tpu_torch.modelzoo.DIEN import train as dien
from deeprec_tpu_torch.modelzoo.DIN import train as din
from deeprec_tpu_torch.modelzoo.DSSM import train as dssm
from deeprec_tpu_torch.train import cli
from deeprec_tpu_torch.utils import spans

torch.set_num_threads(1)

ENTRIES = {"DIN": din, "DIEN": dien, "DSSM": dssm}
SMALL = ["--batch_size", "16", "--emb_dim", "4", "--capacity", "4096",
         "--optimizer", "adam", "--learning_rate", "0.002",
         "--synthetic_items", "400", "--synthetic_users", "60",
         "--eval_steps", "1", "--seed", "5", "--device", "cpu"]
DIEN_SPANS = ("dien.interest_extractor", "dien.attention",
              "dien.interest_evolution", "dien.tower", "dien.aux_loss")


@pytest.fixture(autouse=True)
def recorder_off():
    spans.stop()
    yield
    spans.stop()


def _args(kind, extra=()):
    return cli.base_parser(kind).parse_args(SMALL + list(extra))


def _history_widths(spec):
    return {c.name: c.categorical.max_length
            for c in spec.collections["emb"].columns
            if c.name.startswith("hist_")}


@pytest.mark.parametrize("kind", sorted(ENTRIES))
def test_max_len_reaches_the_history_columns_and_the_streams(kind):
    args = _args(kind, ["--max_len", "7"])
    widths = _history_widths(ENTRIES[kind].build(args))
    assert widths and set(widths.values()) == {7}
    for stream in (cli.behavior_train_stream(args),
                   cli.behavior_eval_stream(args)):
        b = next(iter(stream))
        assert b["hist_item"].shape == b["hist_cate"].shape == (16, 7)


@pytest.mark.parametrize("kind", sorted(ENTRIES))
def test_without_the_flag_the_entry_keeps_its_max_len(kind, monkeypatch):
    args = _args(kind)
    assert args.max_len is None
    assert set(_history_widths(ENTRIES[kind].build(args)).values()) == {32}
    assert next(iter(cli.behavior_train_stream(args)))["hist_item"].shape \
        == (16, 32)
    # read when build runs, not at import
    monkeypatch.setattr(ENTRIES[kind], "MAX_LEN", 5)
    assert set(_history_widths(ENTRIES[kind].build(args)).values()) == {5}


def _dien(max_len=6):
    args = _args("DIEN", ["--max_len", str(max_len)])
    tr = cli.make_trainer(dien.build(args), args)
    batch = next(iter(cli.behavior_train_stream(args)))
    return tr, batch


def test_a_dien_step_records_its_forward_spans_and_counters():
    tr, batch = _dien()
    state = tr.init(batch)
    args = tr.prepare_batch(batch)
    spans.start()
    tr._train_step(state, *args)
    snap = spans.stop()
    (fb,) = [r for r in snap.records if r.name == "step.forward_backward"]
    got = [r for r in snap.records if r.name.startswith("dien.")]
    assert sorted(r.name for r in got) == sorted(DIEN_SPANS)
    for r in got:
        assert r.parent == fb.id and r.batch == fb.batch == 0
        assert fb.start_ns <= r.start_ns <= r.end_ns <= fb.end_ns
    order = sorted(got, key=lambda r: r.start_ns)
    assert [r.name for r in order] == list(DIEN_SPANS)
    c = snap.counters
    assert c["seq.lanes"] == 16 * 6
    assert c["seq.valid_lanes"] == int((batch["hist_item"] >= 0).sum())
    assert 0 < c["seq.valid_lanes"] < c["seq.lanes"]
    assert c["seq.recurrence_steps"] == 2 * 6


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_the_recorder_leaves_a_dien_step_bit_equal():
    """Two equal trainers, one step each on one batch, the recorder off
    then on: the same ATen operations, and the same loss, gradient of
    every parameter, parameters and table after the step, bit for bit."""
    seen = []
    for on in (False, True):
        tr, batch = _dien()
        state = tr.init(batch)
        args = tr.prepare_batch(batch)
        if on:
            spans.start()
        with _Ops() as mode:
            state = tr._train_step(state, *args)
        snap = spans.stop()
        assert bool(snap.records) == on
        seen.append((mode.ops, float(state.metrics.loss_sum),
                     {n: (p.detach().clone(), p.grad.clone())
                      for n, p in tr.model.named_parameters()},
                     state.tables["emb"].ev.values.clone()))
    (ops0, loss0, p0, t0), (ops1, loss1, p1, t1) = seen
    assert ops0 == ops1
    assert loss0 == loss1
    assert p0.keys() == p1.keys()
    for n in p0:
        assert torch.equal(p0[n][0], p1[n][0]), n
        assert torch.equal(p0[n][1], p1[n][1]), n
    assert torch.equal(t0, t1)
