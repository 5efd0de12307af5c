"""The port's span and counter recorder (``utils/spans.py``) on the CPU:
off, it returns one shared span and makes no tensor; on, it records nested
spans with their parents, threads and batch numbers and sums counters
across threads; its clock is a ``torch.profiler`` trace's; the training
loops record each batch's packing, copy, wait and step under one number;
recording adds no operation to a step; ``--profile`` writes the spans and
counters into its trace."""
import json
import sys
import threading
import time

import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.profiler import ProfilerActivity, profile, record_function
from torch.utils._python_dispatch import TorchDispatchMode

from deeprec_tpu_torch.data.criteo import SyntheticCriteo
from deeprec_tpu_torch.modelzoo.DLRM import train as dlrm
from deeprec_tpu_torch.train import cli
from deeprec_tpu_torch.train.pipeline import HostStepPipeline
from deeprec_tpu_torch.utils import spans

torch.set_num_threads(1)

SMALL = ["--batch_size", "32", "--emb_dim", "4", "--capacity", "8192",
         "--eval_steps", "1", "--prefetch_depth", "2",
         "--prefetch_workers", "2", "--device", "cpu"]


@pytest.fixture(autouse=True)
def recorder_off():
    spans.stop()
    yield
    spans.stop()


class _Calls(TorchFunctionMode):
    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.calls.append(func)
        return func(*args, **(kwargs or {}))


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _by(snap, name):
    return [r for r in snap.records if r.name == name]


def _program(counters):
    return {k: v for k, v in counters.items()
            if not k.startswith("launches.")}


def test_an_off_recorder_shares_one_span_and_makes_no_tensor():
    with _Calls() as mode:
        a, b = spans.span("step", 3), spans.span("pack")
        with a:
            spans.count("lookup.unique", 5)
    assert a is b and mode.calls == [] and not spans.recording()
    spans.start()
    snap = spans.stop()
    assert snap.records == [] and _program(snap.counters) == {}


def test_spans_nest_per_thread_and_counters_sum_across_threads():
    seen = {}

    def worker():
        seen["tid"] = threading.get_native_id()
        with spans.span("pack", 9):
            with spans.span("pack.np"):
                spans.count("lookup.unique", torch.tensor(3))
                spans.count("lookup.unique", 2)
    spans.start()
    with spans.span("step", 7):
        with spans.span("step.metrics"):
            spans.count("lookup.unique", torch.tensor(5, dtype=torch.int32))
    t = threading.Thread(target=worker, name="prefetch-x")
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    spans.count("lookup.unique", 1)
    snap = spans.stop()
    (step,), (metrics,) = _by(snap, "step"), _by(snap, "step.metrics")
    (pack,), (np_,) = _by(snap, "pack"), _by(snap, "pack.np")
    assert step.parent is None and metrics.parent == step.id
    assert metrics.batch == 7 and np_.batch == 9 and np_.parent == pack.id
    assert step.tid == threading.get_native_id() and step.thread == \
        threading.current_thread().name
    assert pack.tid == np_.tid == seen["tid"] and pack.thread == "prefetch-x"
    assert step.start_ns <= metrics.start_ns <= metrics.end_ns <= step.end_ns
    assert abs(step.start_ns - time.time_ns()) < 60e9
    assert snap.counters["lookup.unique"] == 11 and snap.dropped == 0


def test_appends_from_many_threads_lose_nothing_and_the_buffer_is_bounded(
        monkeypatch):
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker(i):
            for j in range(300):
                with spans.span("copy", i * 1000 + j):
                    spans.count("lookup.lanes", 1)
        spans.start()
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        snap = spans.stop()
    finally:
        sys.setswitchinterval(old)
    assert len(snap.records) == 16 * 300 and snap.dropped == 0
    assert snap.counters["lookup.lanes"] == 16 * 300
    assert len({r.id for r in snap.records}) == 16 * 300
    monkeypatch.setattr(spans, "CAPACITY", 5)
    spans.start()
    for j in range(8):
        with spans.span("copy", j):
            pass
    snap = spans.stop()
    assert [r.batch for r in snap.records] == list(range(5))
    assert snap.dropped == 3


def test_a_span_lands_on_the_profiler_trace_clock(tmp_path):
    """ts * 1000 + baseTimeNanoseconds of a record_function inside a span
    falls inside the span, its ends within 100 us of the span's (the
    best of five; a few us of slack for the trace's rounding)."""
    names = [f"probe{i}" for i in range(5)]
    spans.start()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for name in names:
            rf = record_function(name)
            with spans.span(name):
                with rf:
                    time.sleep(0.002)
    snap = spans.stop()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    spans.add_to_chrome_trace(path, snap)
    trace = json.load(open(path))
    base = int(trace["baseTimeNanoseconds"])
    events = trace["traceEvents"]
    worst = []
    for name in names:
        (rf,) = [e for e in events if e.get("name") == name
                 and e.get("cat") == "user_annotation"]
        (sp,) = [e for e in events if e.get("name") == name
                 and e.get("cat") == "deeprec"]
        (rec,) = _by(snap, name)
        assert sp["ts"] * 1e3 + base == pytest.approx(rec.start_ns, abs=1e3)
        lead = rf["ts"] * 1e3 + base - rec.start_ns
        lag = rec.end_ns - (rf["ts"] + rf["dur"]) * 1e3 - base
        assert lead > -5e3 and lag > -5e3, (lead, lag)
        worst.append(max(lead, lag))
    assert min(worst) <= 100e3, worst
    assert trace["deeprec"]["dropped"] == 0


def _trainer(extra=()):
    args = cli.base_parser("DLRM").parse_args(SMALL + list(extra))
    tr = cli.make_trainer(dlrm.build(args), args)
    return tr, args


def _batches(n, seed=5):
    return SyntheticCriteo(batch_size=32, seed=seed).take(n)


def test_the_device_index_loop_numbers_each_batch_through_its_threads():
    tr, args = _trainer()
    batches = list(_batches(7))
    state = tr.init(batches[0])
    state, _ = cli._device_index_loop(tr, state, batches[:1], args, 1 << 30,
                                      lambda st, done: st)
    spans.start()
    state, done = cli._device_index_loop(tr, state, batches[1:], args, 2,
                                         lambda st, done: st)
    snap = spans.stop()
    assert done == 6
    steps = range(1, 7)
    main = threading.current_thread().name
    for k in steps:
        one = {n: [r for r in _by(snap, n) if r.batch == k] for n in (
            "pack", "pack.np", "pack.pin", "copy", "loop.next_batch",
            "step", "step.sparse_lookup", "step.forward_backward",
            "step.sparse_apply", "step.dense_apply", "step.metrics")}
        assert all(len(v) == 1 for v in one.values()), {
            n: len(v) for n, v in one.items()}
        (pack,), (copy,), (step,) = one["pack"], one["copy"], one["step"]
        assert one["pack.np"][0].parent == pack.id
        assert one["pack.pin"][0].parent == pack.id
        assert pack.thread.startswith("prefetch-") and \
            copy.thread.startswith("prefetch-")
        assert step.thread == one["loop.next_batch"][0].thread == main
        assert one["step.metrics"][0].parent == step.id
        assert step.start_ns >= copy.end_ns >= copy.start_ns >= pack.end_ns
    # a fence when the step counter reaches a multiple of 2, numbered as
    # the step just run; the last wait found the end of the stream
    assert [r.batch for r in _by(snap, "loop.fence")] == [1, 3, 5]
    assert [r.batch for r in _by(snap, "loop.next_batch")] == \
        list(range(1, 8))
    c = snap.counters
    assert c["lookup.lanes"] == 6 * 26 * 32
    assert 0 < c["lookup.unique"]
    assert c["lookup.unique"] + c["lookup.overflow"] <= c["lookup.lanes"]


def test_recording_adds_no_operation_to_a_step():
    """The same step on two equal trainers, recorder off then on: the
    same ATen operations, so no kernel and no host sync is added."""
    batch = next(iter(_batches(1)))
    ops = []
    for on in (False, True):
        tr, _ = _trainer(["--seed", "3"])
        state = tr.init(batch)
        args = tr.prepare_batch(batch)
        if on:
            spans.start()
        with _Ops() as mode:
            tr._train_step(state, *args)
        snap = spans.stop()
        ops.append(mode.ops)
        assert len(snap.records) == (6 if on else 0)
    # (the plain CPU versions of the index read the host; the card's
    # kernels do not)
    assert ops[0] == ops[1]


def test_the_pipeline_records_resolve_and_transfer_per_batch():
    spans.start()
    with HostStepPipeline(lambda x: torch.tensor([x]), depth=2,
                          device="cpu") as pipe:
        for k in range(4):
            pipe.feed(k * 10, batch=k)
            assert int(pipe.take()[0]) == k * 10
    snap = spans.stop()
    for name, thread in (("resolve", "hidx-resolve"),
                         ("transfer", "hidx-h2d")):
        recs = _by(snap, name)
        assert sorted(r.batch for r in recs) == [0, 1, 2, 3]
        assert all(r.thread.startswith(thread) for r in recs)
    for k in range(4):
        (r,) = [x for x in _by(snap, "resolve") if x.batch == k]
        (t,) = [x for x in _by(snap, "transfer") if x.batch == k]
        assert t.start_ns >= r.end_ns


@pytest.mark.parametrize("engine,names", [
    ("device", ("pack", "copy", "loop.next_batch", "step")),
    ("host", ("pack", "resolve", "transfer", "loop.next_batch", "step"))])
def test_profile_writes_the_loop_spans_into_its_trace(engine, names,
                                                      tmp_path):
    flags = ["--steps", "4", "--log_steps", "2", "--profile",
             str(tmp_path)] + (["--host_index"] if engine == "host" else [])
    args = cli.base_parser("DLRM").parse_args(SMALL + flags)
    out = cli.run(dlrm.build(args), args)
    assert out["steps"] == 4 and not spans.recording()
    trace = json.loads((tmp_path / "DLRM_trace.json").read_text())
    ours = [e for e in trace["traceEvents"] if e.get("cat") == "deeprec"]
    for name in names:
        got = sorted(e["args"]["batch"] for e in ours if e["name"] == name)
        assert got[:4] == [0, 1, 2, 3], (name, got)
    steps = [e for e in ours if e["name"] == "step"]
    assert {e["tid"] for e in steps} == {threading.get_native_id()}
    assert len([e for e in ours if e["name"] == "loop.fence"]) == 2
    counters = trace["deeprec"]["counters"]
    assert counters["lookup.lanes"] == 4 * 26 * 32
    assert 0 < counters["lookup.unique"] <= 4 * 26 * 32
    assert counters["launches.gather_rows"] == 0  # CPU: the plain versions
    # a host index keeps no device index: its rows are the resolver's
    assert (counters["rows.created"] > 0) == (engine == "device")
