"""The program's spans on a hand-made device trace (``core/host_spans``):
the idle gaps intersected with the main thread's spans, the readings by
batch number, idle time by thread and runtime call, and the shared clock;
then the diagnostic's traced window on the CPU."""
import pytest

from perfbench import idle_report
from perfbench.core import host_spans
from perfbench.core import trace as tracing
from perfbench_tiny import tiny

MAIN, WORKER = 11, 12  # native thread ids, the spans' tid
# the ids CUPTI gives the same threads' CUDA calls in the trace
CUPTI = {MAIN: 0x5EBC7300, WORKER: 0x60000940}


def _x(name, cat, ts, dur, tid=MAIN, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": args}


_ids = iter(range(100))


def _span(name, ts, dur, tid=MAIN, batch=None, parent=None, thread="main"):
    return _x(name, "deeprec", ts, dur, tid, batch=batch, id=next(_ids),
              parent=parent, thread=thread)


def _rt(name, ts, dur, tid=MAIN, **args):
    return _x(name, "cuda_runtime", ts, dur, CUPTI[tid], **args)



MARK0 = _span("capture.mark", 0, 2)
STEP1 = _span("step", 2, 38, batch=1)
FENCE = _span("loop.fence", 96, 4, batch=2)
EVENTS = [
    MARK0, STEP1,
    _span("step.forward_backward", 5, 25, batch=1, parent=STEP1["args"]["id"]),
    _span("loop.next_batch", 40, 20, batch=2),
    _span("step", 60, 35, batch=2),
    FENCE,
    _span("capture.mark", 97, 3, parent=FENCE["args"]["id"]),
    # a prefetch worker packs and copies batch 2; its synchronize is open
    # while the main thread waits for that batch
    _span("pack", 10, 45, tid=WORKER, batch=2, thread="prefetch-0"),
    _span("copy", 55, 3, tid=WORKER, batch=2, thread="prefetch-0"),
    _rt("cudaDeviceSynchronize", 42, 16, tid=WORKER),
    _rt("cudaEventRecord", 0, 1),
    _rt("cudaLaunchKernel", 6, 1, correlation=1),
    _rt("cudaLaunchKernel", 21, 3, correlation=2),
    _rt("cudaLaunchKernel", 45, 1),
    _rt("cudaLaunchKernel", 61, 1, correlation=3),
    _rt("cudaEventRecord", 98, 2),
    _x("sm90_xmma_gemm_f32f32", "kernel", 8, 12, tid=7, correlation=1),
    _x("sm90_xmma_gemm_f32f32", "kernel", 25, 13, tid=7, correlation=2),
    _x("gather_rows_kernel", "kernel", 63, 27, tid=7, correlation=3),
]
RAW = {"traceEvents": EVENTS, "deeprec": {"counters": {"lookup.lanes": 10},
                                          "dropped": 0}}


def test_idle_gaps_go_to_the_main_threads_span_not_a_workers_call():
    t = tracing.reduce(EVENTS)
    # the window's reduction blames the 25 us gap on the worker's call
    labels = {(s, d): lab for s, d, lab in t.gaps}
    assert labels[(38.0, 25.0)] == "cudaDeviceSynchronize"
    r = host_spans.report(RAW)
    assert r["idle_awaiting_batch_pct"] == pytest.approx(20.0)
    assert r["idle_in_step_pct"] == pytest.approx(21.0)
    idle = 100 * (1 - t.busy_s / t.window_s)
    assert idle == pytest.approx(48.0)
    assert r["idle_in_step_pct"] + r["idle_awaiting_batch_pct"] <= idle
    main = r["idle_by_span"]["main"]
    assert main["loop.next_batch"] == pytest.approx(20e-6)
    assert main["step.forward_backward"] == pytest.approx(8e-6)
    assert main["step"] == pytest.approx(13e-6)
    assert main["capture.mark"] == pytest.approx(5e-6)
    assert main["loop.fence"] == pytest.approx(1e-6)
    assert main["none"] == pytest.approx(1e-6)
    assert sum(main.values()) == pytest.approx(48e-6)
    calls = r["idle_by_span"]["calls"]
    assert calls["prefetch-0"] == pytest.approx(
        {"cudaDeviceSynchronize": 16e-6, "none": 32e-6})
    assert calls["main (main)"]["cudaEventRecord"] == pytest.approx(3e-6)


def test_readings_follow_the_traced_steps_batch_numbers():
    r = host_spans.report(RAW)
    assert r["steps"] == 2
    assert r["batch_wait_ms"] == pytest.approx(0.010)  # 20 us over 2 steps
    assert r["pack_ms"] == pytest.approx(0.045)  # batch 1 packed before
    assert r["spans"]["step"]["count"] == 2
    assert r["spans"]["step"]["mean_ms"] == pytest.approx(0.0365)
    assert r["spans"]["step"]["self_ms_per_step"] == pytest.approx(0.024)
    assert r["spans"]["pack"]["threads"] == "prefetch-0"
    assert r["counters"] == {"lookup.lanes": 5.0}


def test_the_shared_clock_puts_launches_and_marks_inside_their_spans():
    r = host_spans.report(RAW)
    assert r["launches_in_spans_pct"] == pytest.approx(75.0)
    assert r["clock_us"] == [[0.0, 1.0], [1.0, 0.0]]


def test_a_trace_without_program_spans_reads_nothing():
    bare = [e for e in EVENTS if e["cat"] != "deeprec"]
    assert host_spans.report({"traceEvents": bare}) is None


def test_a_thread_without_spans_keeps_its_trace_id():
    """The runtime calls of a thread the program has no span on (the
    autograd engine's device thread) keep the trace's id; the worker's id
    is matched to the worker whose spans hold its calls."""
    extra = [_x("cudaLaunchKernel", "cuda_runtime", 62, 1, tid=777)]
    r = host_spans.report({"traceEvents": EVENTS + extra})
    calls = r["idle_by_span"]["calls"]
    assert calls["tid 777"]["cudaLaunchKernel"] == pytest.approx(1e-6)
    assert set(calls) == {"main (main)", "prefetch-0", "tid 777"}


def test_innermost_labels_nested_intervals():
    got = host_spans.innermost([(0, 10, "a"), (2, 4, "b"), (3, 4, "c"),
                                (6, 12, "d")])
    assert got == [(0, 2, "a"), (2, 3, "b"), (3, 4, "c"), (4, 6, "a"),
                   (6, 12, "d")]


def test_the_diagnostic_traces_a_cpu_window_with_the_programs_spans():
    cell, cfg, mix = tiny()
    # the workers run ahead of the steps: the window's first batches were
    # packed before the recorder started, the later ones inside it
    cell["trace_steps"] = 8
    out, raw = idle_report.traced(cell, cfg, mix, 2 ** 31 + 5, "cpu",
                                  0.0, lambda m: None)
    r = out["spans_report"]
    # the CPU has no device operations: its window is one idle gap
    assert out["correct"] and set(out["metrics"]) == {"host_pack_ms"}
    assert r["steps"] == cell["trace_steps"] and r["dropped"] == 0
    for name in ("loop.next_batch", "step", "step.sparse_lookup",
                 "step.forward_backward", "loop.fence"):
        assert r["spans"][name]["count"] >= cell["trace_steps"] - 1, name
    marks = [e for e in raw["traceEvents"] if e["name"] == "capture.mark"]
    assert len(marks) == 2  # the window's first and last
    assert r["counters"]["lookup.lanes"] == 26 * cell["batch"]
    assert 0 < r["idle_in_step_pct"]
    assert r["idle_in_step_pct"] + r["idle_awaiting_batch_pct"] <= 100
    assert r["batch_wait_ms"] >= 0 and r["pack_ms"] > 0
