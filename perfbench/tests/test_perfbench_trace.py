"""The trace's reduction and the per-layer readers, on a hand-made
Chrome trace: busy time, idle gaps by what the host was doing, each
device operation's launching ops, and the metrics read from them."""
import pytest

from perfbench import arith, metrics
from perfbench.core import session
from perfbench.core import trace as tracing

CFG = session.load_json("configs", "dlrm_kaggle")


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": args}


EVENTS = [
    _x("cudaEventRecord", "cuda_runtime", 0, 1),
    _x("cudaLaunchKernel", "cuda_runtime", 6, 1, correlation=1),
    _x("cudaLaunchKernel", "cuda_runtime", 21, 3, correlation=2),
    _x("cudaLaunchKernel", "cuda_runtime", 40, 1, correlation=3),
    _x("cudaMemcpyAsync", "cuda_runtime", 70, 20, tid=2),
    _x("cudaDeviceSynchronize", "cuda_runtime", 95, 5),
    _x("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<long>",
       "kernel", 10, 10, tid=7, correlation=1),
    _x("sm90_xmma_gemm_f32f32", "kernel", 25, 20, tid=7, correlation=2),
    _x("void (anonymous namespace)::k1::gather_rows_kernel<uint4>",
       "kernel", 50, 10, tid=7, correlation=3),
    _x("cub::DeviceRadixSortSingleTileKernel<long>", "kernel", 98, 30,
       tid=7),
    _x("aten::mm", "cpu_op", 21, 3),
]


def test_reduce_finds_busy_time_and_gaps_by_host_call():
    t = tracing.reduce(EVENTS)
    assert t.window == (0.0, 100.0) and t.busy_us == pytest.approx(42.0)
    labels = {(s, d): lab for s, d, lab in t.gaps}
    assert labels[(0.0, 10.0)] == tracing.NO_CALL
    assert labels[(20.0, 5.0)] == "cudaLaunchKernel"
    assert labels[(60.0, 38.0)] == "cudaMemcpyAsync"
    b = tracing.breakdown(t)
    assert b["device_ops"][0] == ["sm90_xmma_gemm_f32f32", 20e-6]
    assert dict(b["idle_gaps"])["cudaMemcpyAsync"] == pytest.approx(38e-6)


def _ctx(trace):
    return session.TracedRun(trace, 2, 4, 8, [0.001, 0.003], CFG,
                             arith.load("dlrm_kaggle"), 5, [3, 3],
                             [26 * 4, 26 * 4])


def test_readers_take_their_metrics_from_the_trace():
    ctx = _ctx(tracing.reduce(EVENTS))
    read = {n: metrics.load(n).read(ctx) for n in (
        "device_idle_pct", "launches_per_step", "host_pack_ms",
        "embedding_kernel_ms", "index_kernel_ms", "gemm_ms", "train_mfu",
        "embedding_roofline")}
    assert read["device_idle_pct"] == pytest.approx(58.0)
    assert read["launches_per_step"] == 2.0
    assert read["host_pack_ms"] == pytest.approx(2.0)
    assert read["embedding_kernel_ms"] == pytest.approx(0.005)
    assert read["index_kernel_ms"] == pytest.approx(0.005)  # not 1-tile
    assert read["gemm_ms"] == pytest.approx(0.010)
    flops = 13_387_616 * 8
    assert read["train_mfu"] == pytest.approx(100 * flops / 100e-6 / 67e12)
    assert 0 < read["embedding_roofline"]


def test_readers_with_nothing_to_read_return_none():
    t = tracing.reduce([EVENTS[0], EVENTS[-1]])
    ctx = _ctx(t)
    for n in ("device_idle_pct", "launches_per_step", "embedding_kernel_ms",
              "index_kernel_ms", "gemm_ms", "train_mfu",
              "embedding_roofline"):
        assert metrics.load(n).read(ctx) is None, n
