"""DIEN on Amazon Books (``configs/dien_books.json``, the cell
``dien_books.train_b16k``, the mix ``amazon_books_behavior``): found by
the names ``BENCHMARK.json`` gives, the port's parameters at emb 18 / GRU
36 those of ``reference/dien.py``, the mix's histories, label and fitted
exponents, ``arith/dien_books.py`` against a count of the reference's
products, the ``pointwise_ms`` reader on a hand-made trace, and
``session.run`` at the configuration's widths and its history of 100 on
the CPU (cut in batch, pool and space counts): ``correct``, and not with
half of each batch left out."""
import json
import time
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import arith, metrics
from perfbench.core import program, session, traffic
from perfbench.core import trace as tracing
from perfbench.generators import behavior
from perfbench.reference import ctr, dien
from deeprec_tpu_torch.train.trainer import Trainer

ROOT = Path(__file__).resolve().parents[2]
BENCH = session.benchmark()
CELL = "dien_books.train_b16k"
CFG = session.load_json("configs", "dien_books")
MIX = session.load_json("traffic", "amazon_books_behavior")
TINY = json.loads((Path(__file__).resolve().parent / "data" / "cells"
                   / "dien_tiny.train.json").read_text())


def test_the_cell_and_its_configuration_are_found_by_name():
    (w,) = [w for w in BENCH["workloads"] if w["name"] == CELL]
    (c,) = [c for c in BENCH["configs"] if c["name"] == "dien_books"]
    cell = session.load_json("cells", CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        (w["config"], w["traffic"], w["chips"]) == \
        ("dien_books", "amazon_books_behavior", 1)
    assert json.loads((ROOT / c["file"]).read_text()) == CFG
    assert c["reduced"] == CFG["reduced"] == []
    assert ctr.model(CFG) is dien
    assert traffic.generator(MIX["generator"]) is behavior
    assert (CFG["emb_dim"], CFG["gru_units"], CFG["att_units"],
            CFG["hidden_units"]) == (18, 36, [80, 40], [200, 80])
    assert CFG["flags"] == ["--max_len", "100"] == \
        ["--max_len", str(MIX["max_len"])]
    # the least power of two that Books' ids fill at most half of
    ids = sum(s["count"] for s in MIX["spaces"])
    assert CFG["capacity"] // 2 >= ids > CFG["capacity"] // 4
    for m in BENCH["per_layer"]:
        assert CELL in m["workloads"], m["name"]


def test_the_port_has_the_references_parameters_at_emb_18():
    tr, args = program.build({**CFG, "capacity": 1 << 12}, 64, 0.5, 7,
                             "cpu")
    assert args.max_len == 100
    coll = tr.collections["emb"]
    assert {c.name: c.categorical.max_length for c in coll.columns} == {
        "item": 1, "cate": 1, "uid": 1, "hist_item": 100, "hist_cate": 100}
    assert coll.config.embedding_dim == 18
    params = dien.params(CFG)
    assert [(n, tuple(p.shape)) for n, p in tr.model.named_parameters()] \
        == [(n, tuple(s)) for n, s, _ in params]
    shapes = {n: tuple(s) for n, s, _ in params}
    assert shapes["interest_extractor.cell.gates.weight"] == (72, 72)
    assert shapes["interest_evolution.cell.cand.weight"] == (36, 72)
    assert shapes["fc.0.weight"] == (200, 126)
    program.load_weights(tr, params, {n: torch.zeros(s) for n, s, _ in
                                      params})


def test_a_pool_of_the_mix_has_books_histories_and_labels():
    n = 1 << 14
    cols = behavior.draw(MIX, n, 1, "cpu")
    h = cols["hist_item"]
    assert h.shape == cols["hist_cate"].shape == (n, 100)
    lens = (h >= 0).sum(1)
    assert int(lens.min()) >= 4 and int(lens.max()) <= 100
    want = MIX["rows"] / MIX["spaces"][2]["count"] - 1
    assert abs(float(lens.double().mean()) / want - 1) < 0.1
    assert 0.45 <= float(cols["label"].mean()) <= 0.55
    p = traffic.make_pool(MIX, 1024, 256, 1, "cpu")
    assert p.width == 3 + 200 and len(p.batches) == 4
    assert [s.count for s in p.spaces] == [367982, 1600, 603668]


def test_the_length_exponent_gives_the_books_mean_history():
    k = torch.arange(1, MIX["max_len"] - MIX["min_len"] + 2,
                     dtype=torch.float64)
    w = k ** -MIX["length_exponent"]
    mean = MIX["min_len"] + float(((k - 1) * w).sum() / w.sum())
    assert mean == pytest.approx(MIX["rows"] / MIX["spaces"][2]["count"]
                                 - 1, abs=1e-3)


@pytest.mark.parametrize("i", [0, 1, 2])
def test_each_exponent_is_the_fit_to_its_count(i):
    v, a = MIX["spaces"][i]["count"], MIX["zipf_exponents"][i]
    assert traffic.expected_distinct(a * (1 - 1e-5), MIX["rows"]) > v
    assert traffic.expected_distinct(a * (1 + 1e-5), MIX["rows"]) < v
    assert MIX["column_counts"][i] == v


def test_arith_counts_the_references_products():
    """Forward and backward of the reference at the configuration's
    widths and history, every input and weight taking a gradient: the
    matrix products ``FlopCounterMode`` counts, an example, against
    ``train_flops_per_example``; and by hand."""
    a = arith.load("dien_books")
    assert a.forward_macs(CFG) == 100 * (72 * 72 + 72 * 36) * 2 \
        + 100 * (144 * 80 + 80 * 40 + 40) + 36 * 36 \
        + 2 * 99 * 36 * 36 + 126 * 200 + 200 * 80 + 80 == 3_330_384
    assert a.train_flops_per_example(CFG) == 6 * 3_330_384
    b, L, e = 3, 100, CFG["emb_dim"]
    g = torch.Generator().manual_seed(0)
    mask = torch.arange(L)[None, :] < torch.tensor([100, 7, 40])[:, None]
    seq = {c: (torch.randn((b, L, e), generator=g).requires_grad_(True),
               mask) for c in CFG["history"]}
    names = CFG["candidate"] + CFG["context"]
    inputs = {"names": names, "seq": seq, "dense": None,
              "emb": torch.randn((b, 3, e), generator=g).requires_grad_()}
    w = {n: (torch.randn(s, generator=g) * 0.1).requires_grad_(True)
         for n, s, _ in dien.params(CFG)}
    with FlopCounterMode(display=False) as fc:
        z, aux = dien.forward(CFG, w, inputs, True)
        (z.sum() + aux).backward()
    assert fc.get_total_flops() == b * a.train_flops_per_example(CFG)


def _x(name, cat="kernel", ts=0.0, dur=1.0):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": 7}


def test_pointwise_ms_counts_what_no_other_reader_counts():
    names = [
        ("void at::native::vectorized_elementwise_kernel<4, "
         "at::native::sigmoid_kernel_cuda>", 10, True),
        ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<"
         "float, at::native::MeanOps>>", 20, True),
        ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<"
         "float>", 40, True),
        ("void at::native::sort_postprocess_kernel<long>", 80, False),
        ("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<long>",
         160, False),
        ("void (anonymous namespace)::k1::gather_rows_kernel<float2>", 320,
         False),
        ("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n", 640, False),
        ("void cutlass::Kernel2<cutlass_80_simt_sgemm_128x256>", 1280,
         False),
        ("void cublasLt::splitKreduce_kernel<at::native::x>", 2560, False),
    ]
    events = [_x("cudaLaunchKernel", "cuda_runtime", 0, 1),
              _x("cudaDeviceSynchronize", "cuda_runtime", 9000, 1)]
    events += [_x(n, ts=float(10 + i), dur=float(d))
               for i, (n, d, _) in enumerate(names)]
    events.append(_x("Memcpy HtoD (at::native::copy)", "gpu_memcpy", 5,
                     5000))
    trace = tracing.reduce(events)
    ctx = session.TracedRun(trace, 2, 4, 8, [], CFG,
                            arith.load("dien_books"), 5, [3, 3],
                            [203 * 4, 203 * 4])
    reader = metrics.load("pointwise_ms")
    want = sum(d for _, d, mine in names if mine)
    assert reader.read(ctx) == pytest.approx(want / 1e3 / 2)
    others = [metrics.load(m) for m in ("embedding_kernel_ms",
                                        "index_kernel_ms", "gemm_ms")]
    for op in trace.ops:
        ours = reader.pointwise(op)
        assert ours == any(n == op.name and mine for n, _, mine in names)
        if ours:
            one = session.TracedRun(trace._replace(ops=[op]), 1, 4, 4, [],
                                    CFG, None, 5, [3], [203 * 4])
            assert all(r.read(one) is None for r in others)
    assert reader.read(ctx._replace(trace=None)) is None
    assert reader.read(ctx._replace(trace=trace._replace(ops=[]))) is None


def _cut():
    """The cell at the configuration's widths and history, cut in batch,
    pool and space counts, with the tiny test cell's limits."""
    cell = {**session.load_json("cells", CELL), "batch": 64,
            "pool_examples": 512, "warm_steps": 1, "lead_steps": 2,
            "trace_steps": 3, "limits": TINY["limits"]}
    mix = {**MIX, "spaces": [{**s, "count": min(s["count"], 3000)}
                             for s in MIX["spaces"]]}
    return cell, {**CFG, "capacity": 1 << 15}, mix


def _run(seed, trace=False):
    cell, cfg, mix = _cut()
    return session.run(cell, cfg, mix, seed, 0.3, trace, "cpu",
                       time.perf_counter(), BENCH, lambda m: None)


@pytest.mark.parametrize("seed", [2 ** 31 + 11, 3000000019])
def test_the_cut_cell_is_correct_on_the_cpu(seed):
    out = _run(seed)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert out["table"]["keys"] == 3000 + 1600 + 3000
    assert set(out["metrics"]) == {"train_examples_per_s", "setup_s"}


def test_the_cut_cell_traced_reads_its_host_metric():
    out = _run(2 ** 31 + 13, trace=True)
    assert out["correct"], out["checks"]
    # the CPU trace has no device operations: only the host clock's reader
    assert set(out["metrics"]) == {"host_pack_ms"}


def test_half_a_batch_left_out_is_caught_at_history_100(monkeypatch):
    step = Trainer._train_step

    def half(self, state, dense, cats, labels):
        n = labels.shape[0] // 2
        return step(self, state, None if dense is None else dense[:n],
                    {k: v[..., :n] for k, v in cats.items()}, labels[:n])
    monkeypatch.setattr(Trainer, "_train_step", half)
    out = _run(2 ** 31 + 11)
    assert not out["correct"]
    c = out["checks"]
    assert c["loss_gap"]["value"] > c["loss_gap"]["limit"]
