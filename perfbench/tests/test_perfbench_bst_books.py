"""BST on Amazon Books (``configs/bst_books.json``, the cell
``bst_books.train_b16k``, DIEN's mix ``amazon_books_behavior``): found by
the names ``BENCHMARK.json`` gives, the port's parameters at emb 32, 8
heads, FFN 384 and tower 1024-512-256 those of ``reference/bst.py``,
``arith/bst_books.py`` against a count of the reference's products and
the mix's history lengths, the ``attention_ms`` and
``attention_roofline`` readers on a hand-made trace, and ``session.run``
at the configuration's widths and history of 100 on the CPU (cut in
batch, pool and space counts): ``correct``, and not with half of each
batch left out."""
import json
import time
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import arith, metrics
from perfbench.core import program, session
from perfbench.core import trace as tracing
from perfbench.generators import behavior
from perfbench.reference import bst, ctr
from deeprec_tpu_torch.train.trainer import Trainer

ROOT = Path(__file__).resolve().parents[2]
BENCH = session.benchmark()
CELL = "bst_books.train_b16k"
CFG = session.load_json("configs", "bst_books")
MIX = session.load_json("traffic", "amazon_books_behavior")
TINY = json.loads((Path(__file__).resolve().parent / "data" / "cells"
                   / "dien_tiny.train.json").read_text())
NEW = ("attention_ms", "attention_roofline")


def test_the_cell_and_its_configuration_are_found_by_name():
    (w,) = [w for w in BENCH["workloads"] if w["name"] == CELL]
    (c,) = [c for c in BENCH["configs"] if c["name"] == "bst_books"]
    cell = session.load_json("cells", CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        (w["config"], w["traffic"], w["chips"]) == \
        ("bst_books", "amazon_books_behavior", 1)
    assert json.loads((ROOT / c["file"]).read_text()) == CFG
    assert c["reduced"] == CFG["reduced"] == []
    assert ctr.model(CFG) is bst
    assert (CFG["emb_dim"], CFG["heads"], CFG["blocks"], CFG["d_ff"],
            CFG["hidden_units"]) == (32, 8, 1, 384, [1024, 512, 256])
    assert CFG["flags"] == ["--max_len", str(MIX["max_len"]),
                            "--dropout", "0"]
    assert cell["batch"] == 64 * 256  # the paper's batch, 64 times
    for m in BENCH["per_layer"]:
        assert CELL in m["workloads"], m["name"]
        if m["name"] in NEW:
            assert m["workloads"] == [CELL]


def test_the_port_has_the_references_parameters_at_emb_32():
    tr, args = program.build({**CFG, "capacity": 1 << 12}, 64, 0.5, 7,
                             "cpu")
    assert (args.max_len, args.dropout) == (100, 0.0)
    coll = tr.collections["emb"]
    assert {c.name: c.categorical.max_length for c in coll.columns} == {
        "item": 1, "cate": 1, "uid": 1, "hist_item": 100, "hist_cate": 100}
    assert coll.config.embedding_dim == 32
    params = bst.params(CFG)
    assert [(n, tuple(p.shape)) for n, p in tr.model.named_parameters()] \
        == [(n, tuple(s)) for n, s, _ in params]
    shapes = {n: tuple(s) for n, s, _ in params}
    assert shapes["block.attention.qkv.weight"] == (288, 96)
    assert shapes["block.ffn_in.weight"] == (384, 96)
    assert shapes["fc.0.weight"] == (1024, 9728)
    assert tr.model.block.attention.heads == 8
    assert tr.model.block.dropout == 0.0


def test_the_token_moments_are_the_mixs_length_law():
    a = arith.load("bst_books")
    tokens, pairs = a.token_moments(CFG)
    assert tokens == pytest.approx(MIX["rows"] / MIX["spaces"][2]["count"],
                                   abs=1e-3)  # the mean history, plus one
    assert pairs == pytest.approx(538.6059, abs=1e-3)
    n = 1 << 16
    lens = (behavior.draw(MIX, n, 5, "cpu")["hist_item"] >= 0).sum(1)
    t = lens.double() + 1
    assert float(t.mean()) == pytest.approx(tokens, rel=0.02)
    assert float((t * t).mean()) == pytest.approx(pairs, rel=0.05)


def test_arith_counts_the_references_products():
    """On full histories (every token valid) the count is the
    reference's: the matrix products ``FlopCounterMode`` counts in a
    forward and backward, every input and weight taking a gradient, an
    example; and by hand at the mix's moments."""
    a = arith.load("bst_books")
    t, p = a.token_moments(CFG)
    per_token = 96 * 288 + 96 * 96 + 96 * 384 + 384 * 96
    tower = 9728 * 1024 + 1024 * 512 + 512 * 256 + 256
    assert a.forward_macs(CFG) == (per_token * t, 192 * p, tower)
    assert a.train_flops_per_example(CFG) == \
        pytest.approx(6 * (per_token * t + 192 * p + tower))
    assert a.attention_flops_per_example(CFG) == pytest.approx(6 * 192 * p)
    assert a.attention_bytes_per_example(CFG) == \
        pytest.approx(4 * t * (12 * 96 + 16))
    b, L, e = 2, 100, CFG["emb_dim"]
    g = torch.Generator().manual_seed(0)
    mask = torch.ones((b, L), dtype=torch.bool)
    seq = {c: (torch.randn((b, L, e), generator=g).requires_grad_(True),
               mask) for c in CFG["history"]}
    inputs = {"names": CFG["candidate"] + CFG["context"], "seq": seq,
              "dense": None,
              "emb": torch.randn((b, 3, e), generator=g).requires_grad_()}
    w = {n: (torch.randn(s, generator=g) * 0.1).requires_grad_(True)
         for n, s, _ in bst.params(CFG)}
    with FlopCounterMode(display=False) as fc:
        z, _ = bst.forward(CFG, w, inputs, True)
        z.sum().backward()
    full = a.forward_macs(CFG, (L + 1, (L + 1) ** 2))
    assert fc.get_total_flops() == b * 6 * sum(full)


def _x(name, cat="kernel", ts=0.0, dur=1.0):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": 7}


FWD = ("fmha_cutlassF_f32_aligned_64x64_rf_sm80(PyTorchMemEffAttention::"
       "AttentionKernel<float, cutlass::arch::Sm80, true, 64, 64, 64, true, "
       "true>::Params)")
BWD = ("fmha_cutlassB_f32_aligned_64x64_k32_sm80(PyTorchMemEffAttention::"
       "AttentionBackwardKernel<cutlass::arch::Sm80, float, true, false, "
       "false, 64, 64, 32, false>::Params)")


def _ctx(names, cfg=CFG, config="bst_books"):
    events = [_x("cudaLaunchKernel", "cuda_runtime", 0, 1),
              _x("cudaDeviceSynchronize", "cuda_runtime", 9000, 1)]
    events += [_x(n, ts=float(10 + i), dur=float(d))
               for i, (n, d) in enumerate(names)]
    trace = tracing.reduce(events)
    return session.TracedRun(trace, 2, 4, 8, [], cfg, arith.load(config),
                             5, [3, 3], [203 * 4, 203 * 4])


def test_attention_ms_reads_the_memory_efficient_kernels():
    names = [(FWD, 300.0), (BWD, 500.0),
             ("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize256x64x8", 70.0),
             ("void at::native::vectorized_layer_norm_kernel<float>", 11.0),
             ("void (anonymous namespace)::din_attention_forward<4>", 13.0)]
    ctx = _ctx(names)
    assert metrics.load("attention_ms").read(ctx) == \
        pytest.approx(800 / 1e3 / 2)
    # gemm_ms reads the same two (their names hold "cutlass")
    assert metrics.load("gemm_ms").read(ctx) == pytest.approx(870 / 1e3 / 2)
    assert metrics.load("attention_ms").read(_ctx(names[2:])) is None


def test_attention_roofline_is_the_larger_bound_over_the_kernels():
    a = arith.load("bst_books")
    ctx = _ctx([(FWD, 300.0), (BWD, 500.0)])
    ms = 800 / 1e3 / 2
    bound = max(a.attention_flops_per_example(CFG) / 67e12,
                a.attention_bytes_per_example(CFG) / 3.35e12) * 8 / 2 * 1e3
    assert metrics.load("attention_roofline").read(ctx) == \
        pytest.approx(100 * bound / ms)
    # bytes bound it: float32 at 192 multiply-adds a pair
    assert a.attention_bytes_per_example(CFG) / 3.35e12 > \
        a.attention_flops_per_example(CFG) / 67e12
    # DIEN's configuration has no such count: nothing to read
    dien = session.load_json("configs", "dien_books")
    assert metrics.load("attention_roofline").read(
        _ctx([(FWD, 300.0)], dien, "dien_books")) is None
    assert metrics.load("attention_roofline").read(
        ctx._replace(trace=None)) is None


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


def test_the_cut_cell_is_correct_on_the_cpu():
    out = _run(2 ** 31 + 11)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert out["table"]["keys"] == 3000 + 1600 + 3000
    assert set(out["metrics"]) == {"train_examples_per_s", "setup_s"}


def test_the_cut_cell_traced_reads_its_host_metric():
    out = _run(3000000019, trace=True)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"host_pack_ms"}


def test_half_a_batch_left_out_is_caught(monkeypatch):
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
