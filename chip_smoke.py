"""Card smoke test of the PyTorch port (deeprec_tpu_torch): its serving
path and its host-index training path.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

It imports no JAX. Float32 throughout: TF32 is switched off for matrix
products and convolutions, so both sides of every comparison compute in
full f32. Phases (any failure exits non-zero):

1. builds the hand-written CUDA kernels from deeprec_tpu_torch/csrc/ (nvcc,
   sm_90a, one process per source) and, at the same time, the design
   probes of deeprec_tpu_torch/probes/kernel_probe.cu, and prints the
   build time;
2. runs each kernel's wrapper against its plain PyTorch version at the
   shapes the main paths give it (a B=4096 Criteo batch), and times the
   kernel, the plain version and one PyTorch library call computing the
   same function with CUDA events, beside the kernel's HBM-bytes bound:
   K1 and K2 at the serving shape; K2 (both directions), K1's optimizer
   read and K3a (lookup_meta, and the three-plane meta_scatter it
   replaced on the path) at the training shape of one resolved batch;
   K3a's scatter_set and K3b at the JAX benchmark's own shape (CAP 2^21,
   U 17,664). The previous design of K2's forward (a probe variant) and
   the three-plane K3a are timed in turns with their successors, back to
   back and behind a PyTorch kernel as on the path, and the probe's
   variants of K2's forward say what remains of its time;
3. writes a full-width DLRM serving checkpoint (13 dense + 26 categorical
   columns, emb dim 16, fused adagrad columns, a 2^21-slot table holding the
   keys of 20 synthetic Criteo batches; weights and rows from seed 0);
4. serves 5 held-out B=4096 batches with Predictor(device="cuda") and with
   Predictor(device="cpu") (the plain versions) and holds the card's
   probabilities to the CPU's; the kernels' launch counts over this run
   must be above 0; prints the p50 predict latency;
5. serves HTTP over the card's predictor (predict, healthz, a dynamically
   batched pair), writes an incremental save, /refresh-es and checks the
   changed predictions against a CPU predictor refreshed the same way;
6. trains bench.py's --metadata configuration at full width (the DLRM
   above on a host-index table of 2^21 rows with the native resolver,
   CounterFilter(1) + GlobalStepEvict, fused Adagrad, optax-style dense
   Adagrad) on SyntheticCriteo(4096, seed=7): 5 steps in lockstep with a
   CPU Trainer (own resolver, same weights) holding wires and metadata
   planes bit-equal and losses and rows within tolerance, then 3 timed
   runs of 10 steps with the host half staged ahead (bench.py's default
   method) and 3 with it inline, and a torch.profiler breakdown of 3
   steps; K1, K2, K2's backward and K3a (lookup_meta) must have launched;
7. the light layout (bench.py's default, lazy init): 3 steps in lockstep
   with a CPU Trainer, then 3 timed runs of 10 steps.

The last line is {"ok": true, "device": {...}}; the line before it holds
the kernels' numbers as JSON, the line before that the training numbers.
"""
from __future__ import annotations

import concurrent.futures
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
B = 4096
CAPACITY = 1 << 21
EMB_DIM = 16
PROB_ATOL = 1e-4   # card vs CPU probabilities: f32 sums in another order
POOL_RTOL = 1e-5   # kernel K2 vs plain: f32 sums in another order
# K2 backward vs plain: f32 atomics add in a run-dependent order; a sum of
# k terms errs by at most ~k*eps of the sum of their magnitudes
BWD_TOL = 1e-4
LOSS_ATOL = 1e-4   # card vs CPU trainer per-step loss (f32, other orders)
ROW_ATOL = 1e-4    # card vs CPU trainer table rows after the lockstep
MAX_UNIQUE = 26 * B // 6  # bench.py's dedup width: U = 17,750 lanes
K3B_U = 17664      # benchmarks/pallas_meta_bench.py's own U (and CAP 2^21)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM peak (the card's power limit printed)


def log(*a):
    print(*a, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(fn, samples=21, per_sample=20, warmup=5):
    """Device ms per call of ``fn``: the median over ``samples`` of the
    CUDA-event time around ``per_sample`` back-to-back calls, divided by
    ``per_sample``. A sleep kernel queued first holds the stream while the
    host enqueues the calls, so the host's launch overhead is not in the
    reading (L2 not flushed)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)  # ~10 ms of cycles
        a.record()
        for _ in range(per_sample):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per_sample)
    return statistics.median(times)


def wall_ms(fn, calls=100):
    """Host-clock ms per call over ``calls`` back-to-back calls, including
    the host's launch overhead (what a caller on the serving path pays)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def bound(nbytes):
    """(bound_ms, bytes): the least time to move ``nbytes`` at peak HBM
    rate. The kernels here do a few operations per byte, far below the
    card's compute peaks, so bytes bound them all."""
    return nbytes / HBM_BYTES_PER_S * 1e3, int(nbytes)


def entry(name, source, replaces, err, ms, plain_ms, library_ms, nbytes,
          **extra):
    bound_ms, nbytes = bound(nbytes)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": library_ms, "bytes": nbytes, **extra}


def log_times(what, ms, plain_ms, library_ms, nbytes, extra=""):
    bms, _ = bound(nbytes)
    lib = "null" if library_ms is None else f"{library_ms:.4f}"
    log(f"{what}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
        f"{lib} ms, bound {bms:.4f} ms ({nbytes} bytes at 3.35 TB/s){extra}")


def criteo_parts():
    from deeprec_tpu_torch import config as cfg
    from deeprec_tpu_torch import feature_column as fc
    from deeprec_tpu_torch.data.criteo import CAT_NAMES, DENSE_NAMES
    from deeprec_tpu_torch.models.ctr import DLRM
    numeric = [fc.NumericColumn(n, log_normalize=True) for n in DENSE_NAMES]
    cols = [fc.EmbeddingColumn(fc.CategoricalColumn(n), EMB_DIM)
            for n in CAT_NAMES]
    coll = fc.EmbeddingCollection(
        cols, name="emb", capacity=CAPACITY,
        initializer=cfg.Initializer("normal", scale=0.05))
    model = DLRM(CAT_NAMES, EMB_DIM, bottom_units=(512, 256),
                 top_units=(1024, 1024, 512, 256), dense_dim=len(DENSE_NAMES))
    return numeric, coll, model


# -- phase 2 -----------------------------------------------------------------
def check_kernels(dev, probe):
    from deeprec_tpu_torch.data.criteo import SyntheticCriteo
    from deeprec_tpu_torch.ops.fused_lookup import (
        COMBINERS, fused_pooled_lookup, fused_pooled_lookup_plain)
    from deeprec_tpu_torch.ops.gather import gather_rows, gather_rows_plain
    from deeprec_tpu_torch.ops.unique import unique

    g = torch.Generator(device="cpu").manual_seed(SEED)
    # the serving path's shapes: the unique keys of one B=4096 batch
    _, coll, _ = criteo_parts()
    batch = next(SyntheticCriteo(batch_size=B, seed=11))
    uniq = unique(coll.pack_ids(batch, dev).reshape(-1))
    n_slots = uniq.ukeys.shape[0]
    table = torch.randn(CAPACITY + 1, 2 * EMB_DIM, generator=g).to(dev)
    slots = torch.randint(0, CAPACITY, (n_slots,), generator=g).to(dev)
    # EMPTY padding lanes read the null row, as on the serving path
    slots = torch.where(uniq.ukeys == -1, CAPACITY, slots)
    log(f"K1 shape: values {tuple(table.shape)} f32, slots [{n_slots}] "
        f"({int(uniq.n_unique)} unique keys), d_out {EMB_DIM}")
    got = gather_rows(table, slots, EMB_DIM)
    ref = gather_rows_plain(table, slots, EMB_DIM)
    k1_err = (got - ref).abs().max().item()
    if k1_err != 0:
        fail(f"K1 differs from its plain version by {k1_err}")
    k1_ms = time_ms(lambda: gather_rows(table, slots, EMB_DIM))
    k1_plain = time_ms(lambda: gather_rows_plain(table, slots, EMB_DIM))
    log(f"K1 gather_rows: kernel {k1_ms:.4f} ms, plain {k1_plain:.4f} ms "
        f"(device); host clock per call: kernel "
        f"{wall_ms(lambda: gather_rows(table, slots, EMB_DIM)):.4f} ms, plain "
        f"{wall_ms(lambda: gather_rows_plain(table, slots, EMB_DIM)):.4f} ms;"
        f" max_abs_err {k1_err}")

    # K2 on the path: 26 width-1 columns pooled in one [26*B, 1] launch
    urows = got
    inv = uniq.inverse.view(-1, 1)
    valid = (uniq.ukeys != -1)[uniq.inverse].view(-1, 1)
    cases = [("criteo 26 x width-1", urows, inv, valid, "sum")]
    for d in (16, 128):
        vals = torch.randn(n_slots, d, generator=g).to(dev)
        ms = torch.randint(-1, n_slots + 1, (B, 8), generator=g).to(dev)
        mv = (torch.rand(B, 8, generator=g) < 0.7).to(dev)
        mv[0] = False
        cases += [(f"multi-hot [B, 8] D={d}", vals, ms, mv, c)
                  for c in COMBINERS]
    k2_err, times = 0.0, {}
    for name, v, s, m, comb in cases:
        got2 = fused_pooled_lookup(v, s, m, comb)
        ref2 = fused_pooled_lookup_plain(v, s, m, comb)
        torch.testing.assert_close(got2, ref2, rtol=POOL_RTOL, atol=1e-6)
        err = (got2 - ref2).abs().max().item()
        k2_err = max(k2_err, err)
        kt = time_ms(lambda: fused_pooled_lookup(v, s, m, comb))
        pt = time_ms(lambda: fused_pooled_lookup_plain(v, s, m, comb))
        times[name, comb] = (kt, pt)
        log(f"K2 fused_pooled_lookup {name} {comb} "
            f"(bags {tuple(s.shape)}, D {v.shape[1]}): kernel {kt:.4f} ms, "
            f"plain {pt:.4f} ms (device); host clock per call: kernel "
            f"{wall_ms(lambda: fused_pooled_lookup(v, s, m, comb)):.4f} ms, "
            f"plain "
            f"{wall_ms(lambda: fused_pooled_lookup_plain(v, s, m, comb)):.4f}"
            f" ms; max_abs_err {err:.3g}")
    k2_ms, k2_plain = times["criteo 26 x width-1", "sum"]

    # one PyTorch call computing the same function, as the yardstick
    k1_lib = time_ms(lambda: torch.index_select(table[:, :EMB_DIM], 0, slots))
    k1_bytes = (slots.numel() * slots.element_size()
                + torch.unique(slots).numel() * EMB_DIM * 4
                + n_slots * EMB_DIM * 4)
    log_times("K1 gather_rows (serving shape)", k1_ms, k1_plain, k1_lib,
              k1_bytes, "; library: torch.index_select")
    valid_f = valid.float()
    k2_lib = time_ms(lambda: torch.nn.functional.embedding_bag(
        inv, urows, per_sample_weights=valid_f, mode="sum"))
    k2_bytes = (inv.numel() * inv.element_size() + valid.numel()
                + int(uniq.n_unique) * EMB_DIM * 4 + inv.shape[0] * EMB_DIM * 4)
    log_times("K2 fused_pooled_lookup (serving shape, [26*4096, 1] sum)",
              k2_ms, k2_plain, k2_lib, k2_bytes,
              "; library: embedding_bag(mode='sum', per_sample_weights)")
    from deeprec_tpu_torch.probes.kernel_probe import k2_forward
    k2_turns = k2_forward(probe, urows, inv, valid,
                          "(serving shape, [26*4096, 1] sum)")
    return [
        entry("gather_rows", "deeprec_tpu_torch/csrc/gather_rows.cu",
              "deeprec_tpu/ops/pallas_gather.py:78", k1_err, k1_ms,
              k1_plain, k1_lib, k1_bytes),
        entry("fused_pooled_lookup",
              "deeprec_tpu_torch/csrc/fused_pooled_lookup.cu",
              "deeprec_tpu/ops/pallas_fused_lookup.py:80", k2_err, k2_ms,
              k2_plain, k2_lib, k2_bytes, previous_ms=k2_turns["old"],
              on_path_ms=k2_turns["behind"]["new"],
              previous_on_path_ms=k2_turns["behind"]["old"],
              probe_ms={str(m): t for m, t in k2_turns.items()
                        if isinstance(m, int)}),
    ]


# -- phase 3 -----------------------------------------------------------------
def write_checkpoint(path):
    """A full save of the DLRM at full width, made without JAX."""
    from deeprec_tpu_torch.checkpoint import format as F
    from deeprec_tpu_torch.data.criteo import SyntheticCriteo
    from deeprec_tpu_torch.models.ctr import flax_leaves
    from deeprec_tpu_torch.sparse.embedding_var import init_rows

    _, coll, _ = criteo_parts()
    g = torch.Generator().manual_seed(SEED)
    model = seeded_model(g)
    keys = np.unique(np.concatenate([
        coll.pack_ids_np(b).reshape(-1)
        for b in SyntheticCriteo(batch_size=B, seed=7).take(20)]))
    keys = keys[keys != -1]
    rows = init_rows(coll.config, torch.from_numpy(keys))
    rows = rows + 0.3 * torch.randn(rows.shape, generator=g)
    values = torch.cat([rows, torch.full_like(rows, 0.1)], 1)  # fused acc
    n = keys.shape[0]
    table = {"keys": keys, "values": values.numpy(),
             "freqs": np.ones(n, np.int32),
             "versions": np.zeros(n, np.int32),
             "create_steps": np.zeros(n, np.int32)}
    F.write_save(os.path.join(path, F.step_dirname("full", 1)),
                 {"kind": "full", "step": 1, "tables": {"emb": n}},
                 flax_leaves(model) + [np.asarray(1, np.int32)],
                 {"emb": table})
    return table


def write_incremental(path, table, touched):
    """An incremental save moving the rows of ``touched`` saved keys."""
    from deeprec_tpu_torch.checkpoint import format as F
    base, _ = F.restore_plan(path)
    sel = np.nonzero(np.isin(table["keys"], touched))[0]
    incr = {k: v[sel] for k, v in table.items()}
    incr["values"] = incr["values"].copy()
    incr["values"][:, :EMB_DIM] += 0.5
    leaves = F.read_dense(base["path"])
    leaves[-1] = np.asarray(2, np.int32)
    F.write_save(os.path.join(path, F.step_dirname("incr", 2)),
                 {"kind": "incr", "step": 2, "since": 1,
                  "tables": {"emb": int(sel.shape[0])}}, leaves,
                 {"emb": incr})
    return int(sel.shape[0])


def predictor(path, device):
    from deeprec_tpu_torch.serving import Predictor
    numeric, coll, model = criteo_parts()
    return Predictor(model, numeric, {"emb": coll}, path, device=device)


# -- phase 5 -----------------------------------------------------------------
def _post(url, obj):
    req = urllib.request.Request(url, json.dumps(obj).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=120) as r:
        return json.loads(r.read())


def _cols(batch, lo, hi):
    return {k: np.asarray(v)[lo:hi].tolist() for k, v in batch.items()
            if k != "label"}


def check_http(path, gpu, cpu, table, batch):
    from deeprec_tpu_torch.serving.server import make_server
    srv = make_server(gpu, host="127.0.0.1", port=0, dynamic_batch_ms=50.0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        expect = gpu.predict(batch)
        h = _get(base + "/healthz")
        if h["status"] != "ok" or h["tables"]["emb"] != table["keys"].shape[0]:
            fail(f"/healthz answered {h}")
        got = np.asarray(_post(base + "/v1/predict",
                               {"inputs": _cols(batch, 0, 64)})["predictions"])
        np.testing.assert_allclose(got, expect[:64], rtol=0, atol=1e-6)
        res = {}

        def hit(lo, hi):
            res[lo] = _post(base + "/v1/predict",
                            {"inputs": _cols(batch, lo, hi)})
        pair = [threading.Thread(target=hit, args=a)
                for a in ((0, 40), (40, 100))]
        [t.start() for t in pair]
        [t.join(timeout=120) for t in pair]
        if any(t.is_alive() for t in pair) or len(res) != 2:
            fail("dynamically batched pair did not both answer")
        np.testing.assert_allclose(res[0]["predictions"], expect[:40],
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(res[40]["predictions"], expect[40:100],
                                   rtol=0, atol=1e-6)
        batches = srv.service.batcher.batches
        log(f"HTTP: /healthz {h['tables']}, predict round-trip ok, "
            f"dynamic pair ok ({batches} predict calls for 3 requests)")

        # live refresh of an incremental save touching the request's keys
        coll = gpu.collections["emb"]
        touched = np.unique(coll.pack_ids_np(
            {k: v[:100] for k, v in batch.items()}))[:3000]
        n = write_incremental(path, table, touched)
        r = _post(base + "/refresh", {})
        if r != {"changed": True, "step": 2}:
            fail(f"/refresh answered {r}")
        after = np.asarray(_post(base + "/v1/predict",
                                 {"inputs": _cols(batch, 0, 100)}
                                 )["predictions"])
        if np.allclose(after, expect[:100], rtol=0, atol=1e-6):
            fail("predictions did not move after the refresh")
        if not cpu.refresh():
            fail("CPU predictor saw no new save")
        ref = cpu.predict({k: v[:100] for k, v in batch.items()})
        err = float(np.abs(after - ref).max())
        if not err <= PROB_ATOL:
            fail(f"refreshed card vs CPU probabilities differ by {err}")
        moved = float(np.abs(after - expect[:100]).max())
        log(f"HTTP refresh: {n} rows moved, predictions moved by up to "
            f"{moved:.4f}, card vs CPU after refresh max |dp| {err:.3g}")
    finally:
        srv.shutdown()
        srv.server_close()
        srv.service.batcher.stop()
        thread.join(timeout=30)


# -- phases 2 and 6: the training path ----------------------------------------
def host_collection(metadata):
    """bench.py's table: host index over 2^21 rows. ``use_native=True``
    raises when the C++ resolver cannot be built: no Python fallback."""
    from deeprec_tpu_torch import config as cfg
    from deeprec_tpu_torch import feature_column as fc
    from deeprec_tpu_torch.data.criteo import CAT_NAMES
    from deeprec_tpu_torch.host_index import HostIndexEmbeddingCollection
    meta = {}
    if metadata:  # bench.py --metadata
        meta = dict(counter_filter=cfg.CounterFilter(filter_freq=1),
                    evict=cfg.GlobalStepEvict(steps_to_live=1 << 30))
    return HostIndexEmbeddingCollection(
        [fc.EmbeddingColumn(fc.CategoricalColumn(n), EMB_DIM)
         for n in CAT_NAMES],
        name="emb", capacity=CAPACITY,
        initializer=cfg.Initializer("normal", scale=0.05),
        max_unique=MAX_UNIQUE, fused_slot_columns=EMB_DIM,
        fused_slot_init=0.1, use_native=True, **meta)


def check_training_kernels(dev, probe):
    """K2 (both directions), K1's optimizer read and K3a at the training
    shape of one resolved B=4096 batch; scatter_set and K3b at the JAX
    benchmark's shape. Returns the kernels' JSON entries."""
    from deeprec_tpu_torch.data.criteo import SyntheticCriteo
    from deeprec_tpu_torch.ops.fused_lookup import (
        fused_pooled_lookup, fused_pooled_lookup_backward,
        fused_pooled_lookup_backward_plain, fused_pooled_lookup_plain)
    from deeprec_tpu_torch.ops.gather import gather_rows, gather_rows_plain
    from deeprec_tpu_torch.ops.meta_scatter import (
        blocked_rmw_set, blocked_rmw_set_plain, lookup_meta,
        lookup_meta_plain, meta_scatter, meta_scatter_plain, scatter_set)
    from deeprec_tpu_torch.probes.kernel_probe import (behind_ms, k2_forward,
                                                       window_groups)

    g = torch.Generator().manual_seed(SEED + 1)
    coll = host_collection(metadata=True)
    r = coll.pack_ids(next(SyntheticCriteo(batch_size=B, seed=7)),
                      dev).decode()
    u = r.uslots.shape[0]
    n_real = int(r.n_unique)
    log(f"training shape: {r.inverse.shape[0]} ids, {n_real} unique keys in "
        f"{u} lanes")

    # K2 backward: [26*4096, 1] bags (one id each) into the U unique lanes
    slots = r.inverse.view(-1, 1)
    valid = (r.uslots != CAPACITY)[r.inverse].view(-1, 1)
    d_pooled = torch.randn(slots.shape[0], EMB_DIM, generator=g).to(dev)
    got = fused_pooled_lookup_backward(d_pooled, slots, valid, "sum", u)
    ref = fused_pooled_lookup_backward_plain(d_pooled, slots, valid, "sum",
                                             u)
    mag = fused_pooled_lookup_backward_plain(d_pooled.abs(), slots, valid,
                                             "sum", u)
    bwd_err = (got - ref).abs().max().item()
    if not bool(((got - ref).abs() <= BWD_TOL * mag + 1e-7).all()):
        fail(f"K2 backward differs from its plain version by {bwd_err}")
    # one add per (32-id window, row) once a warp groups its ids
    adds, hot, windows = window_groups(r.inverse, valid.view(-1))
    bwd_ms = time_ms(lambda: fused_pooled_lookup_backward(
        d_pooled, slots, valid, "sum", u))
    bwd_plain = time_ms(lambda: fused_pooled_lookup_backward_plain(
        d_pooled, slots, valid, "sum", u))
    idx, src = r.inverse.long(), torch.where(valid, d_pooled, 0.0)
    bwd_lib = time_ms(lambda: torch.zeros(u, EMB_DIM, device=dev).index_add_(
        0, idx, src))
    bwd_bytes = (d_pooled.numel() * 4 + slots.numel() * 4 + valid.numel()
                 + u * EMB_DIM * 4)
    log_times("K2 fused_pooled_lookup_backward ([26*4096, 1] sum, D 16)",
              bwd_ms, bwd_plain, bwd_lib, bwd_bytes,
              f"; library: zeros + index_add_; max_abs_err {bwd_err:.3g}; "
              f"hottest lane takes {hot} ids from {windows} 32-id windows; "
              f"{adds} row adds after warp grouping")

    # K2's forward at the same training shape
    urows = torch.randn(u, EMB_DIM, generator=g).to(dev)
    fwd = fused_pooled_lookup(urows, slots, valid, "sum")
    torch.testing.assert_close(
        fwd, fused_pooled_lookup_plain(urows, slots, valid, "sum"),
        rtol=POOL_RTOL, atol=1e-6)
    fwd_ms = time_ms(lambda: fused_pooled_lookup(urows, slots, valid, "sum"))
    fwd_plain = time_ms(lambda: fused_pooled_lookup_plain(urows, slots, valid,
                                                          "sum"))
    fwd_lib = time_ms(lambda: torch.nn.functional.embedding_bag(
        slots, urows, per_sample_weights=valid.float(), mode="sum"))
    log_times("K2 fused_pooled_lookup (training shape, [26*4096, 1] sum)",
              fwd_ms, fwd_plain, fwd_lib,
              slots.numel() * 4 + valid.numel() + n_real * EMB_DIM * 4
              + slots.shape[0] * EMB_DIM * 4,
              "; library: embedding_bag(mode='sum', per_sample_weights)")
    k2_forward(probe, urows, slots, valid, "(training shape, [26*4096, 1] "
               "sum)")

    # K1 at the training shape: the unique-row fetch and the optimizer's
    # read of whole fused rows (value + accumulator)
    table = torch.randn(CAPACITY + 1, 2 * EMB_DIM, generator=g).to(dev)
    for what, d in (("unique-row fetch", EMB_DIM),
                    ("optimizer row read", 2 * EMB_DIM)):
        if not torch.equal(gather_rows(table, r.uslots, d),
                           gather_rows_plain(table, r.uslots, d)):
            fail(f"K1 ({what}) differs from its plain version")
        kt = time_ms(lambda: gather_rows(table, r.uslots, d))
        pt = time_ms(lambda: gather_rows_plain(table, r.uslots, d))
        lt = time_ms(lambda: torch.index_select(table[:, :d], 0, r.uslots))
        log_times(f"K1 gather_rows, training {what} ([{u}] x {d})", kt, pt,
                  lt, u * 4 + 2 * (n_real + 1) * d * 4)

    # K3a on the path: lookup_or_create's metadata step (--metadata:
    # create steps, versions, freqs, CounterFilter(1)) in one launch
    cap, ff = CAPACITY, 1
    dest = torch.where(r.created & ~r.readonly, r.uslots, cap + 1)

    def planes():
        return [torch.full((cap + 1,), -1, dtype=torch.int32, device=dev),
                torch.full((cap + 1,), -1, dtype=torch.int32, device=dev),
                torch.zeros((cap + 1,), dtype=torch.int32, device=dev)]

    def fused(p, fn=lookup_meta):
        return fn(r.uslots, r.counts, r.readonly, dest, 3, cap, p[0], p[1],
                  p[2], True, ff)
    kp, pp, lp = planes(), planes(), planes()
    adm = fused(kp)
    adm_ref = fused(pp, lookup_meta_plain)
    if not (all(torch.equal(a, b) for a, b in zip(kp, pp))
            and torch.equal(adm, adm_ref)):
        fail("K3a lookup_meta differs from its plain version")
    gs = torch.tensor(3, dtype=torch.int32, device=dev)

    def torch_chain():
        """The same function in PyTorch calls, none of which syncs: lanes
        that do not write go to the null row, which is then reset."""
        live = (r.counts > 0) & (r.uslots != cap) & ~r.readonly
        m = torch.where(live, r.uslots, cap).long()
        lp[0].index_put_((torch.where(dest < cap, dest, cap).long(),), gs)
        lp[1].index_put_((m,), gs)
        lp[2].index_add_(0, m, torch.where(live, r.counts, 0))
        for plane, fill in zip(lp, (-1, -1, 0)):  # fill_: no host copy
            plane.narrow(0, cap, 1).fill_(fill)
        return (r.uslots != cap) & (lp[2][r.uslots] >= ff)
    if not (torch.equal(torch_chain(), adm_ref)
            and all(torch.equal(a, b) for a, b in zip(lp, pp))):
        fail("K3a's library yardstick computes another function")

    # what the path ran before the fused kernel: live/mdest, the
    # three-plane kernel, the admission test
    live = (r.counts > 0) & (r.uslots != cap) & ~r.readonly
    mdest = torch.where(live, r.uslots, cap + 1)
    op = planes()

    def old_kernel():
        meta_scatter(op[0], dest, op[1], op[2], mdest, r.counts, 3)

    def old_path():
        lv = (r.counts > 0) & (r.uslots != cap) & ~r.readonly
        meta_scatter(op[0], dest, op[1], op[2],
                     torch.where(lv, r.uslots, cap + 1), r.counts, 3)
        return (r.uslots != cap) & (op[2][r.uslots] >= ff)
    old_kernel()
    if not all(torch.equal(a, b) for a, b in zip(op, pp)):
        fail("K3a meta_scatter differs from the fused kernel's planes")
    turns = [time_ms(old_kernel), time_ms(lambda: fused(kp)),
             time_ms(lambda: fused(kp)), time_ms(old_kernel)]
    k3a_ms = (turns[1] + turns[2]) / 2
    old_ms = (turns[0] + turns[3]) / 2
    # each behind a PyTorch kernel, as on the path
    on_path = [behind_ms(old_kernel), behind_ms(lambda: fused(kp)),
               behind_ms(lambda: fused(kp)), behind_ms(old_kernel)]
    old_path_ms = time_ms(old_path)
    k3a_plain = time_ms(lambda: fused(pp, lookup_meta_plain))
    k3a_lib = time_ms(torch_chain)
    m_in = mdest < cap
    n_d, n_m = int((dest < cap).sum()), int(m_in.sum())
    n_read = int(((r.uslots < cap) & ~m_in).sum())  # the filter's own reads
    # lanes read (uslots, counts, dest: 4 bytes; admitted written: 1),
    # the flag, a create step per created row, a version and a freq
    # read-modify-write per live row, a freq read per other real row
    k3a_bytes = 13 * u + 1 + 4 * n_d + 12 * n_m + 4 * n_read
    log(f"K3a turns (old three-plane kernel, fused, fused, old): "
        f"{turns[0]:.4f}, {turns[1]:.4f}, {turns[2]:.4f}, {turns[3]:.4f} ms "
        f"back to back; behind a one-element add: "
        + ", ".join(f"{t:.4f}" for t in on_path)
        + f" ms; the old path (live/mdest + three-plane kernel + admission "
        f"test) {old_path_ms:.4f} ms")
    log_times(f"K3a lookup_meta (3 planes of {cap + 1} + filter, {u} lanes: "
              f"{n_d} created, {n_m} live)", k3a_ms, k3a_plain, k3a_lib,
              k3a_bytes, "; library: the same function in torch calls "
              "(live, masked indices, index_put_ x2, index_add_, null-row "
              "resets, the admission test)")
    # the three-plane kernel alone, with its own yardstick (pre-filtered
    # lanes) and bytes
    d_keep, m_keep = dest[dest < cap].long(), mdest[m_in].long()
    c_keep = r.counts[m_in]

    def three_calls():
        pp[0].index_put_((d_keep,), gs)
        pp[1].index_put_((m_keep,), gs)
        pp[2].index_add_(0, m_keep, c_keep)
    ms_lib = time_ms(three_calls)
    ms_plain = time_ms(lambda: meta_scatter_plain(
        pp[0], dest, pp[1], pp[2], mdest, r.counts, 3, cap))
    ms_bytes = 3 * u * 4 + (n_d + 3 * n_m) * 4
    log_times("K3a meta_scatter, the three-plane kernel (off the path now)",
              old_ms, ms_plain, ms_lib, ms_bytes,
              "; library: index_put_ x2 + index_add_ on pre-filtered lanes")

    # the JAX benchmark's question, on this card: CAP 2^21, U 17,664
    bslots = torch.randperm(cap, generator=g)[:K3B_U].to(torch.int32).to(dev)
    bvals = torch.randint(-9, 9, (K3B_U,), generator=g,
                          dtype=torch.int32).to(dev)
    plane = torch.randint(-1, 9, (cap + 1,), generator=g,
                          dtype=torch.int32).to(dev)
    one, ref1 = plane.clone(), plane.clone()
    scatter_set(one, bslots, 7)
    ref1[bslots.long()] = 7
    if not torch.equal(one, ref1):
        fail("K3a scatter_set differs from index_put_")
    b64 = bslots.long()
    seven = torch.tensor(7, dtype=torch.int32, device=dev)
    ss_ms = time_ms(lambda: scatter_set(one, bslots, 7))
    ss_plain = time_ms(lambda: meta_scatter_plain(None, bslots, one, None,
                                                  bslots, None, 7, cap))
    ss_lib = time_ms(lambda: one.index_put_((b64,), seven))
    log_times(f"K3a scatter_set (benchmark shape: plane {cap + 1}, U "
              f"{K3B_U})", ss_ms, ss_plain, ss_lib, K3B_U * 8,
              "; library: index_put_")
    got = blocked_rmw_set(plane, bslots, bvals, cap)
    if not torch.equal(got, blocked_rmw_set_plain(plane, bslots, bvals, cap)):
        fail("K3b blocked_rmw_set differs from its plain version")
    k3b_ms = time_ms(lambda: blocked_rmw_set(plane, bslots, bvals, cap))
    k3b_plain = time_ms(lambda: blocked_rmw_set_plain(plane, bslots, bvals,
                                                      cap))
    # the library call computing K3b's own function, out of place: it
    # copies plane[:cap] and scatters into the copy
    k3b_lib = time_ms(lambda: torch.index_put(plane[:cap], (b64,), bvals))
    inplace = plane.clone()
    k3b_inplace = time_ms(lambda: inplace.index_put_((b64,), bvals))
    k3b_bytes = 2 * cap * 4 + 2 * K3B_U * 4
    log_times(f"K3b blocked_rmw_set (benchmark shape: CAP {cap}, U {K3B_U})",
              k3b_ms, k3b_plain, k3b_lib, k3b_bytes,
              f"; library: torch.index_put out of place; the in-place "
              f"index_put_ (no copy of the plane, another function) "
              f"{k3b_inplace:.4f} ms")
    return [
        entry("fused_pooled_lookup_backward",
              "deeprec_tpu_torch/csrc/fused_pooled_lookup.cu",
              "deeprec_tpu/ops/pallas_fused_lookup.py:80", bwd_err, bwd_ms,
              bwd_plain, bwd_lib, bwd_bytes),
        entry("lookup_meta", "deeprec_tpu_torch/csrc/meta_scatter.cu",
              "benchmarks/pallas_meta_bench.py:108", 0.0, k3a_ms, k3a_plain,
              k3a_lib, k3a_bytes, previous_ms=old_ms,
              previous_path_ms=old_path_ms,
              on_path_ms=(on_path[1] + on_path[2]) / 2,
              previous_on_path_ms=(on_path[0] + on_path[3]) / 2),
        entry("meta_scatter", "deeprec_tpu_torch/csrc/meta_scatter.cu",
              "benchmarks/pallas_meta_bench.py:108", 0.0, old_ms, ms_plain,
              ms_lib, ms_bytes),
        entry("blocked_rmw_set", "deeprec_tpu_torch/csrc/meta_scatter.cu",
              "benchmarks/pallas_meta_bench.py:151", 0.0, k3b_ms, k3b_plain,
              k3b_lib, k3b_bytes),
    ]


def seeded_model(g):
    """bench.py's DLRM with He-scaled random weights drawn from ``g``."""
    _, _, model = criteo_parts()
    with torch.no_grad():  # He-scaled weights keep the logits spread out
        for p in model.parameters():
            std = (2.0 / p.shape[1]) ** 0.5 if p.dim() == 2 else 0.01
            p.copy_(torch.randn(p.shape, generator=g) * std)
    return model


def trainer(dev, metadata):
    from deeprec_tpu_torch.optim.dense import Adagrad
    from deeprec_tpu_torch.optim.sparse import sparse_adagrad_fused
    from deeprec_tpu_torch.train.trainer import Trainer
    numeric, _, _ = criteo_parts()
    model = seeded_model(torch.Generator().manual_seed(SEED))
    return Trainer(model, numeric,
                   {"emb": host_collection(metadata)},
                   {"emb": sparse_adagrad_fused(0.05)}, Adagrad(0.05),
                   device=dev)


def lockstep(tg, tc, batches, what):
    """Train the card and CPU trainers on ``batches``; hold the wires (so
    slots, keys and inverse) bit-equal and the losses within LOSS_ATOL.
    Returns both states."""
    sg, sc = tg.init(batches[0]), tc.init(batches[0])
    worst = 0.0
    for i, b in enumerate(batches):
        dg, cg, lg = tg.prepare_batch(b)
        dc, cc, lc = tc.prepare_batch(b)
        if not torch.equal(cg["emb"].buf.cpu(), cc["emb"].buf):
            fail(f"{what}: card and CPU resolves differ at step {i}")
        g0, c0 = sg.metrics.loss_sum.item(), sc.metrics.loss_sum.item()
        sg = tg._train_step(sg, dg, cg, lg)
        sc = tc._train_step(sc, dc, cc, lc)
        lg_, lc_ = ((sg.metrics.loss_sum.item() - g0) / B,
                    (sc.metrics.loss_sum.item() - c0) / B)
        if not (np.isfinite(lg_) and abs(lg_ - lc_) <= LOSS_ATOL):
            fail(f"{what}: step {i} loss {lg_} on the card vs {lc_} on CPU")
        worst = max(worst, abs(lg_ - lc_))
    eg, ec = sg.tables["emb"].ev, sc.tables["emb"].ev
    for f in ("freqs", "versions", "create_steps"):
        if not torch.equal(getattr(eg, f).cpu(), getattr(ec, f)):
            fail(f"{what}: {f} planes differ between card and CPU")
    rows = (eg.values.cpu() - ec.values).abs().max().item()
    if not rows <= ROW_ATOL:
        fail(f"{what}: table rows differ by {rows} between card and CPU")
    log(f"{what}: {len(batches)} steps in lockstep with a CPU trainer: wires "
        f"and metadata planes bit-equal, max |dloss| {worst:.3g} (limit "
        f"{LOSS_ATOL}), max |drow| {rows:.3g} (limit {ROW_ATOL}); "
        f"{int((ec.freqs > 0).sum())} rows with freq > 0")
    return sg, worst, rows


def timed_runs(tg, state, batches, runs=3, steps=10, inline=False):
    """examples/s of ``runs`` runs of ``steps`` steps (host clock around
    work ending in a synchronize). Staged: every batch's host half
    (packing, the resolve in step order, the copies) is done before the
    clock starts, as bench.py's default does; inline: train_step does it
    inside the clock."""
    rates = []
    for k in range(runs):
        chunk = batches[k * steps:(k + 1) * steps]
        items = chunk if inline else [tg.prepare_batch(b) for b in chunk]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for it in items:
            state = (tg.train_step(state, it) if inline
                     else tg._train_step(state, *it))
        torch.cuda.synchronize()
        rates.append(steps * B / (time.perf_counter() - t0))
    return state, rates


def profile_steps(tg, state, batches, step_ms):
    """Device time by kernel over len(batches) staged steps
    (torch.profiler; only the device-side kernel and copy events are
    summed, so nothing is counted twice)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    items = [tg.prepare_batch(b) for b in batches]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for it in items:
            state = tg._train_step(state, *it)
        torch.cuda.synchronize()
    n = len(items)

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    ka = sorted((e for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA),
                key=dev_us, reverse=True)
    total_ms = sum(dev_us(e) for e in ka) / 1e3 / n
    launches = sum(e.count for e in ka) / n
    log(f"profile of {n} staged metadata steps: {launches:.0f} device "
        f"kernels and copies per step, busy {total_ms:.3f} ms per step = "
        f"{100 * total_ms / step_ms:.1f} % of the unprofiled median step "
        f"({step_ms:.3f} ms); idle {100 - 100 * total_ms / step_ms:.1f} %")
    for e in ka[:20]:
        log(f"  {dev_us(e) / 1e3 / n:8.4f} ms/step {e.count / n:6.1f} "
            f"calls/step  {e.key[:100]}")
    return state, total_ms


def check_training(dev, smi):
    """Phases 6 and 7. Returns (launches by path, training summary)."""
    from deeprec_tpu_torch.data.criteo import SyntheticCriteo
    from deeprec_tpu_torch.ops.fused_lookup import (
        fused_pooled_lookup, fused_pooled_lookup_backward)
    from deeprec_tpu_torch.ops.gather import gather_rows
    from deeprec_tpu_torch.ops.meta_scatter import lookup_meta
    from deeprec_tpu_torch.train import metrics
    counters = {"gather_rows": gather_rows,
                "fused_pooled_lookup": fused_pooled_lookup,
                "fused_pooled_lookup_backward": fused_pooled_lookup_backward,
                "lookup_meta": lookup_meta}
    batches = list(SyntheticCriteo(batch_size=B, seed=7).take(68))
    out = {}

    # --metadata: the slice's main path
    t0 = time.perf_counter()
    tg, tc = trainer(dev, True), trainer("cpu", True)
    log(f"metadata trainers built in {time.perf_counter() - t0:.1f} s")
    for fn in counters.values():
        fn.launches = 0
    sg, dloss, drow = lockstep(tg, tc, batches[:5], "metadata layout")
    del tc
    sg, staged = timed_runs(tg, sg, batches[5:35])
    sg, inline = timed_runs(tg, sg, batches[35:65], inline=True)
    launches = {k: fn.launches for k, fn in counters.items()}
    log(f"training main path (metadata layout, {sg.step} steps) launches: "
        f"{launches}")
    for k, v in launches.items():
        if v <= 0:
            fail(f"{k} was not launched on the training path")
    med = statistics.median(staged)
    sg, dev_ms = profile_steps(tg, sg, batches[65:68], B / med * 1e3)
    summ = metrics.summarize(sg.metrics)
    if not (summ["examples"] == sg.step * B and np.isfinite(summ["loss"])
            and 0.0 <= summ["auc"] <= 1.0):
        fail(f"metadata metrics are off: {summ}")
    for name, rates in (("staged", staged), ("inline", inline)):
        log(f"metadata layout examples/s at B={B}, {name} host half: median "
            f"{statistics.median(rates):.1f}, min {min(rates):.1f}, max "
            f"{max(rates):.1f} over 3 runs of 10 steps, on {smi}")
    log(f"metadata layout after {sg.step} steps: {summ}")
    out["metadata"] = {"staged_eps": staged, "inline_eps": inline,
                       "device_ms_per_step": dev_ms, "max_dloss": dloss,
                       "max_drow": drow, "summary": summ}
    del tg, sg

    # the light layout: bench.py's default, lazy init, no metadata writes
    tg, tc = trainer(dev, False), trainer("cpu", False)
    for fn in counters.values():
        fn.launches = 0
    sg, dloss, drow = lockstep(tg, tc, batches[:3], "light layout")
    del tc
    sg, staged = timed_runs(tg, sg, batches[3:33])
    light = {k: fn.launches for k, fn in counters.items()}
    log(f"light layout ({sg.step} steps) launches: {light}")
    for k in ("gather_rows", "fused_pooled_lookup",
              "fused_pooled_lookup_backward"):
        if light[k] <= 0:
            fail(f"{k} was not launched on the light training path")
    if light["lookup_meta"]:
        fail("the light layout wrote metadata")
    log(f"light layout examples/s at B={B}, staged host half: median "
        f"{statistics.median(staged):.1f}, min {min(staged):.1f}, max "
        f"{max(staged):.1f} over 3 runs of 10 steps, on {smi}")
    out["light"] = {"staged_eps": staged, "max_dloss": dloss,
                    "max_drow": drow,
                    "summary": metrics.summarize(sg.metrics)}
    return {"train_metadata": launches, "train_light": light}, out


def run(dev, smi, probe):
    """Phases 2-7 on ``dev`` (``probe``: the built design probes); returns
    the kernels' JSON entries and the training numbers."""
    from deeprec_tpu_torch.data.criteo import SyntheticCriteo
    from deeprec_tpu_torch.ops.fused_lookup import fused_pooled_lookup
    from deeprec_tpu_torch.ops.gather import gather_rows
    from deeprec_tpu_torch.ops import _build

    kernels = check_kernels(dev, probe) + check_training_kernels(dev, probe)

    _build.BUILD.mkdir(parents=True, exist_ok=True)  # git-ignored
    with tempfile.TemporaryDirectory(dir=str(_build.BUILD)) as path:
        t0 = time.perf_counter()
        table = write_checkpoint(path)
        log(f"checkpoint: {table['keys'].shape[0]} keys x "
            f"{table['values'].shape[1]} f32 in a {CAPACITY}-slot table, "
            f"written in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        gpu = predictor(path, dev)
        log(f"{dev} predictor restored in {time.perf_counter() - t0:.1f} s")
        cpu = predictor(path, "cpu")

        held = list(SyntheticCriteo(batch_size=B, seed=11).take(5))
        gather_rows.launches = 0
        fused_pooled_lookup.launches = 0
        probs = [gpu.predict(b) for b in held]
        launches = {"gather_rows": gather_rows.launches,
                    "fused_pooled_lookup": fused_pooled_lookup.launches}
        log(f"serving path (5 predicts at B={B}) launches: {launches}")
        for k, v in launches.items():
            if v <= 0:
                fail(f"{k} was not launched on the serving path")
        coll = gpu.collections["emb"]
        aux, _ = coll.readonly_rows(gpu.tables["emb"],
                                    coll.pack_ids(held[0], dev))
        real = aux.ev_aux.uniq.ukeys != -1
        unseen = int((real & ~aux.ev_aux.admitted).sum())
        log(f"batch 0: {int(real.sum())} unique keys, {unseen} not in the "
            f"table (served their default rows)")
        if unseen == 0:
            fail("no unseen keys: the default-row path did not run")
        worst = 0.0
        for b, p in zip(held, probs):
            if p.shape != (B,) or not np.isfinite(p).all() or \
                    not ((p > 0) & (p < 1)).all():
                fail("card probabilities are not finite values in (0, 1)")
            worst = max(worst, float(np.abs(p - cpu.predict(b)).max()))
        if not worst <= PROB_ATOL:
            fail(f"card vs CPU probabilities differ by {worst}")
        log(f"card vs CPU predictor over 5 batches: max |dp| {worst:.3g} "
            f"(limit {PROB_ATOL}), p spread {float(np.std(probs)):.4f}")

        lat = []
        for _ in range(25):
            t0 = time.perf_counter()
            gpu.predict(held[0])  # ends in the D2H copy of the result
            lat.append((time.perf_counter() - t0) * 1e3)
        p50 = statistics.median(lat[5:])
        log(f"predict latency at B={B}: p50 {p50:.3f} ms (20 calls after 5 "
            f"warm-up, host clock) on {smi}")

        check_http(path, gpu, cpu, table, held[1])
        del gpu, cpu

    paths, training = check_training(dev, smi)
    paths["serving"] = launches
    for k in kernels:  # launches on the slice's main path: --metadata
        k["launches"] = paths["train_metadata"].get(k["name"], 0)
        k["launches_by_path"] = {p: c.get(k["name"], 0)
                                 for p, c in paths.items()}
    return kernels, training


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this smoke runs on "
                         "the card only")
    sys.path.insert(0, REPO)
    from deeprec_tpu_torch.ops import _build
    from deeprec_tpu_torch.probes import kernel_probe

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}")
    # full f32 products on both sides of every comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        probe = pool.submit(kernel_probe.build)  # its own nvcc, alongside
        _build.library()
        log(f"kernels built (nvcc sm_90a) and loaded in "
            f"{time.perf_counter() - t0:.2f} s")
        probe = probe.result()
    log(f"design probes built in {time.perf_counter() - t0:.2f} s")

    kernels, training = run(torch.device("cuda"), smi, probe)
    log(json.dumps({"training": training, "card": smi}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
