"""Design probes for K2's backward and K3b on a CUDA card.

Times the variants of ``kernel_probe.cu`` (each keeps or drops one part
of the kernel's work; the source lists them) beside the port's own
kernels and a PyTorch call computing the same function, at the training
shape of one resolved B=4096 Criteo batch (106,496 ids into ~17,750
lanes, D 16) and at K3b's benchmark shape (CAP 2^21, U 17,664). Run from
the root of a checkout on a machine with one card:

    python -m deeprec_tpu_torch.probes.kernel_probe

It builds ``kernel_probe.cu`` with nvcc into the git-ignored build
directory, prints one line per variant (device ms per call: the median
of 21 CUDA-event samples of 20 back-to-back calls behind a sleep kernel,
L2 warm) and the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import hashlib
import statistics
import subprocess
from pathlib import Path

import torch

from ..ops import _build

SOURCE = Path(__file__).with_name("kernel_probe.cu")
B, CAPACITY, EMB_DIM = 4096, 1 << 21, 16
K3B_U = 17664
K2_VARIANTS = {
    0: "empty kernel, same grid (launch floor)",
    1: "loads only",
    2: "loads + warp grouping, no writes",
    3: "grouped, each leader adds its 4 pieces (RED.128)",
    4: "grouped, each leader stores its 4 pieces",
    5: "grouped, 4 lanes a leader, RED.128 (the port's writes)",
    6: "grouped, 4 lanes a leader, plain stores",
    7: "not grouped, every id adds its 4 pieces",
    8: "zero-fill + variant 5, ordinary launches",
    9: "zero-fill + variant 5 as its dependent (the port's design)",
    10: "zero-fill + block-sorted tiles of 1024 ids, dependent",
}
K3B_VARIANTS = {
    0: "copy on one-pass blocks (128) + dependent scatter (the port's design)",
    1: "copy + scatter, ordinary launches",
    2: "copy on one block per SM, striding + dependent scatter",
    3: "one cooperative launch: copy, grid barrier, scatter",
    4: "the copy alone",
}


def time_ms(fn, samples=21, per_sample=20, warmup=5):
    """Device ms per call, as chip_smoke.py times the kernels."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        a.record()
        for _ in range(per_sample):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per_sample)
    return statistics.median(times)


def build() -> ctypes.CDLL:
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src).hexdigest()[:16]
    path = _build.BUILD / f"kernel_probe_{digest}.so"
    if not path.exists():
        _build.BUILD.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(path),
                        str(SOURCE)], check=True)
    lib = ctypes.CDLL(str(path))
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.probe_k2.argtypes = [i, p, p, p, i64, p, i64, p]
    lib.probe_k3b.argtypes = [i, p, p, p, i64, i64, p, p]
    return lib


def training_batch(dev):
    """(inverse int32 [26*B], valid [26*B], U) of one resolved batch, as
    chip_smoke.py's K2 backward check makes it."""
    from .. import config as cfg
    from .. import feature_column as fc
    from ..data.criteo import CAT_NAMES, SyntheticCriteo
    from ..host_index import HostIndexEmbeddingCollection
    coll = HostIndexEmbeddingCollection(
        [fc.EmbeddingColumn(fc.CategoricalColumn(n), EMB_DIM)
         for n in CAT_NAMES],
        name="emb", capacity=CAPACITY,
        initializer=cfg.Initializer("normal", scale=0.05),
        max_unique=26 * B // 6, fused_slot_columns=EMB_DIM,
        fused_slot_init=0.1, use_native=True,
        counter_filter=cfg.CounterFilter(filter_freq=1),
        evict=cfg.GlobalStepEvict(steps_to_live=1 << 30))
    r = coll.pack_ids(next(SyntheticCriteo(batch_size=B, seed=7)),
                      dev).decode()
    valid = (r.uslots != CAPACITY)[r.inverse]
    return r.inverse.to(torch.int32).contiguous(), valid.contiguous(), \
        r.uslots.shape[0]


def window_groups(inverse, valid, width=32):
    """(row adds, hottest row's ids, its windows): one add per (window,
    row) pair once a warp groups its ids."""
    inv = inverse.long().cpu()
    ok = valid.cpu()
    pos = torch.arange(inv.numel())[ok]
    rows = inv[ok]
    groups = torch.unique((pos // width) * (int(rows.max()) + 1) + rows)
    counts = torch.bincount(rows)
    hot = int(counts.argmax())
    return groups.numel(), int(counts[hot]), \
        int(torch.unique(pos[rows == hot] // width).numel())


def timed(port, variants, run, what):
    """Prints the port's kernel and each variant, the port timed before
    and after the variants (clocks and neighbours drift within a run)."""
    first = time_ms(port)
    for mode, label in variants.items():
        print(f"  {what} variant {mode:2d} {label}: "
              f"{time_ms(lambda: run(mode)):.4f} ms", flush=True)
    print(f"  {what} port kernel: {first:.4f} ms before the variants, "
          f"{time_ms(port):.4f} ms after", flush=True)


def main():
    from ..ops.fused_lookup import (fused_pooled_lookup_backward,
                                    fused_pooled_lookup_backward_plain)
    from ..ops.meta_scatter import blocked_rmw_set, blocked_rmw_set_plain
    if not torch.cuda.is_available():
        raise SystemExit("kernel_probe: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    lib = build()
    stream = torch.cuda.current_stream().cuda_stream

    inv, valid, u = training_batch(dev)
    n = inv.shape[0]
    g = torch.Generator().manual_seed(1)
    dp = torch.randn(n, EMB_DIM, generator=g).to(dev)
    out = torch.empty(u, EMB_DIM, device=dev)
    slots2, valid2 = inv.view(-1, 1), valid.view(-1, 1)
    ref = fused_pooled_lookup_backward_plain(dp, slots2, valid2, "sum", u)
    mag = fused_pooled_lookup_backward_plain(dp.abs(), slots2, valid2, "sum",
                                             u)
    adds, hot, hot_windows = window_groups(inv, valid)
    print(f"K2 backward: {n} ids ({int(valid.sum())} valid) into {u} lanes, "
          f"D {EMB_DIM}; {adds} row adds after warp grouping "
          f"({4 * adds} 16-byte pieces); hottest row {hot} ids in "
          f"{hot_windows} 32-id windows", flush=True)

    def k2(mode):
        err = lib.probe_k2(mode, dp.data_ptr(), inv.data_ptr(),
                           valid.data_ptr(), n, out.data_ptr(), u, stream)
        if err:
            raise RuntimeError(f"probe_k2 mode {mode}: CUDA error {err}")
    for mode in (9, 10):  # the complete variants give the function
        k2(mode)
        torch.cuda.synchronize()
        if not bool(((out - ref).abs() <= 1e-4 * mag + 1e-7).all()):
            raise SystemExit(f"kernel_probe: K2 variant {mode} is wrong")

    def port():
        return fused_pooled_lookup_backward(dp, slots2, valid2, "sum", u)
    idx, src = inv.long(), torch.where(valid2, dp, 0.0)
    library = time_ms(lambda: torch.zeros(u, EMB_DIM, device=dev).index_add_(
        0, idx, src))
    print(f"  library zeros + index_add_: {library:.4f} ms", flush=True)
    timed(port, K2_VARIANTS, k2, "K2")

    cap = CAPACITY
    plane = torch.randint(-1, 9, (cap + 1,), generator=g,
                          dtype=torch.int32).to(dev)
    bslots = torch.randperm(cap, generator=g)[:K3B_U].to(torch.int32).to(dev)
    bvals = torch.randint(-9, 9, (K3B_U,), generator=g,
                          dtype=torch.int32).to(dev)
    dst = torch.empty(cap, dtype=torch.int32, device=dev)
    kref = blocked_rmw_set_plain(plane, bslots, bvals, cap)

    def k3b(mode):
        err = lib.probe_k3b(mode, plane.data_ptr(), bslots.data_ptr(),
                            bvals.data_ptr(), K3B_U, cap, dst.data_ptr(),
                            stream)
        if err:
            raise RuntimeError(f"probe_k3b mode {mode}: CUDA error {err}")
    for mode in (0, 1, 2, 3):
        k3b(mode)
        torch.cuda.synchronize()
        if not torch.equal(dst, kref):
            raise SystemExit(f"kernel_probe: K3b variant {mode} is wrong")
    b64 = bslots.long()
    print(f"K3b: CAP {cap}, U {K3B_U}; library torch.index_put out of "
          f"place: "
          f"{time_ms(lambda: torch.index_put(plane[:cap], (b64,), bvals)):.4f}"
          f" ms", flush=True)
    timed(lambda: blocked_rmw_set(plane, bslots, bvals, cap), K3B_VARIANTS,
          k3b, "K3b")
    print(smi, flush=True)


if __name__ == "__main__":
    main()
