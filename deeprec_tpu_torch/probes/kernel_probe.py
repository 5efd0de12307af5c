"""Design probes for K1, K2 (both directions), K3b, K4 and K5 on a CUDA
card.

Times the variants of ``kernel_probe.cu`` (each keeps or drops one part
of the kernel's work; the source lists them) beside the port's own
kernels and a PyTorch call computing the same function: K1 at the
serving, DIN, device-index and DHT shapes (:func:`k1_turns`, and the
K1 -> K2 pair of the serving path, :func:`k1_k2_pair`), K2 and K3b at the
training shape of one resolved B=4096 Criteo batch (106,496 ids into
~17,750 lanes, D 16) and at K3b's benchmark shape (CAP 2^21, U 17,664).
The previous design of K1 and of K2's forward is each one's variant 0:
:func:`k1_turns` and :func:`k2_forward` time it and the port's kernel in
turns (old, new, new, old), back to back and behind a PyTorch kernel
(:func:`behind_ms`), which ``chip_smoke.py`` also does at its shapes; so
are the previous designs of the hash index's K4 and K5 (:func:`k4_turns`,
:func:`k5_turns`, which ``chip_smoke.py`` runs at every K4 and K5 shape)
and K2's backward in its previous design, an LSD radix sort in one
cooperative launch, then the rows (``k2_bwd_radix.cuh``, timed in turns
with the port's counting sort by :func:`k2_bwd_turns` at every
K2-backward shape of ``chip_smoke.py``, beside the atomic design the port
ran before that, timed once; :func:`k2_bwd_split` splits each design's
device time between its two kernels and times the floor of a cooperative
ordering, an empty kernel crossing as many grid barriers).
Run from the root of a checkout on a machine with one card:

    python -m deeprec_tpu_torch.probes.kernel_probe [--k2-bwd]

(``--k2-bwd``: K2's backward alone, at :func:`k2_bwd_shapes`.)

It builds ``kernel_probe.cu`` (which includes ``csrc/gather_rows.cu``,
``csrc/hash_table.cu``, ``k2_bwd_atomic.cuh`` and ``k2_bwd_radix.cuh``)
with nvcc into the git-ignored build directory, prints one line per
variant (device ms per call: the median of 21 CUDA-event samples of 20
back-to-back calls behind a sleep kernel, L2 warm) and the card's name
and power limit.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import statistics
import subprocess
import sys
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
K2F_VARIANTS = {
    1: "empty kernel on the port's grid (launch floor)",
    2: "index loads only",
    3: "index and row loads, no stores",
    4: "stores only (zeros, no loads)",
    5: "the port's design, 256 threads a block",
    6: "the port's design, 128 threads a block",
    7: "the port's design, 512 threads a block",
    8: "the port's design, 1024 threads a block",
    9: "the port's design, streaming stores",
    10: "stores only, streaming",
    11: "two tiles a warp, 8 row loads in flight a lane",
    12: "the port's design as a programmatic dependent, 256 threads",
    13: "the port's design as a programmatic dependent, 128 threads",
    14: "the port's design as a programmatic dependent, 512 threads",
}
K1_VARIANTS = {
    0: "the previous design (a unit a thread behind its slot load, "
       "n*lanes/256 blocks, ordinary launch)",
    1: "empty kernel on the port's grid, dependent (launch floor)",
    2: "slot loads only (the port's tiles and grid)",
    3: "the port's design as an ordinary launch",
    4: "bulk asynchronous copies (cp.async.bulk, mbarrier), dependent",
    5: "the port's design, 1 row a thread",
    6: "the port's design, 2 rows a thread",
    7: "the port's design, 4 rows a thread",
    8: "the port's design, 8 rows a thread",
}
K1_CHECKED = (0, 3, 4, 5, 6, 7, 8)  # the variants that write the output
# (what, n slots, table rows addressed, d, slot dtype), as chip_smoke.py
# checks them
K1_SHAPES = [
    ("serving", 106_496, CAPACITY, EMB_DIM, torch.int64),
    ("DIN", 205_825, 1 << 19, EMB_DIM, torch.int64),
    ("device index", 26_625, CAPACITY, EMB_DIM, torch.int64),
    ("optimizer read", 17_750, CAPACITY, 2 * EMB_DIM, torch.int32),
    ("DHT", 5_195, 1 << 19, EMB_DIM, torch.int64),
    ("D 1", 26_625, CAPACITY, 1, torch.int32),
]
K4_VARIANTS = {
    0: "the previous design (a key a half-warp, probes in series, "
       "ordinary launch)",
    1: "4 keys a half-warp, dependent launch",
    2: "8 keys a half-warp, dependent launch",
    3: "16 keys a half-warp (a key a lane), dependent launch",
    4: "the port's run length as an ordinary launch",
    5: "2 keys a half-warp, dependent launch",
    6: "1 key a half-warp, dependent launch",
}
K5_VARIANTS = {
    0: "the previous design (plane copied out of place, words zeroed each "
       "call, three barriers on a steady step)",
    1: "the port's kernel on every resident block",
    2: "an empty cooperative kernel on the port's grid, one grid barrier",
    3: "the port's kernel at 2 keys a half-warp",
    4: "the port's kernel at 4 keys a half-warp",
    5: "the port's kernel at 8 keys a half-warp",
    6: "the port's kernel at 16 keys a half-warp (a key a lane)",
}
K5_CHECKED = (0, 1, 3, 4, 5, 6)  # the variants that insert
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


def behind_ms(fn, samples=21, alone=None):
    """Device ms per call of ``fn`` behind a one-element PyTorch add, as on
    the training path, where a PyTorch kernel (which never lets a
    programmatic dependent start early) precedes each kernel: the time of
    the pair less the add's own (``alone``, when the caller has it).
    Back to back, a kernel launched as a programmatic dependent also
    overlaps its own previous call."""
    tiny = torch.zeros(1, device="cuda")
    if alone is None:
        alone = time_ms(lambda: tiny.add_(1), samples)

    def pair():
        tiny.add_(1)
        fn()
    return time_ms(pair, samples) - alone


@functools.cache
def build() -> ctypes.CDLL:
    """The probe library (built once a process)."""
    src = b"".join(f.read_bytes() for f in (
        SOURCE, SOURCE.with_name("k2_bwd_atomic.cuh"),
        SOURCE.with_name("k2_bwd_radix.cuh"),
        _build.CSRC / "gather_rows.cu", _build.CSRC / "hash_table.cu",
        _build.CSRC / "launch.cuh"))
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
    lib.probe_k2f.argtypes = [i, p, i64, i64, p, i, p, i64, p, p]
    lib.probe_k1.argtypes = [i, p, i64, i64, p, i, i64, i64, p, i, p]
    lib.probe_k4.argtypes = [i, p, i64, p, i64, i, p, p, p]
    lib.probe_k5.argtypes = [i, p, p, i64, p, i64, i, p, p, p, p, p, p, p,
                             p, p]
    # the atomic K2 backward: the port's entry's arguments before it was
    # made deterministic (d_pooled ... n_rows, vec, bf16_out, stream)
    lib.probe_k2_bwd_atomic.argtypes = [p, i64, p, i, i64, i64, p, i64, i64,
                                        i64, i64, i, p, i64, i, p, p]
    # the radix-sorted K2 backward: the port's entry's arguments
    lib.probe_k2_bwd_radix.argtypes = [p, i64, p, i, i64, i64, p, i64, i64,
                                       i64, i64, i, p, i64, i, i, p, p]
    lib.probe_k2_bwd_radix_scratch.argtypes = [i64, i64, i64]
    lib.probe_k2_bwd_radix_scratch.restype = i64
    lib.probe_grid_barriers.argtypes = [i, i64, i, p]
    return lib


def k2_bwd_atomic(lib, d_pooled, slots, valid, combiner, n_rows):
    """K2's backward as the port ran it before it was made deterministic
    (``k2_bwd_atomic.cuh``): a zero-fill, the warp-grouped float4 atomics
    and, for a bf16 gradient, a rounding pass; called as its wrapper did.
    Its sums land in a different order on every run."""
    from ..ops.fused_lookup import COMBINERS
    n_bags, w = slots.shape
    d = d_pooled.shape[1]
    out = torch.empty((n_rows, d), dtype=torch.float32,
                      device=d_pooled.device)
    narrow = (torch.empty((n_rows, d), dtype=torch.bfloat16,
                          device=d_pooled.device)
              if d_pooled.dtype == torch.bfloat16 else None)
    es = d_pooled.element_size()
    vec = next(v for v in (4, 2, 1) if d % v == 0
               and d_pooled.data_ptr() % (es * v) == 0)
    err = lib.probe_k2_bwd_atomic(
        d_pooled.data_ptr(), d, slots.data_ptr(),
        int(slots.dtype == torch.int64), slots.stride(0), slots.stride(1),
        valid.data_ptr(), valid.stride(0), valid.stride(1), n_bags, w,
        COMBINERS.index(combiner), out.data_ptr(), n_rows, vec,
        0 if narrow is None else narrow.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"probe_k2_bwd_atomic: CUDA error {err}")
    return out if narrow is None else narrow


def k2_bwd_radix(lib, d_pooled, slots, valid, combiner, n_rows):
    """K2's backward in its previous design (``k2_bwd_radix.cuh``): the valid
    lanes stably sorted by row, an LSD radix sort 8 bits a pass in one
    cooperative launch, then each row summed as its programmatic
    dependent; called as the port's wrapper calls its kernel."""
    from ..ops.fused_lookup import COMBINERS
    n_bags, w = slots.shape
    d = d_pooled.shape[1]
    out = torch.empty((n_rows, d), dtype=d_pooled.dtype,
                      device=d_pooled.device)
    es = d_pooled.element_size()
    vec = next(v for v in (4, 2, 1) if d % v == 0
               and d_pooled.data_ptr() % (es * v) == 0)
    scratch = torch.empty(max(1, lib.probe_k2_bwd_radix_scratch(
        n_bags, w, n_rows)), dtype=torch.uint8, device=d_pooled.device)
    err = lib.probe_k2_bwd_radix(
        d_pooled.data_ptr(), d, slots.data_ptr(),
        int(slots.dtype == torch.int64), slots.stride(0), slots.stride(1),
        valid.data_ptr(), valid.stride(0), valid.stride(1), n_bags, w,
        COMBINERS.index(combiner), out.data_ptr(), n_rows, vec,
        int(d_pooled.dtype == torch.bfloat16), scratch.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"probe_k2_bwd_radix: CUDA error {err}")
    return out


def k2_bwd_turns(lib, d_pooled, slots, valid, combiner, n_rows, what,
                 samples=21):
    """K2's backward at one shape: the radix design, checked bit-equal
    to the port's kernel (both add each row's lanes in one order and one
    run tree), timed in turns with it (old, new, new, old), back to back
    and behind a one-element add; the atomic design, checked within 1e-4
    of the magnitudes, timed once. Returns :func:`in_turns`'s dict with
    ``atomic``: the atomic design's ms."""
    from ..ops.fused_lookup import fused_pooled_lookup_backward as port
    new = port(d_pooled, slots, valid, combiner, n_rows)
    radix = k2_bwd_radix(lib, d_pooled, slots, valid, combiner, n_rows)
    if not torch.equal(_bits(radix), _bits(new)):
        raise SystemExit(f"kernel_probe: the radix K2 backward {what} "
                         f"differs from the port's bits")
    mag = port(d_pooled.float().abs(), slots, valid, combiner, n_rows)
    old = k2_bwd_atomic(lib, d_pooled, slots, valid, combiner, n_rows)
    step = 2.0 ** -7 if d_pooled.dtype == torch.bfloat16 else 0.0
    if not bool(((old.float() - new.float()).abs()
                 <= step * new.float().abs() + 1e-4 * mag + 1e-7).all()):
        raise SystemExit(f"kernel_probe: the atomic K2 backward {what} "
                         f"differs from the port's")
    res = in_turns(
        lambda: k2_bwd_radix(lib, d_pooled, slots, valid, combiner, n_rows),
        lambda: port(d_pooled, slots, valid, combiner, n_rows),
        f"K2 backward {what}", "radix", samples)
    res["atomic"] = time_ms(lambda: k2_bwd_atomic(
        lib, d_pooled, slots, valid, combiner, n_rows), samples)
    return res


def k2_bwd_split(lib, d_pooled, slots, valid, combiner, n_rows, calls=20):
    """Each K2-backward design's device time split by kernel (a
    torch.profiler window of ``calls`` back-to-back calls each), and the
    floor of each design's ordering: an empty cooperative kernel crossing
    as many grid barriers on the port's grid (its three barriers;
    the radix design's: two a pass and one more). Returns ``{"port" |
    "radix": {"order" | "rows": device us a call}, "floor": {barriers:
    us}}``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from ..ops.fused_lookup import fused_pooled_lookup_backward as port
    n_bags, w = slots.shape
    bits = max(1, int(n_rows).bit_length())  # keys 0 .. n_rows
    out = {}
    for name, fn in (("port", port), ("radix", functools.partial(
            k2_bwd_radix, lib))):
        for _ in range(3):
            fn(d_pooled, slots, valid, combiner, n_rows)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn(d_pooled, slots, valid, combiner, n_rows)
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        out[name] = {k: sum(getattr(e, "self_device_time_total", 0.0)
                            for e in kernels if f"{k}_kernel" in e.key)
                     / calls for k in ("order", "rows")}
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = max(sms, -(-n_bags * w // 1024), -(-n_rows // 1024))
    floor = {}
    for barriers in (3, 2 * -(-bits // 8) + 1):
        def run(k=barriers):
            err = lib.probe_grid_barriers(k, blocks, 1024, stream)
            if err:
                raise RuntimeError(f"probe_grid_barriers: CUDA error {err}")
        floor[barriers] = 1000 * time_ms(run, 7)
    out["floor"] = floor
    print(f"  split (device us a call): port {out['port']}; radix "
          f"{out['radix']}; an empty cooperative kernel on {blocks} blocks "
          f"of 1,024 threads crossing k barriers: {floor}", flush=True)
    return out


def k1_runner(lib, values, slots, d, out):
    """(run(mode), unit): launches K1 probe variant ``mode`` on the
    arguments the port's wrapper would pass, writing ``out``."""
    from ..ops.gather import _unit
    es = values.element_size()
    row_bytes, ld_bytes = d * es, values.stride(0) * es
    unit = _unit(row_bytes, ld_bytes, values.data_ptr(), out.data_ptr())
    args = (values.data_ptr(), ld_bytes, values.shape[0], slots.data_ptr(),
            int(slots.dtype == torch.int64), slots.shape[0], row_bytes,
            out.data_ptr(), unit)

    def run(mode):
        err = lib.probe_k1(mode, *args,
                           torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"probe_k1 mode {mode}: CUDA error {err}")
    return run, unit


def _bits(t):
    return t.contiguous().view(torch.uint8)


def k1_turns(lib, values, slots, d, what, variants=False, samples=11):
    """K1 at one shape: each complete probe variant (the previous design,
    and with ``variants`` the others) checked bit-equal to the plain
    version, then the previous design (variant 0) and the port's kernel in
    turns (old, new, new, old), back to back and behind a one-element add;
    with ``variants`` each variant timed too. Returns :func:`in_turns`'s
    dict with ``mode: ms`` and ``"behind": {mode: ms}`` added."""
    from ..ops.gather import gather_rows, gather_rows_plain
    ref = gather_rows_plain(values, slots, d)
    out = torch.empty_like(ref)
    run, unit = k1_runner(lib, values, slots, d, out)
    modes = [m for m in (K1_CHECKED if variants else (0,))
             if m != 4 or unit == 16]
    for mode in modes:
        _bits(out).fill_(0xFF)  # f32 NaN: a unit left unwritten shows
        run(mode)
        torch.cuda.synchronize()
        if not torch.equal(_bits(out), _bits(ref)):
            raise SystemExit(f"kernel_probe: K1 variant {mode} is wrong "
                             f"{what}")

    res = in_turns(lambda: run(0), lambda: gather_rows(values, slots, d),
                   f"K1 {what}", "old = the previous design", samples)
    res["behind"] = {}
    if variants:
        for mode, label in K1_VARIANTS.items():
            if mode == 4 and unit != 16:
                continue
            res[mode] = time_ms(lambda: run(mode), samples)
            if mode in (3, 4, 5, 6, 7, 8):
                res["behind"][mode] = behind_ms(lambda: run(mode), samples,
                                                res["alone"])
            on = res["behind"].get(mode)
            print(f"  K1 {what} variant {mode} {label}: {res[mode]:.4f} ms"
                  + ("" if on is None else f"; behind the add {on:.4f} ms"),
                  flush=True)
    return res


def k1_k2_pair(lib, values, slots, d, inv, valid, what, samples=11):
    """K1 then K2's forward on K1's rows (``[n, 1]`` one-id bags, sum), as
    the serving and host-index training paths run them: with the previous K1
    (probe variant 0) and with the port's, in turns (old, new, new, old),
    back to back and behind a one-element add. Both pairs are checked
    bit-equal to the plain versions first. Returns :func:`in_turns`'s
    dict."""
    from ..ops.fused_lookup import (fused_pooled_lookup,
                                    fused_pooled_lookup_plain)
    from ..ops.gather import gather_rows, gather_rows_plain
    rows = torch.empty(slots.shape[0], d, dtype=values.dtype,
                       device=values.device)
    run, _ = k1_runner(lib, values, slots, d, rows)
    ref = fused_pooled_lookup_plain(gather_rows_plain(values, slots, d), inv,
                                    valid, "sum")

    def old():
        run(0)
        return fused_pooled_lookup(rows, inv, valid, "sum")

    def new():
        return fused_pooled_lookup(gather_rows(values, slots, d), inv, valid,
                                   "sum")
    for name, fn in (("old", old), ("new", new)):
        if not torch.equal(_bits(fn()), _bits(ref)):
            raise SystemExit(f"kernel_probe: the {name} K1 -> K2 pair is "
                             f"wrong {what}")
    return in_turns(old, new, f"K1 -> K2 pair {what}", "old K1", samples)


def in_turns(old, new, what, old_name, samples):
    """``old`` and ``new`` timed in turns (old, new, new, old), back to
    back and behind a one-element add; prints them. Returns ``{"old",
    "new", "old_behind", "new_behind": ms (the mean of two turns),
    "turns", "behind_turns": [4 ms], "alone": the add's own ms}``."""
    tiny = torch.zeros(1, device="cuda")
    alone = time_ms(lambda: tiny.add_(1), samples)
    turns = [time_ms(f, samples) for f in (old, new, new, old)]
    behind = [behind_ms(f, samples, alone) for f in (old, new, new, old)]
    print(f"  {what}: turns ({old_name}, new, new, old) "
          + ", ".join(f"{t:.4f}" for t in turns) + " ms back to back; "
          + ", ".join(f"{t:.4f}" for t in behind)
          + " ms behind a one-element add", flush=True)
    return {"old": (turns[0] + turns[3]) / 2,
            "new": (turns[1] + turns[2]) / 2,
            "old_behind": (behind[0] + behind[3]) / 2,
            "new_behind": (behind[1] + behind[2]) / 2,
            "turns": turns, "behind_turns": behind, "alone": alone}


def call_ms(fn, reset, samples=21, behind=False):
    """Device ms of one call of ``fn`` (the median over ``samples``), each
    sample timed alone between CUDA events after ``reset()`` (outside the
    events) and a sleep kernel that holds the stream while the host
    enqueues: for a call that changes its inputs (an insert into a table),
    which ``reset`` restores. ``behind``: behind a one-element add, the
    add's own time (timed the same way) subtracted."""
    tiny = torch.zeros(1, device="cuda")

    def one(f):
        times = []
        for _ in range(samples + 2):  # the first two warm up
            reset()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(2_000_000)
            a.record()
            if behind:
                tiny.add_(1)
            f()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times[2:])
    alone = one(lambda: None) if behind else 0.0
    return one(fn) - alone


def k4_turns(lib, table, keys, max_probes, what, samples=21):
    """K4 at one shape: every probe variant checked bit-equal to the plain
    lookup and timed; the previous design (variant 0) and the port's
    kernel in turns (old, new, new, old), back to back and behind a
    one-element add. Returns :func:`in_turns`'s dict with ``mode: ms``."""
    from ..sparse import hashtable as ht
    ref = ht.lookup_plain(table, keys, max_probes)
    n, cap = keys.shape[0], table.capacity
    slots = torch.empty(n, dtype=torch.int64, device=keys.device)
    found = torch.empty(n, dtype=torch.bool, device=keys.device)

    def run(mode):
        err = lib.probe_k4(mode, table.keys.data_ptr(), cap, keys.data_ptr(),
                           n, max_probes, slots.data_ptr(), found.data_ptr(),
                           torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"probe_k4 mode {mode}: CUDA error {err}")
    for mode in K4_VARIANTS:
        slots.fill_(-7)
        run(mode)
        torch.cuda.synchronize()
        if not (torch.equal(slots, ref[0]) and torch.equal(found, ref[1])):
            raise SystemExit(f"kernel_probe: K4 variant {mode} is wrong "
                             f"{what}")
    res = in_turns(lambda: run(0),
                   lambda: ht.lookup(table, keys, max_probes), f"K4 {what}",
                   "old = the previous design", samples)
    for mode, label in K4_VARIANTS.items():
        res[mode] = time_ms(lambda: run(mode), samples)
        res.setdefault("behind", {})[mode] = behind_ms(
            lambda: run(mode), samples, res["alone"])
        print(f"  K4 {what} variant {mode} {label}: {res[mode]:.4f} ms; "
              f"behind the add {res['behind'][mode]:.4f} ms", flush=True)
    return res


def k5_turns(lib, table, keys, max_probes, what, samples=21):
    """K5 at one shape, ``table`` the index before the insert (left as it
    was): the previous design (variant 0: a new plane, the input read) and
    the port's in-place kernel each checked bit-equal to the plain insert,
    the arbitration words all zero after every call; then both in turns
    (old, new, new, old), alone and behind a one-element add. Where every
    key is already stored (a steady step: the insert changes nothing) the
    calls run back to back (:func:`time_ms`); otherwise each call is timed
    alone on a fresh copy of ``table`` made outside the events
    (:func:`call_ms`). Also times the functional form's clone of the table
    and the port's kernel on every resident block (variant 1). Returns
    :func:`in_turns`'s keys, ``steady``, ``clone_ms`` and ``1``."""
    from ..ops import hash_probe
    from ..sparse import hashtable as ht
    ref_t, ref_slots, ref_created = ht.lookup_or_insert_plain(
        table, keys, max_probes)
    # a steady step: the insert leaves the table as it was
    steady = all(torch.equal(a, b) for a, b in zip(ref_t, table))
    before = ht.clone(table)
    n, cap, dev = keys.shape[0], table.capacity, keys.device
    work = ht.clone(table)  # the new kernel's table
    out = ht.clone(table)   # the old kernel's output table
    slots = torch.empty(n, dtype=torch.int64, device=dev)
    created = torch.empty(n, dtype=torch.bool, device=dev)
    w = min(ht.WINDOW, cap)
    old_scratch = torch.empty(3 * n + cap + max_probes + w,
                              dtype=torch.int32, device=dev)
    arb = hash_probe.arbitration_words(dev, cap)
    stream = torch.cuda.current_stream().cuda_stream

    def reset():
        for a, b in zip(work, table):
            a.copy_(b)

    def run(mode):
        kst = torch.empty(2 * n, dtype=torch.int32, device=dev)
        err = lib.probe_k5(mode, table.keys.data_ptr(),
                           (out if mode == 0 else work).keys.data_ptr(), cap,
                           keys.data_ptr(), n, max_probes,
                           table.size.data_ptr(), table.overflow.data_ptr(),
                           (out if mode == 0 else work).size.data_ptr(),
                           (out if mode == 0 else work).overflow.data_ptr(),
                           slots.data_ptr(), created.data_ptr(),
                           (old_scratch if mode == 0 else kst).data_ptr(),
                           arb.data_ptr(), stream)
        if err:
            raise RuntimeError(f"probe_k5 mode {mode}: CUDA error {err}")

    def port():
        return ht.lookup_or_insert_(work, keys, max_probes)

    def check(name, got_t, got_slots, got_created):
        torch.cuda.synchronize()
        same = (all(torch.equal(a, b) for a, b in zip(got_t, ref_t))
                and torch.equal(got_slots, ref_slots)
                and torch.equal(got_created, ref_created))
        if not same:
            raise SystemExit(f"kernel_probe: K5 {name} is wrong {what}")
        if bool(arb.any()):
            raise SystemExit(f"kernel_probe: K5 {name} left arbitration "
                             f"words set {what}")
    for mode in K5_CHECKED:
        reset()
        run(mode)
        check(f"variant {mode}", out if mode == 0 else work, slots, created)
    reset()
    _, s, c = port()
    check("(the port's kernel)", work, s, c)
    check("(the functional form)", *ht.lookup_or_insert(table, keys,
                                                         max_probes))
    if not all(torch.equal(a, b) for a, b in zip(table, before)):
        raise SystemExit(f"kernel_probe: K5's functional form wrote its "
                         f"input {what}")

    if steady:
        res = in_turns(lambda: run(0), port, f"K5 {what}",
                       "old = the previous design", samples)
        for mode in list(K5_VARIANTS)[1:]:
            res[mode] = time_ms(lambda: run(mode), samples)
            res.setdefault("behind", {})[mode] = behind_ms(
                lambda: run(mode), samples, res["alone"])
        res["lookup_ms"] = time_ms(lambda: ht.lookup(table, keys,
                                                     max_probes), samples)
    else:
        turns = [call_ms(f, reset, samples) for f in
                 (lambda: run(0), port, port, lambda: run(0))]
        behind = [call_ms(f, reset, samples, behind=True) for f in
                  (lambda: run(0), port, port, lambda: run(0))]
        print(f"  K5 {what}: turns (old = the previous design, new, new, "
              f"old) " + ", ".join(f"{t:.4f}" for t in turns)
              + " ms a call alone on a fresh table; "
              + ", ".join(f"{t:.4f}" for t in behind)
              + " ms behind a one-element add", flush=True)
        res = {"old": (turns[0] + turns[3]) / 2,
               "new": (turns[1] + turns[2]) / 2,
               "old_behind": (behind[0] + behind[3]) / 2,
               "new_behind": (behind[1] + behind[2]) / 2,
               "turns": turns, "behind_turns": behind}
        for mode in list(K5_VARIANTS)[1:]:
            res[mode] = call_ms(lambda: run(mode), reset, samples)
            res.setdefault("behind", {})[mode] = call_ms(
                lambda: run(mode), reset, samples, behind=True)
    reset()
    check("(after the timing)", *port())
    res["steady"] = steady
    res["clone_ms"] = time_ms(lambda: ht.clone(table), samples)
    for mode in list(K5_VARIANTS)[1:]:
        print(f"  K5 {what} variant {mode} {K5_VARIANTS[mode]}: "
              f"{res[mode]:.4f} ms; behind the add "
              f"{res['behind'][mode]:.4f} ms", flush=True)
    print(f"  K5 {what}: the functional form's clone of the table "
          f"{res['clone_ms']:.4f} ms"
          + (f"; K4's lookup of the same keys {res['lookup_ms']:.4f} ms"
             if steady else ""), flush=True)
    return res


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


def k2_bwd_shapes(dev, g):
    """K2-backward probe shapes, ``{what: (d_pooled, slots, valid,
    n_rows)}``, D 16, sum: the training shape (one resolved batch's
    106,496 ids into ~17,750 rows, Criteo's skew: rows of 17-128 and of
    more than 128 lanes), the multi-hash one (a row per id), short rows
    only (106,496 ids uniform over 26,624 rows, at most ~16 a row) and a
    DIN-like expansion (262,144 one-id bags, 56 % valid, onto 205,825 rows
    with a squared skew)."""
    inv, valid, u = training_batch(dev)
    n = inv.shape[0]
    dp = torch.randn(n, EMB_DIM, generator=g).to(dev)
    every = torch.ones(n, 1, dtype=torch.bool, device=dev)
    m, din = 2 * B * 32, 205_825
    return {
        "training": (dp, inv.view(-1, 1), valid.view(-1, 1), u),
        "multi-hash": (dp, torch.arange(n, device=dev).view(-1, 1), every,
                       n),
        "short rows only": (dp, torch.randint(0, n // 4, (n, 1),
                                              generator=g).to(dev),
                            every, n // 4),
        "DIN-like": (torch.randn(m, EMB_DIM, generator=g).to(dev),
                     (torch.rand(m, generator=g) ** 2 * din).long()
                     .view(-1, 1).to(dev),
                     (torch.rand(m, 1, generator=g) < 0.56).to(dev), din),
    }


def k2_bwd_rows(slots, valid, n_rows):
    """A K2-backward shape's rows by lane count: (touched, of 17-128 lanes,
    of more, the most lanes a row)."""
    lanes = torch.bincount(slots.clamp(0, n_rows - 1)[valid].long().cpu(),
                           minlength=n_rows)
    return (int((lanes > 0).sum()), int(((lanes > 16) & (lanes <= 128))
                                        .sum()),
            int((lanes > 128).sum()), int(lanes.max()))


def k2_bwd_probe(lib, dev, g):
    """K2's backward at :func:`k2_bwd_shapes`: in turns with the radix
    design, the atomic design beside, each design's time by kernel."""
    for what, (dp, slots, valid, u) in k2_bwd_shapes(dev, g).items():
        touched, mid, long, most = k2_bwd_rows(slots, valid, u)
        print(f"K2 backward {what}: {slots.numel()} ids into {u} rows, "
              f"{touched} touched, {mid} of 17-128 lanes, {long} of more "
              f"(the most {most})", flush=True)
        res = k2_bwd_turns(lib, dp, slots, valid, "sum", u, what)
        print(f"  port {res['new']:.4f} ms, radix {res['old']:.4f}, "
              f"atomic {res['atomic']:.4f}", flush=True)
        k2_bwd_split(lib, dp, slots, valid, "sum", u)


def k2_forward(lib, values, slots, valid, what):
    """K2's forward at ``[n, 1]`` bags of ``values [R, 16]`` (f32, rows
    16-byte aligned), sum: the old kernel (variant 0) and the port's in
    turns, then the variants. Returns ``{"old": ms, "new": ms, mode: ms}``
    (old and new: the mean of their two turns)."""
    from ..ops.fused_lookup import (fused_pooled_lookup,
                                    fused_pooled_lookup_plain)
    n = slots.shape[0]
    s1, v1 = slots.reshape(-1).contiguous(), valid.reshape(-1).contiguous()
    out = torch.empty(n, values.shape[1], device=values.device)
    ref = fused_pooled_lookup_plain(values, s1.view(-1, 1), v1.view(-1, 1),
                                    "sum")
    stream = torch.cuda.current_stream().cuda_stream

    def run(mode):
        err = lib.probe_k2f(mode, values.data_ptr(), values.stride(0) // 4,
                            values.shape[0], s1.data_ptr(),
                            int(s1.dtype == torch.int64), v1.data_ptr(), n,
                            out.data_ptr(), stream)
        if err:
            raise RuntimeError(f"probe_k2f mode {mode}: CUDA error {err}")
    for mode in (0, 5, 6, 7, 8, 9, 11, 12, 13, 14):  # give the function
        out.fill_(float("nan"))
        run(mode)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise SystemExit(f"kernel_probe: K2 forward variant {mode} is "
                             f"wrong")

    def port():
        return fused_pooled_lookup(values, s1.view(-1, 1), v1.view(-1, 1),
                                   "sum")
    turns = [time_ms(lambda: run(0)), time_ms(port), time_ms(port),
             time_ms(lambda: run(0))]
    res = {"old": (turns[0] + turns[3]) / 2, "new": (turns[1] + turns[2]) / 2}
    print(f"  K2 forward {what}: old kernel (variant 0) {turns[0]:.4f} / "
          f"{turns[3]:.4f} ms, the port's {turns[1]:.4f} / {turns[2]:.4f} ms "
          f"(turns: old, new, new, old)", flush=True)
    for mode, label in K2F_VARIANTS.items():
        res[mode] = time_ms(lambda: run(mode))
        print(f"  K2 forward {what} variant {mode} {label}: "
              f"{res[mode]:.4f} ms", flush=True)
    res["behind"] = {"old": behind_ms(lambda: run(0)),
                     "new": behind_ms(port)}
    res["behind"].update({m: behind_ms(lambda: run(m))
                          for m in (5, 12, 13, 14)})
    print(f"  K2 forward {what} behind a one-element add (its time "
          f"subtracted): "
          + ", ".join(f"{'variant ' if isinstance(m, int) else ''}{m} "
                      f"{t:.4f} ms" for m, t in res["behind"].items()),
          flush=True)
    return res


def timed(port, variants, run, what):
    """Prints the port's kernel and each variant, the port timed before
    and after the variants (clocks and neighbours drift within a run)."""
    first = time_ms(port)
    for mode, label in variants.items():
        print(f"  {what} variant {mode:2d} {label}: "
              f"{time_ms(lambda: run(mode)):.4f} ms", flush=True)
    print(f"  {what} port kernel: {first:.4f} ms before the variants, "
          f"{time_ms(port):.4f} ms after", flush=True)


def k1_shapes(lib, dev, g):
    """K1's turns and variants at :data:`K1_SHAPES`: uniform random slots
    into a 32-wide table (the fused value + accumulator rows), the first d
    columns read; the K1 -> K2 pair at the serving shape."""
    table = torch.randn(CAPACITY + 1, 2 * EMB_DIM, generator=g).to(dev)
    for what, n, rows, d, idx in K1_SHAPES:
        slots = torch.randint(0, rows, (n,), generator=g).to(idx).to(dev)
        k1_turns(lib, table, slots, d, f"({what}, [{n}] x {d} of {rows} "
                 f"rows)", variants=True, samples=21)
        if what == "serving":
            inv = torch.randint(0, n, (26 * B, 1), generator=g).to(dev)
            valid = (torch.rand(26 * B, 1, generator=g) < 0.97).to(dev)
            k1_k2_pair(lib, table, slots, d, inv, valid,
                       "(serving shape, [26*4096, 1] sum)", samples=21)


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

    g = torch.Generator().manual_seed(1)
    if "--k2-bwd" in sys.argv[1:]:  # K2's backward alone
        k2_bwd_probe(lib, dev, g)
        print(smi, flush=True)
        return
    k1_shapes(lib, dev, g)

    inv, valid, u = training_batch(dev)
    n = inv.shape[0]
    urows = torch.randn(u, EMB_DIM, generator=g).to(dev)
    k2_forward(lib, urows, inv, valid, f"(training shape, [{n}, 1] into "
               f"{u} rows)")
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
    k2_bwd_probe(lib, dev, g)

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
