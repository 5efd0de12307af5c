"""ctypes binding of the host runtime (``native/deeprec_native.cc``): the
host-index resolver, the host tier stores and the Criteo parser.

A framework-free copy of the resolver, tier and parser parts of
``deeprec_tpu/utils/native.py``: :func:`wire_layout`,
:class:`HostIndexResolver`, :class:`HostKV` (the host-DRAM row store, or a
file-backed one: the SSD tier), :class:`TierStack` (DRAM spilling to SSD)
and :func:`criteo_parse_chunk` (the C++ Criteo TSV parser under
``data.criteo.read_criteo_native``) are copied verbatim, their
pure-Python fallbacks included (``tests/test_torch_imports.py`` holds
them to their source). The port cannot import the JAX package. Its own
addition is :func:`resolve_wire_into`, which resolves into a caller's
buffer (a pinned tensor's memory in the training pipeline). Neither store
is documented as thread-safe: the host-index collection guards its tier
store with a lock.

The C++ source stays shared. :func:`get_lib` compiles it with ``g++`` at
first use into the git-ignored ``deeprec_tpu_torch/build/``, under a name
keyed by a hash of the source and flags: a temp file per process is
``os.replace``-d into place, so parallel builders agree, and the JAX
package's ``native/libdeeprec_native.so`` is never written. When no
compiler is available :func:`get_lib` returns None and the resolver takes
its Python fallback, unless the caller asked for ``use_native=True``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG.parent / "native" / "deeprec_native.cc"
BUILD = _PKG / "build"
_CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_i64 = ctypes.c_int64
_p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_p_f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def _build() -> Optional[Path]:
    if not _SRC.is_file():
        return None
    h = hashlib.sha256(" ".join(_CXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    so = BUILD / f"libdeeprec_native_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *_CXX_FLAGS, "-o", str(tmp), str(_SRC)],
                       check=True, capture_output=True, timeout=240)
    except (OSError, subprocess.SubprocessError):
        return None
    os.replace(tmp, so)  # atomic: concurrent builders agree
    return so


def get_lib() -> Optional[ctypes.CDLL]:
    """The resolver's shared library, built on first call; None when it
    cannot be built."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = _build()
        if so is None:
            return None
        lib = ctypes.CDLL(str(so))
        lib.hostkv_create.restype = ctypes.c_void_p
        lib.hostkv_create.argtypes = [_i64, _i64]
        lib.hostkv_create_disk.restype = ctypes.c_void_p
        lib.hostkv_create_disk.argtypes = [_i64, _i64, ctypes.c_char_p]
        lib.hostkv_is_disk.restype = _i64
        lib.hostkv_is_disk.argtypes = [ctypes.c_void_p]
        lib.hostkv_destroy.argtypes = [ctypes.c_void_p]
        lib.hostkv_size.restype = _i64
        lib.hostkv_size.argtypes = [ctypes.c_void_p]
        lib.hostkv_dim.restype = _i64
        lib.hostkv_dim.argtypes = [ctypes.c_void_p]
        lib.hostkv_upsert.argtypes = [ctypes.c_void_p, _p_i64, _p_f32, _i64]
        lib.hostkv_lookup.restype = _i64
        lib.hostkv_lookup.argtypes = [ctypes.c_void_p, _p_i64, _p_f32, _p_u8, _i64]
        lib.hostkv_erase.argtypes = [ctypes.c_void_p, _p_i64, _i64]
        lib.hostkv_export.restype = _i64
        lib.hostkv_export.argtypes = [ctypes.c_void_p, _p_i64, _p_f32, _i64]
        lib.hostkv_export_col.restype = _i64
        lib.hostkv_export_col.argtypes = [ctypes.c_void_p, _p_i64, _p_f32,
                                          _i64, _i64]
        lib.criteo_parse.restype = _i64
        lib.criteo_parse.argtypes = [ctypes.c_char_p, _i64, _i64,
                                     _p_f32, _p_f32, _p_i64,
                                     ctypes.POINTER(_i64)]
        lib.hidx_create.restype = ctypes.c_void_p
        lib.hidx_create.argtypes = [_i64]
        lib.hidx_destroy.argtypes = [ctypes.c_void_p]
        lib.hidx_reset.argtypes = [ctypes.c_void_p]
        lib.hidx_stats.argtypes = [ctypes.c_void_p, _p_i64]
        lib.hidx_resolve.restype = _i64
        lib.hidx_resolve.argtypes = [ctypes.c_void_p, _p_i64, _i64, _i64,
                                     _i64, _i64, _i64, _p_i32, _p_i64,
                                     _p_i32, _p_u8, _p_i32]
        lib.hidx_export.restype = _i64
        lib.hidx_export.argtypes = [ctypes.c_void_p, _p_i64, _i64]
        lib.hidx_load.restype = _i64
        lib.hidx_load.argtypes = [ctypes.c_void_p, _p_i64, _i64]
        lib.hidx_compact.restype = _i64
        lib.hidx_compact.argtypes = [ctypes.c_void_p, _p_u8, _p_i32]
        lib.hidx_reserve.argtypes = [ctypes.c_void_p, _i64]
        lib.hidx_resolve_wire.restype = _i64
        lib.hidx_resolve_wire.argtypes = [ctypes.c_void_p, _p_i64, _i64,
                                          _i64, _i64, _i64, _i64, _i64,
                                          _i64, _p_u8]
        lib.hidx_cbf_enable.restype = _i64
        lib.hidx_cbf_enable.argtypes = [ctypes.c_void_p, _i64, _i64, _i64]
        lib.hidx_cbf_export.restype = _i64
        lib.hidx_cbf_export.argtypes = [ctypes.c_void_p, _p_i32, _i64]
        lib.hidx_cbf_load.restype = _i64
        lib.hidx_cbf_load.argtypes = [ctypes.c_void_p, _p_i32, _i64]
        lib.hidx_track_touched.argtypes = [ctypes.c_void_p, _i64]
        lib.hidx_touched_export.restype = _i64
        lib.hidx_touched_export.argtypes = [ctypes.c_void_p, _p_i32, _i64,
                                            _i64]
        lib.hidx_touched_count.restype = _i64
        lib.hidx_touched_count.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


class HostKV:
    """Host-DRAM row store: the DRAM/PMEM storage tier of multi-tier
    embedding storage (reference StorageType{DRAM,PMEM}). Batched numpy
    API; C++ sharded open-addressing map underneath, dict fallback."""

    def __init__(self, dim: int, capacity_hint: int = 1 << 16,
                 path: Optional[str] = None):
        """``path``: file-backed (mmap) row arena — the SSD storage tier.
        None keeps rows in anonymous host DRAM."""
        self.dim = dim
        self.path = path
        self._lib = get_lib()
        if self._lib is not None:
            if path:
                os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
                self._h = ctypes.c_void_p(self._lib.hostkv_create_disk(
                    dim, capacity_hint, path.encode()))
            else:
                self._h = ctypes.c_void_p(
                    self._lib.hostkv_create(dim, capacity_hint))
            self._fallback = None
        else:
            self._h = None
            self._fallback = {}

    def __del__(self):
        if getattr(self, "_h", None) is not None and self._lib is not None:
            self._lib.hostkv_destroy(self._h)
            self._h = None

    def __len__(self) -> int:
        if self._h is not None:
            return int(self._lib.hostkv_size(self._h))
        return len(self._fallback)

    def upsert(self, keys: np.ndarray, rows: np.ndarray) -> None:
        keys = np.ascontiguousarray(keys, np.int64)
        rows = np.ascontiguousarray(rows, np.float32)
        assert rows.shape == (keys.shape[0], self.dim)
        if self._h is not None:
            self._lib.hostkv_upsert(self._h, keys, rows, keys.shape[0])
        else:
            for k, r in zip(keys, rows):
                self._fallback[int(k)] = r.copy()

    def lookup(self, keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(rows [n, dim] f32 — zeros on miss, found [n] bool)."""
        keys = np.ascontiguousarray(keys, np.int64)
        n = keys.shape[0]
        rows = np.zeros((n, self.dim), np.float32)
        found = np.zeros((n,), np.uint8)
        if self._h is not None:
            self._lib.hostkv_lookup(self._h, keys, rows, found, n)
        else:
            for i, k in enumerate(keys):
                r = self._fallback.get(int(k))
                if r is not None:
                    rows[i] = r
                    found[i] = 1
        return rows, found.astype(bool)

    def erase(self, keys: np.ndarray) -> None:
        keys = np.ascontiguousarray(keys, np.int64)
        if self._h is not None:
            self._lib.hostkv_erase(self._h, keys, keys.shape[0])
        else:
            for k in keys:
                self._fallback.pop(int(k), None)

    def export(self) -> Tuple[np.ndarray, np.ndarray]:
        n = len(self)
        keys = np.zeros((n,), np.int64)
        rows = np.zeros((n, self.dim), np.float32)
        if self._h is not None:
            w = int(self._lib.hostkv_export(self._h, keys, rows, n))
            return keys[:w], rows[:w]
        for i, (k, r) in enumerate(self._fallback.items()):
            keys[i] = k
            rows[i] = r
        return keys, rows

    def export_col(self, col: int) -> Tuple[np.ndarray, np.ndarray]:
        """All live keys + one f32 row column (width-x cheaper than a full
        export — the spill ranking only needs the version stamp)."""
        n = len(self)
        keys = np.zeros((n,), np.int64)
        vals = np.zeros((n,), np.float32)
        if self._h is not None:
            w = int(self._lib.hostkv_export_col(self._h, keys, vals, col, n))
            return keys[:w], vals[:w]
        for i, (k, r) in enumerate(self._fallback.items()):
            keys[i] = k
            vals[i] = r[col]
        return keys, vals


class TierStack:
    """DRAM -> SSD storage cascade (reference multi-tier EmbeddingVariable,
    embedding/config.proto StorageType{DRAM,PMEM,SSD}): rows demote into
    host DRAM first; when the DRAM tier passes ``dram_row_budget`` the
    coldest rows (by the payload's bit-pattern version stamp) spill to a
    file-backed store. Same batched API as :class:`HostKV`, so trainers
    and the checkpoint saver use either interchangeably."""

    def __init__(self, dim: int, version_col: int, dram_row_budget: int,
                 ssd_path: str, capacity_hint: int = 1 << 16):
        self.dim = dim
        self.version_col = version_col
        self.budget = int(dram_row_budget)
        self.dram = HostKV(dim, capacity_hint)
        self.ssd = HostKV(dim, capacity_hint, path=ssd_path)

    def __len__(self) -> int:
        return len(self.dram) + len(self.ssd)

    def upsert(self, keys: np.ndarray, rows: np.ndarray) -> None:
        # fresh demotions are the warmest cold rows: they enter DRAM; any
        # SSD copy of the same key is superseded
        self.dram.upsert(keys, rows)
        if len(keys):
            self.ssd.erase(keys)
        self._maybe_spill()

    def _maybe_spill(self) -> None:
        if not self.budget or len(self.dram) <= self.budget:
            return
        # rank coldness from the version COLUMN alone (keys + one f32 per
        # row instead of the full payload), select the spill set with an
        # O(n) argpartition, and read only the spilled rows — a 10M-row
        # DRAM budget spills without a full-tier export + sort pause
        keys, vcol = self.dram.export_col(self.version_col)
        vers = vcol.copy().view(np.int32)
        keep = self.budget // 2
        n_spill = len(keys) - keep
        part = np.argpartition(vers, n_spill - 1)[:n_spill]
        spill_keys = keys[part]
        rows, found = self.dram.lookup(spill_keys)
        self.ssd.upsert(spill_keys[found], rows[found])
        self.dram.erase(spill_keys)

    def lookup(self, keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        rows, found = self.dram.lookup(keys)
        miss = ~found
        if miss.any() and len(self.ssd):
            rows2, found2 = self.ssd.lookup(keys[miss])
            rows[miss] = np.where(found2[:, None], rows2, rows[miss])
            found = found.copy()
            found[np.nonzero(miss)[0][found2]] = True
        return rows, found

    def erase(self, keys: np.ndarray) -> None:
        self.dram.erase(keys)
        self.ssd.erase(keys)

    def export(self) -> Tuple[np.ndarray, np.ndarray]:
        k1, r1 = self.dram.export()
        k2, r2 = self.ssd.export()
        if not len(k2):
            return k1, r1
        return np.concatenate([k1, k2]), np.concatenate([r1, r2])


def wire_layout(u_out: int, n: int, with_counts: bool, inv16: bool):
    """Byte offsets of the v2 resolve wire (matches hidx_resolve_wire's
    layout exactly): returns (total_bytes, offsets) with offsets keyed
    slots/hi/lo/counts/inverse/tail. ``counts`` is None when absent."""
    o_hi = 4 * u_out
    o_lo = 8 * u_out
    o = 12 * u_out
    o_counts = None
    if with_counts:
        o_counts = o
        o += 4 * u_out
    o_inv = o
    o += ((2 * n + 3) & ~3) if inv16 else 4 * n
    o_tail = o
    return o_tail + 16, {"slots": 0, "hi": o_hi, "lo": o_lo,
                         "counts": o_counts, "inverse": o_inv,
                         "tail": o_tail}


def resolve_wire_into(resolver: "HostIndexResolver", keys: np.ndarray,
                      u_out: int, null_slot: int, row_capacity: int,
                      readonly: bool, with_counts: bool, inv16: bool,
                      out: np.ndarray) -> Tuple[int, int]:
    """:meth:`HostIndexResolver.resolve_wire` written straight into ``out``
    (a C-contiguous uint8 array of ``wire_layout(...)[0]`` bytes, e.g. the
    numpy view of a pinned tensor), so the wire needs no extra host copy.
    Returns (n_unique, n_overflow). The Python fallback resolves into its
    own buffer and copies it."""
    keys = np.ascontiguousarray(keys, np.int64).reshape(-1)
    n = keys.shape[0]
    total, _ = wire_layout(u_out, n, with_counts, inv16)
    if out.dtype != np.uint8 or out.shape != (total,) \
            or not out.flags["C_CONTIGUOUS"]:
        raise ValueError(f"out must be C-contiguous uint8 [{total}]")
    if resolver._h is None:
        buf, nu, nov = resolver.resolve_wire(keys, u_out, null_slot,
                                             row_capacity, readonly,
                                             with_counts, inv16)
        out[:] = buf
        return nu, nov
    rc = int(resolver._lib.hidx_resolve_wire(
        resolver._h, keys, n, u_out, null_slot, row_capacity,
        1 if readonly else 0, 1 if with_counts else 0, 1 if inv16 else 0,
        out))
    if rc == -2:
        raise RuntimeError("concurrent resolve detected: host-index resolves "
                           "must run single-threaded in step order")
    if rc < 0:
        raise ValueError("hidx_resolve_wire failed (check capacity < 2^30 "
                         "and u_out <= 32767 for the int16 inverse)")
    return rc >> 32, rc & 0xFFFFFFFF


class HostIndexResolver:
    """Host-resident key -> dense-slot index: the resolving half of the
    host-index embedding fast path (the role the reference's CPU hash maps
    play behind EmbeddingVariable — dense_hash_map.h / lockless_hash_map.h
    — rebuilt as a *pipelined* resolver: the host resolves step N+1's ids
    while the device executes step N, so the jitted step needs no on-device
    dedup sort or hash probe).

    Deterministic: slots are assigned densely in first-seen order
    (hash-group order, then batch order), independent of thread count.
    Python-dict fallback keeps the same semantics without the toolchain
    (single "group": group order == batch order at n_groups=1; tests pin
    C++ vs fallback equivalence at n_groups=1).
    """

    def __init__(self, n_groups: int = 16, use_native: Optional[bool] = None):
        self._lib = get_lib() if use_native in (None, True) else None
        if use_native is True and self._lib is None:
            raise RuntimeError("native library unavailable")
        self.n_groups = int(n_groups)
        if self._lib is not None:
            self._h = ctypes.c_void_p(self._lib.hidx_create(self.n_groups))
            if not self._h:
                raise ValueError(f"bad n_groups {n_groups}")
            self._fb = None
        else:
            self._h = None
            self._fb = {}          # key -> slot (or -1 pending)
            self._fb_keys = []     # keys by slot
            self._fb_cap_ovf = 0
            self._fb_uniq_ovf = 0
        self._fb_touch = None      # fallback touched-slot set (None = off)
        self._fb_cbf = None        # fallback CBF counters (None = off)
        self._cbf_cfg = None       # (m, n_hashes, freq) when enabled

    def __del__(self):
        if getattr(self, "_h", None) is not None and self._lib is not None:
            self._lib.hidx_destroy(self._h)
            self._h = None

    # -- lifecycle -------------------------------------------------------
    def reset(self) -> None:
        if self._h is not None:
            self._lib.hidx_reset(self._h)
        else:
            self._fb = {}
            self._fb_keys = []
            self._fb_cap_ovf = 0
            self._fb_uniq_ovf = 0
            if self._fb_touch is not None:
                self._fb_touch = set()
            if self._fb_cbf is not None:
                self._fb_cbf[:] = 0

    def reserve(self, n_rows: int) -> None:
        """Pre-size for ~n_rows keys (optional; kills rehash churn)."""
        if self._h is not None:
            self._lib.hidx_reserve(self._h, int(n_rows))

    @property
    def size(self) -> int:
        return self.stats()[0]

    def stats(self) -> Tuple[int, int, int]:
        """(materialized rows, cumulative row-capacity overflow, cumulative
        unique-width overflow)."""
        if self._h is not None:
            out = np.zeros((4,), np.int64)
            self._lib.hidx_stats(self._h, out)
            return int(out[0]), int(out[1]), int(out[2])
        return len(self._fb_keys), self._fb_cap_ovf, self._fb_uniq_ovf

    # -- the hot call ----------------------------------------------------
    def resolve(self, keys: np.ndarray, u_out: int, null_slot: int,
                row_capacity: int, readonly: bool = False):
        """Resolve a flat int64 id batch (-1 = padding).

        Returns (ukeys int64[u_out] (-1 padded), uslots int32[u_out],
        inverse int32[n], created uint8[u_out], counts int32[u_out],
        n_unique, n_overflow). Lane ``u_out - 1`` is the overflow group.
        In readonly mode ``created`` flags keys MISSING from the index
        (callers substitute their deterministic init row), and nothing is
        mutated.
        """
        keys = np.ascontiguousarray(keys, np.int64).reshape(-1)
        n = keys.shape[0]
        inverse = np.empty((n,), np.int32)
        ukeys = np.empty((u_out,), np.int64)
        uslots = np.empty((u_out,), np.int32)
        created = np.empty((u_out,), np.uint8)
        counts = np.empty((u_out,), np.int32)
        if self._h is not None:
            rc = int(self._lib.hidx_resolve(
                self._h, keys, n, u_out, null_slot, row_capacity,
                1 if readonly else 0, inverse, ukeys, uslots, created,
                counts))
            if rc == -2:
                raise RuntimeError(
                    "concurrent resolve detected: host-index resolves "
                    "mutate the key index and must run single-threaded "
                    "in step order (do NOT call pack_ids from prefetch "
                    "workers — pack numpy there, resolve on the main "
                    "thread; see train/cli.py)")
            if rc < 0:
                raise ValueError("hidx_resolve failed")
            return (ukeys, uslots, inverse, created, counts,
                    rc >> 32, rc & 0xFFFFFFFF)
        return self._fb_resolve(keys, u_out, null_slot, row_capacity,
                                readonly, inverse, ukeys, uslots, created,
                                counts)

    def _fb_resolve(self, keys, u_out, null_slot, row_capacity, readonly,
                    inverse, ukeys, uslots, created, counts):
        ukeys[:] = -1
        uslots[:] = null_slot
        created[:] = 0
        counts[:] = 0
        ovf = u_out - 1
        local: dict = {}
        n_unique = 0
        n_overflow = 0
        int64_min = -(1 << 63)
        # bloom gating defers slot work to a post-counts pass (the
        # estimate must see ALL of this batch's bumps first — native
        # parity)
        gate = self._fb_cbf is not None and not readonly
        for i, k in enumerate(keys.tolist()):
            if k == int64_min:  # the C++ map's sentinel remap, mirrored
                k = int64_min + 1
            li = local.get(k)
            if li is None:
                li = len(local)
                local[k] = li
                gi = min(li, ovf)
                if k != -1 and li >= ovf:
                    n_overflow += 1
                if k != -1 and li < ovf:
                    n_unique += 1
                    ukeys[li] = k
                    if not gate:
                        s = self._fb.get(k)
                        if readonly:
                            if s is None or s < 0:
                                created[li] = 1  # MISSING marker
                                s = None
                        elif s is None or s < 0:
                            if len(self._fb_keys) < row_capacity:
                                s = len(self._fb_keys)
                                self._fb[k] = s
                                self._fb_keys.append(k)
                                created[li] = 1
                            else:
                                self._fb[k] = -1  # pending: known, no row
                                self._fb_cap_ovf += 1
                                s = None
                        if s is not None:
                            uslots[li] = s
                            if not readonly and self._fb_touch is not None:
                                self._fb_touch.add(s)
            gi = min(li, ovf)
            inverse[i] = gi
            if k != -1 and gi < ovf:
                counts[gi] += 1
        if gate:
            self._fb_gated_assign(ukeys, uslots, created, counts,
                                  row_capacity)
        self._fb_uniq_ovf += n_overflow
        return ukeys, uslots, inverse, created, counts, n_unique, n_overflow

    def _fb_gated_assign(self, ukeys, uslots, created, counts,
                         row_capacity):
        """CBF pass of the fallback: bump all lanes' cells, then assign
        slots only to lanes whose post-bump min estimate admits them."""
        from ..sparse.keys import hash32_np
        m, n_hashes, freq = self._cbf_cfg
        lanes = np.nonzero(ukeys != -1)[0]
        if not lanes.size:
            return
        lk = ukeys[lanes]
        pos = np.stack([hash32_np(lk, seed=h + 1).astype(np.int64)
                        & (m - 1) for h in range(n_hashes)])
        for h in range(n_hashes):
            np.add.at(self._fb_cbf, pos[h], counts[lanes])
        est = self._fb_cbf[pos].min(axis=0)
        for li, k, e in zip(lanes.tolist(), lk.tolist(), est.tolist()):
            if e < freq:
                if k not in self._fb:
                    self._fb[k] = -1  # pending entry, native parity
                continue
            s = self._fb.get(k)
            if s is None or s < 0:
                if len(self._fb_keys) < row_capacity:
                    s = len(self._fb_keys)
                    self._fb[k] = s
                    self._fb_keys.append(k)
                    created[li] = 1
                else:
                    self._fb[k] = -1
                    self._fb_cap_ovf += 1
                    s = None
            if s is not None:
                uslots[li] = s
                if self._fb_touch is not None:
                    self._fb_touch.add(s)

    def resolve_wire(self, keys: np.ndarray, u_out: int, null_slot: int,
                     row_capacity: int, readonly: bool, with_counts: bool,
                     inv16: bool) -> Tuple[np.ndarray, int, int]:
        """Resolve directly into the single-transfer wire byte buffer
        (see :func:`wire_layout`). Returns (buf uint8, n_unique,
        n_overflow). Native writes every plane in C++; the fallback packs
        the plain :meth:`resolve` outputs into the identical bytes."""
        keys = np.ascontiguousarray(keys, np.int64).reshape(-1)
        n = keys.shape[0]
        total, off = wire_layout(u_out, n, with_counts, inv16)
        buf = np.empty((total,), np.uint8)
        if self._h is not None:
            rc = int(self._lib.hidx_resolve_wire(
                self._h, keys, n, u_out, null_slot, row_capacity,
                1 if readonly else 0, 1 if with_counts else 0,
                1 if inv16 else 0, buf))
            if rc == -2:
                raise RuntimeError(
                    "concurrent resolve detected: host-index resolves "
                    "must run single-threaded in step order")
            if rc < 0:
                raise ValueError("hidx_resolve_wire failed (check "
                                 "capacity < 2^30 and u_out <= 32767 "
                                 "for the int16 inverse)")
            return buf, rc >> 32, rc & 0xFFFFFFFF
        ukeys, uslots, inverse, created, counts, nu, nov = self.resolve(
            keys, u_out, null_slot, row_capacity, readonly)
        p32 = buf.view(np.int32)
        p32[:u_out] = uslots | (created.astype(np.int32) << 30)
        p32[u_out:2 * u_out] = (ukeys >> np.int64(32)).astype(np.int32)
        p32[2 * u_out:3 * u_out] = (
            ukeys & np.int64(0xFFFFFFFF)).astype(np.uint32).astype(np.int32)
        if with_counts:
            c0 = off["counts"] // 4
            p32[c0:c0 + u_out] = counts
        if inv16:
            buf[off["inverse"]:off["inverse"] + 2 * n].view(np.int16)[:] = \
                inverse.astype(np.int16)
        else:
            i0 = off["inverse"] // 4
            p32[i0:i0 + n] = inverse
        t0 = off["tail"] // 4
        p32[t0:t0 + 4] = (nu, nov, 1 if readonly else 0, 0x5EC2)
        return buf, nu, nov

    # -- counting-bloom admission -----------------------------------------
    def cbf_enable(self, m: int, n_hashes: int, freq: int) -> None:
        """Bloom-gate slot assignment: a key claims a dense slot (and
        touches its row) only once its post-bump count-min estimate
        reaches ``freq``. Replicates the device engine's
        _cbf_bump_and_estimate semantics (embedding_var.py) exactly —
        same hash family, bump-by-multiplicity, post-all-bumps estimate,
        per-batch re-check. Counters reset to zero."""
        self._cbf_cfg = (int(m), int(n_hashes), int(freq))
        if self._h is not None:
            if int(self._lib.hidx_cbf_enable(self._h, m, n_hashes,
                                             freq)) < 0:
                raise ValueError("bad CBF params (m must be a power of 2)")
        else:
            self._fb_cbf = np.zeros((m,), np.int32)

    def cbf_export(self) -> np.ndarray:
        if self._cbf_cfg is None:
            return np.zeros((0,), np.int32)
        m = self._cbf_cfg[0]
        if self._h is not None:
            out = np.empty((m,), np.int32)
            self._lib.hidx_cbf_export(self._h, out, m)
            return out
        return self._fb_cbf.copy()

    def cbf_load(self, counters: np.ndarray) -> None:
        counters = np.ascontiguousarray(counters, np.int32)
        if self._cbf_cfg is None or counters.shape[0] != self._cbf_cfg[0]:
            raise ValueError("CBF shape mismatch")
        if self._h is not None:
            if int(self._lib.hidx_cbf_load(self._h, counters,
                                           counters.shape[0])) < 0:
                raise ValueError("CBF shape mismatch")
        else:
            self._fb_cbf = counters.copy()

    # -- touched-slot recording (incremental checkpoints) ----------------
    def track_touched(self, enable: bool = True) -> None:
        """Record every slot used by train resolves (the reference's
        RecordSparseIndices recorder, incr_save_restore_ops.h:329 —
        relocated into the resolver where each touched slot is already
        visited once per batch)."""
        if self._h is not None:
            self._lib.hidx_track_touched(self._h, 1 if enable else 0)
        else:
            self._fb_touch = set() if enable else None

    def touched_count(self) -> int:
        if self._h is not None:
            return int(self._lib.hidx_touched_count(self._h))
        return len(self._fb_touch or ())

    def touched_slots(self, clear: bool = True) -> np.ndarray:
        """Slots touched since the last clear, ascending int32."""
        if self._h is not None:
            n = self.touched_count()
            out = np.empty((n,), np.int32)
            self._lib.hidx_touched_export(self._h, out, n,
                                          1 if clear else 0)
            return out
        out = np.asarray(sorted(self._fb_touch or ()), np.int32)
        if clear and self._fb_touch is not None:
            self._fb_touch = set()
        return out

    # -- checkpoint / eviction ------------------------------------------
    def export_keys(self) -> np.ndarray:
        """Materialized keys in slot order: key of slot i at index i."""
        n = self.size
        out = np.empty((n,), np.int64)
        if self._h is not None:
            self._lib.hidx_export(self._h, out, n)
            return out
        out[:] = self._fb_keys
        return out

    def load_keys(self, keys: np.ndarray) -> None:
        """Rebuild from a dense key list (restore): key i -> slot i."""
        keys = np.ascontiguousarray(keys, np.int64).reshape(-1)
        if self._h is not None:
            if int(self._lib.hidx_load(self._h, keys, keys.shape[0])) < 0:
                raise ValueError("duplicate or invalid key in load_keys")
            return
        self.reset()
        for i, k in enumerate(keys.tolist()):
            if k == -1 or k in self._fb:
                raise ValueError("duplicate or invalid key in load_keys")
            self._fb[k] = i
            self._fb_keys.append(k)

    def compact(self, keep: np.ndarray) -> np.ndarray:
        """Drop rows where ``keep[slot]`` is False, re-densify (save-time
        eviction). Returns old_to_new int32[old_size], -1 where dropped."""
        keep = np.ascontiguousarray(keep, np.uint8).reshape(-1)
        old_n = self.size
        assert keep.shape[0] == old_n
        old_to_new = np.empty((old_n,), np.int32)
        if self._h is not None:
            self._lib.hidx_compact(self._h, keep, old_to_new)
            return old_to_new
        kept = [k for i, k in enumerate(self._fb_keys) if keep[i]]
        j = 0
        for i in range(old_n):
            if keep[i]:
                old_to_new[i] = j
                j += 1
            else:
                old_to_new[i] = -1
        old_touch = self._fb_touch
        self.load_keys(np.asarray(kept, np.int64))
        if old_touch is not None:  # carry recording through the renumber
            self._fb_touch = {int(old_to_new[s]) for s in old_touch
                              if 0 <= s < old_n and old_to_new[s] >= 0}
        return old_to_new


def criteo_parse_chunk(buf: bytes, max_rows: int):
    """Parse up to max_rows Criteo TSV lines from ``buf``.

    Returns (labels f32[r], dense f32[r,13], cats int64[r,26], consumed
    bytes) or None if the native lib is unavailable.
    """
    lib = get_lib()
    if lib is None:
        return None
    labels = np.zeros((max_rows,), np.float32)
    dense = np.zeros((max_rows, 13), np.float32)
    cats = np.zeros((max_rows, 26), np.int64)
    consumed = _i64(0)
    r = int(lib.criteo_parse(buf, len(buf), max_rows, labels, dense,
                             cats.reshape(-1), ctypes.byref(consumed)))
    return labels[:r], dense[:r], cats[:r], int(consumed.value)
