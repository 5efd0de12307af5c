"""64-bit feature keys as one int64 tensor.

Port of ``deeprec_tpu/sparse/keys.py``. The TPU package carries a key as
two int32 planes ``(hi, lo)`` because the TPU emulates int64; torch has
int64 on both the CPU and the GPU, so here a key is just an int64 value and
``EMPTY = -1`` (the all-ones key, DeepRec's invalid key) is the padding
sentinel.

The hashes are bit-equal to the JAX ones: their uint32 arithmetic runs in
int64 with ``& 0xFFFFFFFF`` after every multiply and before every shift
(an int64 multiply wraps mod 2^64, which keeps the low 32 bits right), and
``hi`` is ``(key >> 32) & 0xFFFFFFFF``, the uint32 view of the JAX int32
``hi`` plane.
"""
from __future__ import annotations

import numpy as np
import torch

EMPTY = -1
_M32 = 0xFFFFFFFF


def is_empty(keys: torch.Tensor) -> torch.Tensor:
    return keys == EMPTY


def split_np(ids) -> tuple:
    """int64 numpy -> (hi, lo) int32 numpy planes, the JAX package's key
    encoding (``deeprec_tpu.sparse.keys.split_np``)."""
    a = np.asarray(ids, dtype=np.int64)
    lo = (a & np.int64(_M32)).astype(np.uint32).astype(np.int32)
    hi = (a >> np.int64(32)).astype(np.int32)
    return hi, lo


def hash32_np(ids: np.ndarray, seed: int = 0) -> np.ndarray:
    """Numpy mirror of :func:`hash32` over int64 ids (host-side resharding
    at checkpoint restore must route keys exactly like the device does)."""
    a = np.asarray(ids, dtype=np.int64)
    lo = (a & np.int64(0xFFFFFFFF)).astype(np.uint32)
    hi = (a >> np.int64(32)).astype(np.int64).astype(np.uint32)
    with np.errstate(over="ignore"):
        h = lo ^ (hi * np.uint32(0x85EBCA6B)) ^ np.uint32((seed * 0x9E3779B9) & 0xFFFFFFFF)
        h ^= h >> np.uint32(16)
        h = h * np.uint32(0x85EBCA6B)
        h ^= h >> np.uint32(13)
        h = h * np.uint32(0xC2B2AE35)
        h ^= h >> np.uint32(16)
    return h


def to_numpy(keys: torch.Tensor) -> np.ndarray:
    """int64 key tensor (any device) -> int64 numpy."""
    return keys.detach().to("cpu", torch.int64).numpy()


def _planes(keys: torch.Tensor):
    """(hi, lo) as uint32 values held in int64."""
    return (keys >> 32) & _M32, keys & _M32


def hash32(keys: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """Murmur3-style finalizer mix of the two 32-bit halves -> uint32 hash
    (held in int64). Bit-equal to ``deeprec_tpu.sparse.keys.hash32``."""
    hi, lo = _planes(keys)
    h = lo ^ ((hi * 0x85EBCA6B) & _M32) ^ ((seed * 0x9E3779B9) & _M32)
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _M32
    return h ^ (h >> 16)


def random_uniform_bits(keys: torch.Tensor, salt: int,
                        n_cols: int) -> torch.Tensor:
    """Deterministic per-key random bits: ``keys.shape + (n_cols,)`` uint32
    values held in int64. Bit-equal to
    ``deeprec_tpu.sparse.keys.random_uniform_bits``."""
    hi, lo = _planes(keys)
    col = torch.arange(n_cols, dtype=torch.int64, device=keys.device)
    h = lo[..., None] ^ ((hi[..., None] * 0x9E3779B1) & _M32)
    h = h ^ ((col * 0x85EBCA77) & _M32) ^ (int(salt) & _M32)
    for c in (0xCC9E2D51, 0x1B873593, 0xE6546B64):
        h = h ^ (h >> 15)
        h = (h * c) & _M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE3D) & _M32
    return h ^ (h >> 16)
