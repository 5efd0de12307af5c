"""The table's key space and its key-deterministic initial rows, worked out
again in plain PyTorch.

A categorical id ``x`` of column ``c`` (0-based) is the key ``x ^ salt(c)``
(no salt for column 0), so coalesced columns never share a row. A key's
initial row is ``0.05 * z``, ``z`` a Box-Muller normal from two 32-bit
hashes of the key and the column of the row (DeepRec's embedding-variable
default value: a function of the key alone). These are the semantics the
configuration states (``Initializer("normal", scale=0.05)``, seed 0); the
arithmetic is written out here from that statement, so that nothing the
program makes reaches the reference.
"""
from __future__ import annotations

import math

import torch

_M32 = 0xFFFFFFFF


def salt_mask(column: int) -> int:
    """XOR mask of column ``column``: one word on the high half, one on the
    low."""
    hi = (column * 0x9E3779B1) & 0x7FFFFFFF
    lo = (column * 0x85EBCA77) & 0x7FFFFFFF
    return (hi << 32) | lo


def column_keys(column: int, ids: torch.Tensor) -> torch.Tensor:
    """int64 keys of column ``column``'s raw ids."""
    return ids if column == 0 else ids ^ salt_mask(column)


def _bits(keys: torch.Tensor, salt: int, n_cols: int) -> torch.Tensor:
    """``[n, n_cols]`` 32-bit hashes (held in int64) of each key and
    column index."""
    hi, lo = (keys >> 32) & _M32, keys & _M32
    col = torch.arange(n_cols, dtype=torch.int64, device=keys.device)
    h = lo[:, None] ^ ((hi[:, None] * 0x9E3779B1) & _M32)
    h = h ^ ((col * 0x85EBCA77) & _M32) ^ (salt & _M32)
    for c in (0xCC9E2D51, 0x1B873593, 0xE6546B64):
        h = h ^ (h >> 15)
        h = (h * c) & _M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE3D) & _M32
    return h ^ (h >> 16)


def initial_rows(keys: torch.Tensor, dim: int, scale: float = 0.05,
                 seed: int = 0) -> torch.Tensor:
    """``[n, dim]`` float32 initial rows of ``keys``."""
    unit = 1.0 / (1 << 24)
    u = (_bits(keys, seed, dim) >> 8).to(torch.float32) * unit
    v = (_bits(keys, seed + 0x5BD1, dim) >> 8).to(torch.float32) * unit
    r = torch.sqrt(-2.0 * torch.log(torch.clamp_min(u, 1e-12)))
    return r * torch.cos(2.0 * math.pi * v) * scale
