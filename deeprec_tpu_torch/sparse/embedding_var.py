"""EmbeddingVariable state: a hash index plus flat row stores.

Port of part of ``deeprec_tpu/sparse/embedding_var.py``: :class:`EVState`,
:class:`LookupAux`, :func:`create`, the key-deterministic :func:`init_rows`,
:func:`grow` and the training gather :func:`gather`. Row ``capacity`` of
every store is the shared null row (zeros) that padding and failed lookups
read.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from ..config import EmbeddingVariableConfig
from ..ops.gather import gather_rows
from ..ops.unique import UniqueResult
from . import hashtable as ht
from . import keys as K


class EVState(NamedTuple):
    index: ht.HashTable
    values: torch.Tensor        # [capacity+1, dim (+ fused slot columns)]
    freqs: torch.Tensor         # [capacity+1] int32 lookup counter
    versions: torch.Tensor      # [capacity+1] int32 step of last touch
    create_steps: torch.Tensor  # [capacity+1] int32 step of creation

    @property
    def capacity(self) -> int:
        return self.values.shape[0] - 1


class LookupAux(NamedTuple):
    """What the pooling needs to know about one lookup."""

    uniq: UniqueResult
    slots: torch.Tensor     # [U] slot per unique key (capacity = null row)
    admitted: torch.Tensor  # [U] bool
    created: torch.Tensor   # [U] bool


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def create(config: EmbeddingVariableConfig, device="cuda") -> EVState:
    cap = config.capacity
    dim = config.embedding_dim + config.fused_slot_columns
    i32 = dict(dtype=torch.int32, device=device)
    return EVState(
        index=ht.create(cap, device),
        values=torch.zeros((cap + 1, dim), dtype=_dtype(config.value_dtype),
                           device=device),
        freqs=torch.zeros((cap + 1,), **i32),
        versions=torch.full((cap + 1,), -1, **i32),
        create_steps=torch.full((cap + 1,), -1, **i32))


def init_rows(config: EmbeddingVariableConfig,
              ukeys: torch.Tensor) -> torch.Tensor:
    """Initial value of each key's row, ``[n, embedding_dim]``,
    deterministic in the key (the EV default-value semantics). Uniform
    draws are bit-equal to the JAX package; normal draws (Box-Muller on the
    same bits) agree to the last ulps of ``log``/``cos``."""
    ini = config.initializer
    n = ukeys.shape[0]
    dim = config.embedding_dim
    out = dict(dtype=_dtype(config.value_dtype), device=ukeys.device)
    if ini.kind == "zeros":
        return torch.zeros((n, dim), **out)
    if ini.kind == "constant":
        return torch.full((n, dim), ini.constant, **out)
    scale = 1.0 / (1 << 24)
    bits = K.random_uniform_bits(ukeys, ini.seed, dim)
    u01 = (bits >> 8).to(torch.float32) * scale
    if ini.kind == "uniform":
        return ((u01 * 2.0 - 1.0) * ini.scale).to(out["dtype"])
    if ini.kind not in ("normal", "truncated_normal"):
        raise ValueError(f"unknown initializer {ini.kind!r}")
    bits2 = K.random_uniform_bits(ukeys, ini.seed + 0x5BD1, dim)
    v01 = (bits2 >> 8).to(torch.float32) * scale
    r = torch.sqrt(-2.0 * torch.log(torch.clamp_min(u01, 1e-12)))
    z = r * torch.cos(2.0 * math.pi * v01)
    if ini.kind == "truncated_normal":
        z = torch.clamp(z, -2.0, 2.0)
    return (z * ini.scale).to(out["dtype"])


def gather(values: torch.Tensor, aux: LookupAux,
           config: EmbeddingVariableConfig) -> torch.Tensor:
    """Embedding rows of the unique keys, ``[U, embedding_dim]``: the
    training step's differentiable leaf (its caller marks it so).

    The rows come through kernel K1, which reads only the first
    ``embedding_dim`` columns of a fused-width table. Filter-less tables
    use lazy init: a row created this step still holds zeros in the store,
    so its deterministic init is added here on ``created`` lanes, and the
    optimizer's write-back persists init + update in one scatter.
    """
    rows = gather_rows(values, aux.slots, config.embedding_dim)
    if config.filter_freq > 0 or not config.lazy_init:
        return rows
    init = init_rows(config, aux.uniq.ukeys).to(rows.dtype)
    return rows + torch.where(aux.created[:, None], init, 0.0)


def permute_rows(rows: torch.Tensor, old_to_new: torch.Tensor,
                 new_cap: int, fill=0) -> torch.Tensor:
    """Move per-slot rows ``[old_cap+1, ...]`` through a rebuild
    permutation into ``[new_cap+1, ...]``; dropped slots map to
    ``new_cap + 1``, a trash row cut off here."""
    out = torch.full((new_cap + 2,) + tuple(rows.shape[1:]), fill,
                     dtype=rows.dtype, device=rows.device)
    out[old_to_new] = rows[:-1]
    return out[:new_cap + 1]


def grow(state: EVState, config: EmbeddingVariableConfig, new_capacity: int
         ) -> Tuple[EVState, torch.Tensor]:
    """Rebuild every live key into a table of ``new_capacity`` slots."""
    keep = torch.ones((state.capacity,), dtype=torch.bool,
                      device=state.values.device)
    index, old_to_new = ht.rebuild(state.index, keep, new_capacity,
                                   config.max_probes)
    return EVState(
        index=index,
        values=permute_rows(state.values, old_to_new, new_capacity),
        freqs=permute_rows(state.freqs, old_to_new, new_capacity),
        versions=permute_rows(state.versions, old_to_new, new_capacity, -1),
        create_steps=permute_rows(state.create_steps, old_to_new,
                                  new_capacity, -1)), old_to_new
