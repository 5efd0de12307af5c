"""EmbeddingVariable state: a hash index plus flat row stores.

Port of part of ``deeprec_tpu/sparse/embedding_var.py``: :class:`EVState`,
:class:`LookupAux`, :func:`create`, the key-deterministic :func:`init_rows`,
:func:`grow`, :func:`permute_rows`, the host eviction predicate
:func:`cold_mask_np` (save-time eviction and tier demotion), the HBM-budget
demotion :func:`budget_cold_np` (a verbatim copy) and the training gather
:func:`gather`. Row ``capacity`` of
every store is the shared null row (zeros) that padding and failed lookups
read.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..config import EmbeddingVariableConfig, GlobalStepEvict, L2WeightEvict
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


def cold_mask_np(config: EmbeddingVariableConfig, values_np, versions_np,
                 occupied_np, global_step: int) -> np.ndarray:
    """The host-side eviction predicate over ``[n]`` rows (numpy): rows
    untouched for ``steps_to_live`` steps, or whose squared L2 norm over
    the first ``embedding_dim`` columns is under the threshold. The one
    definition the checkpoint saver applies at save time (JAX
    ``embedding_var.py`` ``cold_mask_np``)."""
    pol = config.evict
    n = occupied_np.shape[0]
    cold = np.zeros((n,), bool)
    if isinstance(pol, GlobalStepEvict) and pol.steps_to_live > 0:
        cold = occupied_np & (global_step - versions_np[:n]
                              >= pol.steps_to_live)
    elif isinstance(pol, L2WeightEvict) and pol.l2_weight_threshold > 0:
        v = np.asarray(values_np[:n, :config.embedding_dim], np.float64)
        cold = occupied_np & (np.sum(v * v, -1) < pol.l2_weight_threshold)
    return cold


def budget_cold_np(config: EmbeddingVariableConfig, versions_np, freqs_np,
                   occupied_np, policy_cold_np, hbm_budget: int):
    """HBM-budget pressure demotion on top of the policy predicate: if
    more than ``hbm_budget`` rows would stay resident, the least-recently
    -touched of them (version ascending, freq as the tiebreak — the
    reference's BatchCache LRU over ValuePtrs, embedding/cache.h) are
    forced cold too. Returns the combined cold mask."""
    import numpy as _np
    if hbm_budget <= 0:
        return policy_cold_np
    live = occupied_np & ~policy_cold_np
    excess = int(live.sum()) - int(hbm_budget)
    if excess <= 0:
        return policy_cold_np
    idx = _np.nonzero(live)[0]
    cap = occupied_np.shape[0]
    order = _np.lexsort((freqs_np[:cap][idx], versions_np[:cap][idx]))
    out = policy_cold_np.copy()
    out[idx[order[:excess]]] = True
    return out


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
