"""EmbeddingVariable state: a hash index plus flat row stores.

Port of ``deeprec_tpu/sparse/embedding_var.py``: :class:`EVState` (its
last field ``cbf``, the counting-Bloom counters, defaults to None so a
state without them builds as before), :class:`LookupAux`, :func:`create`,
the key-deterministic :func:`init_rows`, the device-index
:func:`lookup_or_create` / :func:`lookup_or_create_unique` (dedup ->
CBF-gated insert -> eager init where the table filters -> metadata writes
and admission), the training gather :func:`gather`, :func:`lookup_dense`,
:func:`pooled_lookup`, :func:`pooled_lookup_multi_dim`, :func:`shrink`,
:func:`grow`, :func:`permute_rows`, :func:`load_factor`, the host eviction
predicate :func:`cold_mask_np` (save-time eviction and tier demotion), the
HBM-budget demotion :func:`budget_cold_np` (a verbatim copy), and
:class:`Snapshot` with :func:`export` / :func:`import_snapshot`. Row
``capacity`` of every store is the shared null row (zeros) that padding
and failed lookups read.

The metadata writes of a lookup (create step, version, frequency) and its
CounterFilter admission test are one launch of kernel K3a
(``ops.meta_scatter.lookup_meta``), as on the host-index engine; a table
in the light layout (no filter, no eviction) writes none. The hash probes
are kernels K4 and K5 on the card (``hashtable.lookup`` and
``lookup_or_insert_``), the JAX table's device loops; the CBF counters and
the row scatters are XLA ops in the JAX package and plain PyTorch here.
The stores and the index are updated in place (the JAX step donates its
state): a lookup-or-create writes its created keys into the index it is
given, so a caller keeps only the state it returns.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import (CBFFilter, EmbeddingVariableConfig, GlobalStepEvict,
                      L2WeightEvict)
from ..ops import segment
from ..ops.gather import gather_rows
from ..ops.meta_scatter import lookup_meta
from ..ops.unique import UniqueResult, unique
from . import hashtable as ht
from . import keys as K


class EVState(NamedTuple):
    index: ht.HashTable
    values: torch.Tensor        # [capacity+1, dim (+ fused slot columns)]
    freqs: torch.Tensor         # [capacity+1] int32 lookup counter
    versions: torch.Tensor      # [capacity+1] int32 step of last touch
    create_steps: torch.Tensor  # [capacity+1] int32 step of creation
    cbf: Optional[torch.Tensor] = None  # [m] int32 counting-Bloom counters

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
    cbf = None
    if config.cbf_filter is not None:
        cbf = torch.zeros((config.cbf_filter.num_counters(),), **i32)
    return EVState(
        index=ht.create(cap, device),
        values=torch.zeros((cap + 1, dim), dtype=_dtype(config.value_dtype),
                           device=device),
        freqs=torch.zeros((cap + 1,), **i32),
        versions=torch.full((cap + 1,), -1, **i32),
        create_steps=torch.full((cap + 1,), -1, **i32),
        cbf=cbf)


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


def _cbf_positions(cbf: CBFFilter, ukeys: torch.Tensor) -> torch.Tensor:
    """``[n, num_hashes]`` counter positions of each key."""
    m = cbf.num_counters() - 1  # power of two
    return torch.stack([K.hash32(ukeys, seed=h + 1) & m
                        for h in range(cbf.num_hashes)], -1)


def _cbf_bump_and_estimate(counters: torch.Tensor, cbf: CBFFilter,
                           ukeys: torch.Tensor, counts: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Add ``counts`` to each key's counters (in place); return
    ``(counters, estimate)``, the estimate being the post-bump minimum
    (count-min). EMPTY keys add nothing and estimate 0."""
    pos = _cbf_positions(cbf, ukeys)
    valid = ~K.is_empty(ukeys)
    add = torch.where(valid, counts, 0).to(counters.dtype)
    counters.index_add_(0, pos.reshape(-1),
                        add.repeat_interleave(cbf.num_hashes))
    est = counters[pos].amin(-1)
    return counters, torch.where(valid, est, 0)


def lookup_or_create(state: EVState, config: EmbeddingVariableConfig,
                     ids: torch.Tensor, global_step: int
                     ) -> Tuple[EVState, LookupAux]:
    """Dedup a flat int64 id batch (:func:`~..ops.unique.unique` at the
    table's ``max_unique``), then :func:`lookup_or_create_unique`."""
    return lookup_or_create_unique(state, config,
                                   unique(ids, config.max_unique),
                                   global_step)


def lookup_or_create_unique(state: EVState, config: EmbeddingVariableConfig,
                            uniq: UniqueResult, global_step: int,
                            freq_counts: Optional[torch.Tensor] = None
                            ) -> Tuple[EVState, LookupAux]:
    """Admit and insert deduplicated keys, initialise created rows where
    the table filters (or has ``lazy_init`` off), write the metadata and
    test admission. Returns the new state (stores and index updated in
    place) and the aux that :func:`gather` and the sparse optimizer read.

    Frequencies advance by each key's multiplicity in the batch (with a
    filter the reference passes unique_with_counts' counts to
    ``AddFreq``). With a CBF, keys whose post-bump estimate is below the
    filter's count never claim a slot: their counts live in the sketch.
    ``freq_counts`` (``[U]``) overrides the per-key increment: the owner
    of a sharded exchange passes the requesters' summed multiplicities
    there (its own dedup's counts would count requesting ranks, not id
    occurrences); they reach K3a as its counts."""
    from ..optim.sparse import _scatter_set  # it imports this module
    cap = state.capacity
    ukeys = uniq.ukeys
    counts = (uniq.counts if freq_counts is None else freq_counts
              ).to(torch.int32)

    cbf = state.cbf
    gated = ukeys
    if config.cbf_filter is not None:
        cbf, est = _cbf_bump_and_estimate(cbf, config.cbf_filter, ukeys,
                                          counts)
        gated = torch.where(est >= config.cbf_filter.filter_freq, ukeys,
                            K.EMPTY)
    index, slots, created = ht.lookup_or_insert_(state.index, gated,
                                                 config.max_probes)

    # created rows: filtered tables write their init now (a key not yet
    # admitted keeps serving its frozen init across steps); filter-less
    # ones leave it to gather (lazy init). cap + 1: dropped lanes
    dest = torch.where(created, slots, cap + 1)
    if config.filter_freq > 0 or not config.lazy_init:
        rows0 = init_rows(config, ukeys)
        if config.fused_slot_columns:
            pad = torch.full((rows0.shape[0], config.fused_slot_columns),
                             config.fused_slot_init, dtype=rows0.dtype,
                             device=rows0.device)
            rows0 = torch.cat([rows0, pad], -1)
        _scatter_set(state.values, dest, rows0)

    vt, ft = config.version_tracked, config.freq_tracked
    cf = config.counter_filter
    if vt or ft or cf is not None:
        # K3a: create steps, versions and frequencies at the live slots,
        # and the CounterFilter test, in one launch (the null row kept)
        admitted = lookup_meta(
            slots, counts, torch.zeros((1,), dtype=torch.bool,
                                       device=slots.device),
            dest, int(global_step), cap,
            create_steps=state.create_steps if vt else None,
            versions=state.versions if vt else None, freqs=state.freqs,
            add_freqs=ft,
            filter_freq=None if cf is None else cf.filter_freq)
    else:
        admitted = slots != cap
    return state._replace(index=index, cbf=cbf), LookupAux(
        uniq=uniq, slots=slots, admitted=admitted, created=created)


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


def lookup_dense(state: EVState, config: EmbeddingVariableConfig,
                 aux: LookupAux, batch_shape: Tuple[int, ...]
                 ) -> torch.Tensor:
    """``[batch..., dim]`` embeddings in the original (pre-dedup) layout."""
    rows = gather(state.values, aux, config)
    return rows[aux.uniq.inverse].reshape(*batch_shape, config.embedding_dim)


def pooled_lookup(values: torch.Tensor, aux: LookupAux,
                  config: EmbeddingVariableConfig, sample_ids: torch.Tensor,
                  num_samples: int, weights: Optional[torch.Tensor] = None,
                  combiner: Optional[str] = None) -> torch.Tensor:
    """``embedding_lookup_sparse``: unique -> gather -> segment combine.
    ``sample_ids[i]`` is the example of flat id ``i``; padding ids add
    zero rows (the null row)."""
    rows = gather(values, aux, config)[aux.uniq.inverse]
    return segment.segment_combine(rows, sample_ids, num_samples,
                                   combiner or config.combiner, weights)


def pooled_lookup_multi_dim(values: torch.Tensor, aux: LookupAux,
                            config: EmbeddingVariableConfig,
                            batch_shape: Tuple[int, ...],
                            combiners: Tuple[str, ...],
                            weights: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Multi-dimension sparse pooling (``embedding_lookup_sparse_multi_
    dim``): ids laid out ``[B, L1, ..., Lk]`` (EMPTY-padded) pool innermost
    first, one combiner per sparse dimension; padding contributes nothing
    and leaves the mean/sqrtn denominators at every level."""
    if len(combiners) != len(batch_shape) - 1:
        raise ValueError("one combiner per sparse dimension")
    rows = gather(values, aux, config)[aux.uniq.inverse]
    rows = rows.reshape(*batch_shape, config.embedding_dim)
    valid = (aux.slots != config.capacity)[aux.uniq.inverse]
    valid = valid.reshape(*batch_shape).to(rows.dtype)
    if weights is not None:
        rows = rows * weights.reshape(*batch_shape)[..., None]
    rows = rows * valid[..., None]
    for combiner in reversed(combiners):
        if combiner == "sum":
            rows = rows.sum(-2)
        elif combiner == "mean":
            denom = torch.clamp_min(valid.sum(-1), 1.0)
            rows = rows.sum(-2) / denom[..., None]
        elif combiner == "sqrtn":
            denom = torch.sqrt(torch.clamp_min(valid.sum(-1), 1.0))
            rows = rows.sum(-2) / denom[..., None]
        else:
            raise ValueError(f"unknown combiner {combiner!r}")
        valid = valid.amax(-1)  # a level is valid if any entry was
        rows = rows * valid[..., None]
    return rows


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


def _rebuilt(state: EVState, config: EmbeddingVariableConfig,
             keep: torch.Tensor, new_cap: int) -> Tuple[EVState, torch.Tensor]:
    index, old_to_new = ht.rebuild(state.index, keep, new_cap,
                                   config.max_probes)
    return EVState(
        index=index,
        values=permute_rows(state.values, old_to_new, new_cap),
        freqs=permute_rows(state.freqs, old_to_new, new_cap),
        versions=permute_rows(state.versions, old_to_new, new_cap, -1),
        create_steps=permute_rows(state.create_steps, old_to_new, new_cap,
                                  -1),
        cbf=state.cbf), old_to_new


def shrink(state: EVState, config: EmbeddingVariableConfig,
           global_step: int, new_capacity: Optional[int] = None,
           keep_mask: Optional[torch.Tensor] = None
           ) -> Tuple[EVState, torch.Tensor]:
    """Apply the eviction policy and rebuild the index. Returns ``(state,
    old_to_new)``; carry optimizer slot rows along with
    ``optim.sparse.permute_slot_state``. ``keep_mask`` (``[capacity]``
    bool) replaces the policy predicate when given (the tiered trainer's
    policy + budget selection, which must match the rows it exported).
    Vacated slots are zero-filled, so a reused slot reads no stale row."""
    cap = state.capacity
    keep = ht.occupied_mask(state.index)
    if keep_mask is not None:
        keep = keep & keep_mask
    else:
        pol = config.evict
        if isinstance(pol, GlobalStepEvict) and pol.steps_to_live > 0:
            keep = keep & (int(global_step) - state.versions[:cap]
                           < pol.steps_to_live)
        elif isinstance(pol, L2WeightEvict) and pol.l2_weight_threshold > 0:
            vals = state.values[:cap, :config.embedding_dim]
            keep = keep & ((vals * vals).sum(-1) >= pol.l2_weight_threshold)
    return _rebuilt(state, config, keep, new_capacity or cap)


def grow(state: EVState, config: EmbeddingVariableConfig, new_capacity: int
         ) -> Tuple[EVState, torch.Tensor]:
    """Rebuild every live key into a table of ``new_capacity`` slots."""
    keep = torch.ones((state.capacity,), dtype=torch.bool,
                      device=state.values.device)
    return _rebuilt(state, config, keep, new_capacity)


def load_factor(state: EVState) -> torch.Tensor:
    return state.index.size.sum().float() / state.capacity


class Snapshot(NamedTuple):
    """Dense export of a table, the checkpoint unit: the reference's
    4-tensor EV bundle {keys, values, versions, freqs} and a live mask.
    (The JAX package splits ``keys`` into its hi and lo planes.)"""

    keys: torch.Tensor      # [capacity] int64, EMPTY where free
    values: torch.Tensor
    versions: torch.Tensor
    freqs: torch.Tensor
    live: torch.Tensor      # [capacity] bool


def export(state: EVState) -> Snapshot:
    cap = state.capacity
    return Snapshot(keys=state.index.keys, values=state.values[:cap],
                    versions=state.versions[:cap], freqs=state.freqs[:cap],
                    live=ht.occupied_mask(state.index))


def import_snapshot(config: EmbeddingVariableConfig, keys: torch.Tensor,
                    values: torch.Tensor, versions: torch.Tensor,
                    freqs: torch.Tensor,
                    create_steps: Optional[torch.Tensor] = None) -> EVState:
    """A fresh state from dense key/value arrays on the keys' device (the
    restore path, ``KvResourceImportV2``); ``keys`` may be EMPTY-padded.
    ``create_steps`` defaults to ``versions``."""
    from ..optim.sparse import _scatter_set  # it imports this module
    state = create(config, keys.device)
    index, slots, _ = ht.lookup_or_insert_(state.index, keys,
                                           config.max_probes)
    cap = state.capacity
    live = ~K.is_empty(keys) & (slots != cap)
    dest = torch.where(live, slots, cap + 1)
    cs = create_steps if create_steps is not None else versions
    for store, rows in ((state.values, values), (state.freqs, freqs),
                        (state.versions, versions),
                        (state.create_steps, cs)):
        _scatter_set(store, dest, rows)
    return state._replace(index=index)
