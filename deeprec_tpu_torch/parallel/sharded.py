"""Row-sharded embedding tables with an all-to-all id exchange.

Port of ``deeprec_tpu/parallel/sharded.py``. Each rank owns one row shard
of every table (owner = ``hash32(key, OWNER_SEED) % S``, the routing the
checkpoint restore uses too). A lookup: local dedup -> bucket the unique
ids by owner -> ``all_to_all`` (ids out, and their multiplicities when the
table counts frequencies) -> owner dedup and lookup-or-create (kernel K3a)
-> the owner gathers the rows (kernel K1) -> ``all_to_all`` (rows back) ->
the requester pools them per column through its local ``inverse``
(kernel K2).

The functions see one rank's view (its batch slice, its table shard) and
communicate only through the :class:`~.multihost.Axis`. The JAX engine
gets the gradient exchange from autodiff's transpose of the rows-back
``all_to_all``; here :class:`_RowsBack` is an autograd function whose
backward runs the reverse ``all_to_all`` of the cotangent in the same
wire dtype. Every rank calls every collective in the same order: there is
no early exit before an exchange.

Where the JAX code expands ``row_u[local_uniq.inverse]`` to one row per
flat id, the port pools ``row_u`` through ``inverse`` with K2 (the
collection's ``embeddings_from_rows``), and K2's backward gives the
unique-lane cotangent, as on one device. The JAX wire's hi/lo key planes
are a TPU format: the ids travel as one int64 plane.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..ops.segment import segment_sum
from ..ops.unique import UniqueResult, unique, unique_cols
from ..sparse import embedding_var as ev
from ..sparse import hashtable as ht
from ..sparse import keys as K
from .multihost import Axis

OWNER_SEED = 13


class ShardedAux(NamedTuple):
    """Routing and owner-side lookup state of one sharded exchange."""

    # requester side
    local_uniq: UniqueResult   # dedup of the local flat ids [N]
    owner: torch.Tensor        # [U] destination rank per local unique id
    pos: torch.Tensor          # [U] position within the send bucket
    routed: torch.Tensor       # [U] bool: made it into a bucket
    # owner side (this rank as server)
    recv_keys: torch.Tensor    # [S*C] ids received (flattened buckets)
    recv_uniq: UniqueResult    # dedup of the received ids
    recv_aux: ev.LookupAux     # owner-side lookup aux over recv_uniq.ukeys
    n_dropped: torch.Tensor    # int32: local unique ids over a bucket's cap


def _owner_of(keys: torch.Tensor, num_shards: int) -> torch.Tensor:
    """Destination rank: hash-mod (the seed decorrelates it from the
    in-shard probe hash). EMPTY keys go to the drop bucket
    ``num_shards``."""
    own = K.hash32(keys, seed=OWNER_SEED) % num_shards
    return torch.where(K.is_empty(keys), num_shards, own)


def owner_of_np(keys: np.ndarray, num_shards: int) -> np.ndarray:
    """:func:`_owner_of` of host keys: a restore routes each saved row to
    the rank that training sends its key to."""
    keys = torch.from_numpy(np.ascontiguousarray(keys, dtype=np.int64))
    return _owner_of(keys, num_shards).numpy()


def _bucket_positions(owner: torch.Tensor) -> torch.Tensor:
    """Rank of each element among the elements of its owner (its position
    in the send bucket), in original order: a stable sort of the owners
    and a run-start ``cummax``, the JAX package's
    ``lax.sort((owner, iota))`` positions exactly."""
    U = owner.shape[0]
    iota = torch.arange(U, device=owner.device)
    srt_owner, srt_idx = torch.sort(owner, stable=True)
    is_start = torch.ones(U, dtype=torch.bool, device=owner.device)
    is_start[1:] = srt_owner[1:] != srt_owner[:-1]
    run_start = torch.cummax(torch.where(is_start, iota, 0), 0).values
    out = torch.empty_like(iota)
    out[srt_idx] = iota - run_start  # a permutation: no collisions
    return out


def _dedup_local(coll, ids: torch.Tensor) -> UniqueResult:
    """Requester-side dedup: the per-column sort of a ``[W, B_local]``
    block when the collection's layout allows it, else the flat sort."""
    if ids.dim() == 2 and getattr(coll, "_column_dedup_ok", False):
        return unique_cols(ids, coll.config.max_unique)
    return unique(ids.reshape(-1), coll.config.max_unique)


def _route(uniq: UniqueResult, S: int, bucket_cap: int):
    """(owner, pos, routed, dest): each unique id's send lane ``dest``
    (``owner * C + pos``; ``S * C``, a dropped lane, when unrouted)."""
    owner = _owner_of(uniq.ukeys, S)
    pos = _bucket_positions(owner)
    routed = (owner < S) & (pos < bucket_cap)
    dest = torch.where(routed, owner * bucket_cap + pos, S * bucket_cap)
    return owner, pos, routed, dest


def _send(values: torch.Tensor, dest: torch.Tensor, n: int, fill):
    """``[n]`` (or ``[n, ...]``) lanes holding ``values`` at ``dest``, the
    rest ``fill``; lanes at ``n`` and past it are dropped."""
    out = torch.full((n + 1,) + tuple(values.shape[1:]), fill,
                     dtype=values.dtype, device=values.device)
    out[dest] = values
    return out[:n]


def exchange_lookup_or_create(coll, state: ev.EVState, ids: torch.Tensor,
                              step: int, axis: Axis, bucket_cap: int
                              ) -> Tuple[ev.EVState, ShardedAux]:
    """One rank's half of the sharded lookup-or-create. ``state`` is this
    rank's table shard, ``ids`` its ``[W, B_local]`` (or flat) id slice.
    ``bucket_cap`` is the per-destination bucket width; unique ids beyond
    it are dropped and counted in ``n_dropped``."""
    S = axis.size
    C = bucket_cap
    uniq = _dedup_local(coll, ids)
    owner, pos, routed, dest = _route(uniq, S, C)
    n_dropped = ((owner < S) & (pos >= C)).sum().to(torch.int32)

    send = _send(uniq.ukeys, dest, S * C, K.EMPTY)
    recv_keys = axis.all_to_all(send.view(S, C)).view(-1)
    recv_uniq = unique(recv_keys, coll.config.max_unique)
    # a table that counts frequencies gets the requesters' multiplicities
    # on a third exchange, so the owner counts id occurrences (the
    # reference's AddFreq(count)), not requesting ranks
    if coll.config.freq_tracked:
        send_counts = _send(uniq.counts.to(torch.int32), dest, S * C, 0)
        recv_counts = axis.all_to_all(send_counts.view(S, C)).view(-1)
        freq_counts = segment_sum(recv_counts, recv_uniq.inverse,
                                  recv_uniq.ukeys.shape[0])
    else:
        freq_counts = recv_uniq.counts.to(torch.int32)
    state, recv_aux = coll.sharded_owner_lookup(state, recv_uniq, step,
                                                freq_counts)
    return state, ShardedAux(
        local_uniq=uniq, owner=owner, pos=pos, routed=routed,
        recv_keys=recv_keys, recv_uniq=recv_uniq, recv_aux=recv_aux,
        n_dropped=n_dropped)


def gather_owner_rows(values: torch.Tensor, aux: ShardedAux,
                      config) -> torch.Tensor:
    """The owner's rows for every received lane, ``[S*C, dim]``: the
    differentiable leaf of the sharded lookup. K1 fetches the owner's
    unique rows (created rows read their lazy init)."""
    return ev.gather(values, aux.recv_aux, config)[aux.recv_uniq.inverse]


def _wire(x: torch.Tensor, wire_dtype) -> torch.Tensor:
    if wire_dtype is None:
        return x
    return x.to(getattr(torch, wire_dtype)
                if isinstance(wire_dtype, str) else wire_dtype)


class _RowsBack(torch.autograd.Function):
    """The rows-back ``all_to_all`` in ``wire_dtype``, cast back; its
    backward is the reverse ``all_to_all`` of the cotangent on the same
    wire (``all_to_all`` over axis 0 is its own transpose)."""

    @staticmethod
    def forward(ctx, rows, axis, wire_dtype):
        ctx.axis, ctx.wire_dtype = axis, wire_dtype
        S = axis.size
        back = axis.all_to_all(_wire(rows, wire_dtype).view(
            S, -1, rows.shape[-1]))
        return back.view(rows.shape).to(rows.dtype)

    @staticmethod
    def backward(ctx, g):
        S = ctx.axis.size
        back = ctx.axis.all_to_all(_wire(g, ctx.wire_dtype).view(
            S, -1, g.shape[-1]))
        return back.view(g.shape).to(g.dtype), None, None


def _unbucket(back: torch.Tensor, uniq: UniqueResult, owner, pos, routed,
              bucket_cap: int):
    """Local unique id ``i`` takes ``back[owner[i] * C + pos[i]]`` (zeros
    when unrouted). Returns ``(row_u [U, dim], valid_u [U])``."""
    u_idx = torch.where(routed, owner * bucket_cap + pos, 0)
    row_u = torch.where(routed[:, None], back[u_idx], 0.0)
    return row_u, routed & ~K.is_empty(uniq.ukeys)


def rows_back(urows_owner: torch.Tensor, aux: ShardedAux, axis: Axis,
              bucket_cap: int, wire_dtype=None):
    """Second ``all_to_all``: the owners return their rows and each
    requester unbuckets them. Returns ``(row_u [U, dim], valid_u [U])``
    over the local unique ids; pool them per column through
    ``aux.local_uniq.inverse``. Differentiable in ``urows_owner``."""
    back = _RowsBack.apply(urows_owner, axis, wire_dtype)
    return _unbucket(back, aux.local_uniq, aux.owner, aux.pos, aux.routed,
                     bucket_cap)


def apply_gradients_sharded(coll, state: ev.EVState, opt, slot_state,
                            aux: ShardedAux, d_urows_owner: torch.Tensor,
                            step: int):
    """Owner-side sparse apply: the cotangent arrives per received lane;
    sum it onto the owner's unique ids and apply (in place)."""
    n = aux.recv_uniq.ukeys.shape[0]
    grads_u = segment_sum(d_urows_owner, aux.recv_uniq.inverse, n)
    a = aux.recv_aux
    cur = ev.gather(state.values, a, coll.config)  # lazy-init rows
    _, slot_state = opt.apply(state.values, slot_state, a.slots, grads_u,
                              a.admitted, step, cur_rows=cur,
                              created=a.created)
    return state, slot_state


def exchange_lookup_readonly(coll, state: ev.EVState, ids: torch.Tensor,
                             axis: Axis, bucket_cap: int, wire_dtype=None):
    """The eval and serving exchange: nothing inserted, no metadata
    written; unknown keys read their deterministic init row. Returns
    ``(row_u [U, dim], inverse [N], valid_flat [N])`` over this rank's
    flat ids."""
    S = axis.size
    C = bucket_cap
    uniq = _dedup_local(coll, ids)
    owner, pos, routed, dest = _route(uniq, S, C)
    send = _send(uniq.ukeys, dest, S * C, K.EMPTY)
    recv_keys = axis.all_to_all(send.view(S, C)).view(-1)
    slots, found = ht.lookup(coll.table_index(state), recv_keys,
                             coll.config.max_probes)
    rows_r = coll.owner_readonly_rows(state, slots, found, recv_keys)
    back = _RowsBack.apply(rows_r, axis, wire_dtype)
    row_u, valid_u = _unbucket(back, uniq, owner, pos, routed, C)
    return row_u, uniq.inverse, valid_u[uniq.inverse]
