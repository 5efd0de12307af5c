"""HashTable / TensibleVariable: the reference's second KV stack.

Port of ``deeprec_tpu/sparse/hash_table_api.py`` (PAI's ``HashTable``,
int64 key -> dense id, and ``TensibleVariable``, a growable row store
indexed by those ids; several stores can share one key space):

* :class:`HashTableState` wraps the device hash table and hands out dense
  ids in admission order (a monotone counter); the slot -> id map is one
  int32 plane. A counting-Bloom gate on allocation
  (``embedding_var._cbf_bump_and_estimate``) is the reference's
  BloomFilterAdmitStrategy.
* :class:`Tensible` is a ``[capacity+1, ...]`` row store indexed by id, its
  last row the null row; growth is a copy. Its row reads go through kernel
  K1 (``ops.gather``).

An insert updates the index in place (``hashtable.lookup_or_insert_``)
and returns a new id plane; the CBF counters and a Tensible's rows are
updated in place. A caller keeps only the state an insert returns.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..config import CBFFilter
from ..ops.gather import gather_rows
from ..ops.unique import unique
from . import embedding_var as ev_mod
from . import hashtable as ht
from . import keys as K


class HashTableState(NamedTuple):
    index: ht.HashTable             # key -> probe slot
    ids: torch.Tensor               # [capacity] int32: dense id (-1 empty)
    next_id: torch.Tensor           # int32 scalar: ids handed out so far
    cbf: Optional[torch.Tensor]     # admission counters or None


def create(capacity: int, admit: Optional[CBFFilter] = None,
           device="cuda") -> HashTableState:
    i32 = dict(dtype=torch.int32, device=device)
    cbf = None
    if admit is not None:
        cbf = torch.zeros((admit.num_counters(),), **i32)
    return HashTableState(index=ht.create(capacity, device),
                          ids=torch.full((capacity,), -1, **i32),
                          next_id=torch.zeros((), **i32), cbf=cbf)


def _set_ids(ids: torch.Tensor, slots: torch.Tensor, live: torch.Tensor,
             new_ids: torch.Tensor) -> torch.Tensor:
    """A new id plane: ``ids[slots[i]] = new_ids[i]`` where ``live``."""
    cap = ids.shape[0]
    out = torch.cat([ids, ids.new_full((1,), -1)])  # row cap: the trash
    out[torch.where(live, slots, cap)] = new_ids.to(ids.dtype)
    return out[:cap]


def gen_ids_unique(state: HashTableState, ukeys: torch.Tensor,
                   counts: torch.Tensor, admit: Optional[CBFFilter] = None,
                   max_probes: int = 32
                   ) -> Tuple[HashTableState, torch.Tensor, torch.Tensor]:
    """Id allocation over already-deduplicated int64 keys. With ``admit``
    the CBF counts each key's multiplicity ``counts`` and only keys whose
    estimate reaches ``filter_freq`` get a slot. New keys take ids in rank
    order. Returns ``(state, uids [U] int32, created [U])``; keys not
    admitted and padding get id -1."""
    cap = state.index.capacity
    cbf = state.cbf
    gated = ukeys
    if admit is not None and cbf is not None:
        cbf, est = ev_mod._cbf_bump_and_estimate(cbf, admit, ukeys,
                                                 counts.to(torch.int32))
        gated = torch.where(est >= admit.filter_freq, ukeys, K.EMPTY)
    index, slots, created = ht.lookup_or_insert_(state.index, gated,
                                                 max_probes)
    order = torch.cumsum(created, 0, dtype=torch.int32) - 1
    ids_plane = _set_ids(state.ids, slots, created, state.next_id + order)
    n_created = created.sum(dtype=torch.int32)
    uids = torch.where(slots < cap, ids_plane[slots.clamp(max=cap - 1)], -1)
    uids = torch.where(K.is_empty(ukeys), -1, uids)
    return HashTableState(index=index, ids=ids_plane,
                          next_id=state.next_id + n_created,
                          cbf=cbf), uids, created


def lookup_or_create(state: HashTableState, keys: torch.Tensor,
                     admit: Optional[CBFFilter] = None, max_probes: int = 32,
                     max_unique: Optional[int] = None
                     ) -> Tuple[HashTableState, torch.Tensor]:
    """Dense ids for a batch of int64 keys (``HashTableLookupOp`` with
    admission): new keys get fresh ids in allocation order, keys not
    admitted and padding -1. Returns ``(state, ids [n] int32)``."""
    uniq = unique(keys, max_unique)
    state, uids, _ = gen_ids_unique(state, uniq.ukeys, uniq.counts, admit,
                                    max_probes)
    return state, torch.where(K.is_empty(keys), -1, uids[uniq.inverse])


def reinsert(state: HashTableState, keys: torch.Tensor, max_probes: int = 32):
    """Restore-time re-insertion into a fresh state
    (``HashTableDirectRestoreOp``): keys go into the index and dense ids
    re-allocate compacted in scan order, so ``next_id`` (the count of live
    keys) never hands out an id a restored key owns. Returns ``(index,
    ids_plane, next_id, live, new_ids)``, ``index`` the state's, updated
    in place; callers write their rows at ``new_ids`` where ``live``."""
    cap = state.ids.shape[0]
    index, slots, _ = ht.lookup_or_insert_(state.index, keys, max_probes)
    live = ~K.is_empty(keys) & (slots != cap)
    new_ids = torch.where(live, torch.cumsum(live, 0, dtype=torch.int32) - 1,
                          -1)
    ids_plane = _set_ids(state.ids, slots, live, new_ids)
    return index, ids_plane, live.sum(dtype=torch.int32), live, new_ids


def lookup(state: HashTableState, keys: torch.Tensor,
           max_probes: int = 32) -> torch.Tensor:
    """Read-only id lookup; unknown keys -> -1."""
    cap = state.index.capacity
    slots, found = ht.lookup(state.index, keys, max_probes)
    return torch.where(found, state.ids[slots.clamp(max=cap - 1)], -1)


def size(state: HashTableState) -> torch.Tensor:
    return state.next_id


# ---------------------------------------------------------------------------
# TensibleVariable: rows indexed by dense id.


class Tensible(NamedTuple):
    """Growable row store (reference TensibleVariable, segments collapsed
    into one tensor + the null row at index ``capacity``)."""

    rows: torch.Tensor  # [capacity+1, ...]

    @property
    def capacity(self) -> int:
        return self.rows.shape[0] - 1


def tensible(capacity: int, shape: Tuple[int, ...], dtype=torch.float32,
             init=0.0, device="cuda") -> Tensible:
    return Tensible(rows=torch.full((capacity + 1,) + tuple(shape), init,
                                    dtype=dtype, device=device))


def _row_index(t: Tensible, ids: torch.Tensor, invalid: int) -> torch.Tensor:
    return torch.where((ids >= 0) & (ids < t.capacity), ids, invalid)


def gather(t: Tensible, ids: torch.Tensor) -> torch.Tensor:
    """``TensibleVariableGather``: id -1 (or out of range) reads the null
    row. Rows of one dimension come through K1."""
    idx = _row_index(t, ids, t.capacity)
    if t.rows.dim() == 2:
        return gather_rows(t.rows, idx)
    return t.rows[idx]


def scatter(t: Tensible, ids: torch.Tensor, rows: torch.Tensor,
            ids_unique: bool = True) -> Tensible:
    """``TensibleVariableScatter``, in place: rows with id -1 (or out of
    range) are dropped. ``ids_unique=False`` allows repeated ids (one of
    their rows lands, as with the JAX scatter)."""
    from ..optim.sparse import _scatter_set  # it imports embedding_var
    _scatter_set(t.rows, _row_index(t, ids, t.capacity + 1), rows)
    return t


def grow(t: Tensible, new_capacity: int, init=0.0) -> Tensible:
    """Segment-append growth (ids are stable, so growth is a plain copy)."""
    fresh = torch.full((new_capacity + 1,) + tuple(t.rows.shape[1:]), init,
                       dtype=t.rows.dtype, device=t.rows.device)
    fresh[:t.capacity] = t.rows[:-1]
    return Tensible(rows=fresh)


def apply_sparse(t: Tensible, opt, slot_state, ids: torch.Tensor,
                 grads: torch.Tensor, step: int) -> Tuple[Tensible, object]:
    """``TensibleVariableApply*``: the shared sparse optimizers update rows
    by dense id, in place. ``ids`` must be deduplicated (gradients
    pre-summed); id -1 is masked out."""
    mask = (ids >= 0) & (ids < t.capacity)
    slots = torch.where(mask, ids, t.capacity)
    _, slot_state = opt.apply(t.rows, slot_state, slots, grads, mask, step)
    return t, slot_state
