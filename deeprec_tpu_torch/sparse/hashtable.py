"""Device-resident dynamic hash table: 64-bit key -> row slot.

Port of ``deeprec_tpu/sparse/hashtable.py``, same algorithm, same layout:
bucketed open addressing over windows of ``WINDOW`` consecutive slots, home
bucket ``hash32(key)``, an odd double-hashing stride ``hash32(key, 7) | 1``,
and a parallel insert whose contenders for one empty slot are arbitrated by
a scatter-min of their rank. Inserting the same keys in the same order
gives bit-equal slots and key planes to the JAX table
(``tests/test_torch_hashtable.py``). The key plane is one int64 tensor.

Invariants (as in the JAX table): capacity is a power of two; an insert
fills the earliest bucket in probe order with an empty slot, so a bucket
with an empty slot and no match proves absence; every stored key lives
within ``max_probes`` buckets of home; EMPTY (-1) cannot be stored; there
are no tombstones, deletion is :func:`rebuild`. Slot ``capacity`` is the
shared null row of the row stores: failed lookups, padding and overflow.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from . import keys as K

WINDOW = 16
_RANK_MAX = torch.iinfo(torch.int64).max


class HashTable(NamedTuple):
    keys: torch.Tensor      # int64 [capacity], EMPTY where free
    size: torch.Tensor      # int64 [1]: occupied slots
    overflow: torch.Tensor  # int64 [1]: cumulative failed inserts

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]


def create(capacity: int, device="cuda") -> HashTable:
    if capacity & (capacity - 1):
        raise ValueError(f"capacity must be a power of two, got {capacity}")
    return HashTable(
        keys=torch.full((capacity,), K.EMPTY, dtype=torch.int64,
                        device=device),
        size=torch.zeros((1,), dtype=torch.int64, device=device),
        overflow=torch.zeros((1,), dtype=torch.int64, device=device))


def _geometry(keys: torch.Tensor, cap: int):
    """(window, bucket mask, home bucket, odd bucket stride)."""
    w = min(WINDOW, cap)
    bmask = cap // w - 1
    home = K.hash32(keys) & bmask
    step = (K.hash32(keys, seed=7) | 1) & bmask
    return w, bmask, home, step


def lookup(table: HashTable, keys: torch.Tensor, max_probes: int = 32
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(slots, found)`` for a batch of keys; ``slots[i] == capacity`` (the
    null row) when not found. EMPTY keys are never found."""
    cap = table.capacity
    w, bmask, home, step = _geometry(keys, cap)
    planes = table.keys.view(-1, w)
    lane = torch.arange(w, device=keys.device)
    slots = torch.full_like(keys, cap)
    found = torch.zeros_like(keys, dtype=torch.bool)
    done = K.is_empty(keys)
    for i in range(max_probes):
        if bool(done.all()):
            break
        b = (home + i * step) & bmask
        kw = planes[b]                                  # [n, w]
        match = (kw == keys[:, None]) & ~done[:, None]
        hit = match.any(-1)
        lane_idx = torch.where(match, lane, w).amin(-1)
        slots = torch.where(hit, b * w + lane_idx, slots)
        found |= hit
        # a bucket with an empty slot ends the probe sequence
        done = done | hit | K.is_empty(kw).any(-1)
    return slots, found


def lookup_or_insert(table: HashTable, ukeys: torch.Tensor,
                     max_probes: int = 32
                     ) -> Tuple[HashTable, torch.Tensor, torch.Tensor]:
    """Find-or-claim slots for a batch of **deduplicated** keys. EMPTY keys
    are padding and map to the null slot. Returns ``(table, slots,
    created)``; the input table is left as it was."""
    cap = table.capacity
    n = ukeys.shape[0]
    dev = ukeys.device
    w, bmask, home, step = _geometry(ukeys, cap)
    invalid = K.is_empty(ukeys)
    pending = ~invalid
    slots = torch.full_like(ukeys, cap)
    found = torch.zeros_like(pending)
    rank = torch.arange(n, device=dev)
    lane = torch.arange(w, device=dev)
    off = torch.zeros_like(ukeys)
    # working key plane with one trash slot at ``cap`` for losers' writes
    plane = torch.cat([table.keys,
                       torch.full((1,), K.EMPTY, dtype=torch.int64,
                                  device=dev)])
    rounds = 0
    # each key probes at most max_probes buckets; contention within a
    # bucket retries the same bucket, bounded by w extra rounds
    while rounds < max_probes + w and bool(pending.any()):
        b = (home + off * step) & bmask
        kw = plane[:cap].view(-1, w)[b]
        match = kw == ukeys[:, None]
        empty = K.is_empty(kw)
        # a hit can only be a pre-existing key (keys are deduplicated)
        hit = match.any(-1) & pending
        lane_m = torch.where(match, lane, w).amin(-1)
        slots = torch.where(hit, b * w + lane_m, slots)
        found |= hit
        pending &= ~hit

        # claim the first empty lane of the bucket; the lowest rank wins
        has_empty = empty.any(-1)
        lane_e = torch.where(empty, lane, w).amin(-1)
        want = pending & has_empty
        target = b * w + torch.where(has_empty, lane_e, 0)
        claim = torch.where(want, target, cap)
        arb = torch.full((cap + 1,), _RANK_MAX, dtype=torch.int64,
                         device=dev)
        arb.scatter_reduce_(0, claim, rank, "amin")
        win = want & (arb[target] == rank)
        plane[torch.where(win, target, cap)] = ukeys
        slots = torch.where(win, target, slots)
        pending &= ~win
        # losers of a bucket with an empty lane retry the same bucket;
        # keys whose bucket was full advance
        off = torch.where(pending & ~has_empty, off + 1, off)
        # past the probe bound a key can neither match nor claim
        pending &= off < max_probes
        rounds += 1

    created = (slots != cap) & ~found & ~invalid
    n_failed = (~invalid & (slots == cap)).sum()
    return HashTable(keys=plane[:cap],
                     size=table.size + created.sum(),
                     overflow=table.overflow + n_failed), slots, created


def rebuild(table: HashTable, keep: torch.Tensor,
            new_capacity: Optional[int] = None, max_probes: int = 32
            ) -> Tuple[HashTable, torch.Tensor]:
    """Rebuild keeping the slots where ``keep`` is True (growth; eviction).
    Returns ``(new_table, old_to_new)``: dropped and empty slots map to
    ``new_capacity + 1``, out of bounds even of the ``[new_cap+1]`` row
    stores."""
    new_cap = new_capacity or table.capacity
    live = ~K.is_empty(table.keys) & keep
    kkeys = torch.where(live, table.keys, K.EMPTY)
    fresh, new_slots, _ = lookup_or_insert(
        create(new_cap, table.keys.device), kkeys, max_probes)
    return fresh, torch.where(live, new_slots, new_cap + 1)
