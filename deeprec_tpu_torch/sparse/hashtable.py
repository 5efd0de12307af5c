"""Device-resident dynamic hash table: 64-bit key -> row slot.

Port of ``deeprec_tpu/sparse/hashtable.py``, same algorithm, same layout:
bucketed open addressing over windows of ``WINDOW`` consecutive slots, home
bucket ``hash32(key)``, an odd double-hashing stride ``hash32(key, 7) | 1``,
and a parallel insert whose contenders for one empty slot are arbitrated by
a scatter-min of their rank. Inserting the same keys in the same order
gives bit-equal slots and key planes to the JAX table
(``tests/test_torch_hashtable.py``). The key plane is one int64 tensor.

:func:`lookup` and :func:`lookup_or_insert_` dispatch on the device: a CPU
tensor runs the plain versions here (:func:`lookup_plain`,
:func:`lookup_or_insert_plain_`: Python loops over the JAX rounds, each
asking the host whether a key is left), a CUDA tensor launches the
hand-written kernels K4 and K5 (``ops/hash_probe.py``), which run the same
rounds on the card without a host round trip, as the JAX table's
device loops do; any other device raises.

An insert updates the table in place: :func:`lookup_or_insert_` writes the
created keys into ``table.keys`` and advances ``table.size`` and
``table.overflow``, as the JAX step, which donates its state, lets XLA
do; its callers give up the index they pass. :func:`lookup_or_insert` is
the functional form (a clone of the table, then the in-place insert) for
a caller that keeps its input.

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

from ..ops import hash_probe
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


def _device_type(table: HashTable, keys: torch.Tensor) -> str:
    """``"cpu"`` or ``"cuda"``, where the table and the keys both lie."""
    if keys.device != table.keys.device:
        raise ValueError(f"keys on {keys.device}, table on "
                         f"{table.keys.device}")
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"hash table: unsupported device {keys.device}")
    return keys.device.type


def lookup(table: HashTable, keys: torch.Tensor, max_probes: int = 32
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(slots, found)`` for a batch of keys; ``slots[i] == capacity`` (the
    null row) when not found. EMPTY keys are never found."""
    if _device_type(table, keys) == "cpu":
        return lookup_plain(table, keys, max_probes)
    return hash_probe.hash_lookup(table.keys, keys, max_probes)


def lookup_plain(table: HashTable, keys: torch.Tensor, max_probes: int = 32
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`lookup` (any device)."""
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


def clone(table: HashTable) -> HashTable:
    """A copy of ``table`` in new tensors."""
    return HashTable(*(t.clone() for t in table))


def lookup_or_insert_(table: HashTable, ukeys: torch.Tensor,
                      max_probes: int = 32
                      ) -> Tuple[HashTable, torch.Tensor, torch.Tensor]:
    """Find-or-claim slots for a batch of **deduplicated** keys, in place:
    the created keys are written into ``table.keys``, and ``table.size``
    and ``table.overflow`` advance by the created and the failed keys.
    EMPTY keys are padding and map to the null slot. Returns ``(table,
    slots, created)``, ``table`` the same tensors."""
    if _device_type(table, ukeys) == "cpu":
        return lookup_or_insert_plain_(table, ukeys, max_probes)
    slots, created = hash_probe.hash_lookup_or_insert_(
        table.keys, table.size, table.overflow, ukeys, max_probes)
    return table, slots, created


def lookup_or_insert(table: HashTable, ukeys: torch.Tensor,
                     max_probes: int = 32
                     ) -> Tuple[HashTable, torch.Tensor, torch.Tensor]:
    """:func:`lookup_or_insert_` into a clone of ``table``: returns
    ``(new table, slots, created)`` and leaves the input as it was."""
    return lookup_or_insert_(clone(table), ukeys, max_probes)


def lookup_or_insert_plain_(table: HashTable, ukeys: torch.Tensor,
                            max_probes: int = 32
                            ) -> Tuple[HashTable, torch.Tensor, torch.Tensor]:
    """The plain version of :func:`lookup_or_insert_` (any device), in
    place on the same tensors."""
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
    planes = table.keys.view(-1, w)
    rounds = 0
    # each key probes at most max_probes buckets; contention within a
    # bucket retries the same bucket, bounded by w extra rounds
    while rounds < max_probes + w and bool(pending.any()):
        b = (home + off * step) & bmask
        kw = planes[b]
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
        table.keys[target[win]] = ukeys[win]
        slots = torch.where(win, target, slots)
        pending &= ~win
        # losers of a bucket with an empty lane retry the same bucket;
        # keys whose bucket was full advance
        off = torch.where(pending & ~has_empty, off + 1, off)
        # past the probe bound a key can neither match nor claim
        pending &= off < max_probes
        rounds += 1

    created = (slots != cap) & ~found & ~invalid
    table.size.add_(created.sum())
    table.overflow.add_((~invalid & (slots == cap)).sum())
    return table, slots, created


def lookup_or_insert_plain(table: HashTable, ukeys: torch.Tensor,
                           max_probes: int = 32
                           ) -> Tuple[HashTable, torch.Tensor, torch.Tensor]:
    """The plain version of :func:`lookup_or_insert` (any device): the
    in-place plain insert into a clone of ``table``."""
    return lookup_or_insert_plain_(clone(table), ukeys, max_probes)


def occupied_mask(table: HashTable) -> torch.Tensor:
    """``[capacity]`` bool: the slots holding a key."""
    return ~K.is_empty(table.keys)


def rebuild(table: HashTable, keep: torch.Tensor,
            new_capacity: Optional[int] = None, max_probes: int = 32
            ) -> Tuple[HashTable, torch.Tensor]:
    """Rebuild keeping the slots where ``keep`` is True (growth; eviction).
    Returns ``(new_table, old_to_new)``: dropped and empty slots map to
    ``new_capacity + 1``, out of bounds even of the ``[new_cap+1]`` row
    stores."""
    new_cap = new_capacity or table.capacity
    live = occupied_mask(table) & keep
    kkeys = torch.where(live, table.keys, K.EMPTY)
    fresh, new_slots, _ = lookup_or_insert_(
        create(new_cap, table.keys.device), kkeys, max_probes)
    return fresh, torch.where(live, new_slots, new_cap + 1)
