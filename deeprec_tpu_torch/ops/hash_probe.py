"""Kernels K4 and K5: the hash index's probe loops on the card.

``hash_lookup`` (K4) and ``hash_lookup_or_insert`` (K5) launch
``csrc/hash_table.cu`` for ``sparse/hashtable.py``'s ``lookup`` and
``lookup_or_insert`` on CUDA tensors. They have no Pallas counterpart: the
JAX package runs both loops as device loops
(``deeprec_tpu/sparse/hashtable.py:147,231``), and so do these kernels, so
no step, eval or predict waits on the host inside the hash table. Their
plain versions are ``hashtable.lookup_plain`` and
``hashtable.lookup_or_insert_plain`` (the Python loops they replace, bit
for bit); ``hashtable.lookup`` and ``lookup_or_insert`` take those for a
CPU tensor and these wrappers for a CUDA one. Each wrapper allocates its
outputs and scratch, launches one kernel on the current stream and never
synchronises; a build or launch failure raises.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import _build

WINDOW = 16  # sparse/hashtable.py's bucket width


def _check(plane: torch.Tensor, keys: torch.Tensor, max_probes: int) -> None:
    if plane.device.type != "cuda":
        raise ValueError(f"hash probe kernels need CUDA tensors, got "
                         f"{plane.device}")
    if keys.device != plane.device:
        raise ValueError("key plane and keys are on different devices")
    if plane.dim() != 1 or plane.dtype != torch.int64 \
            or not plane.is_contiguous():
        raise ValueError("the key plane must be a contiguous int64 vector")
    if keys.dim() != 1 or keys.dtype != torch.int64:
        raise ValueError("keys must be a 1-D int64 tensor")
    cap = plane.shape[0]
    if cap < 1 or cap & (cap - 1) or cap > 2 ** 31:
        raise ValueError(f"capacity {cap} is not a power of two <= 2^31")
    if keys.shape[0] >= 2 ** 31 or not 0 <= max_probes < 2 ** 30:
        raise ValueError("too many keys or probes for the kernels")


def hash_lookup(plane: torch.Tensor, keys: torch.Tensor, max_probes: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: ``(slots, found)`` of ``keys`` in the key plane, as
    ``hashtable.lookup_plain`` gives them (``slots`` int64, ``capacity``
    where not found)."""
    _check(plane, keys, max_probes)
    keys = keys.contiguous()
    n = keys.shape[0]
    slots = torch.empty((n,), dtype=torch.int64, device=keys.device)
    found = torch.empty((n,), dtype=torch.bool, device=keys.device)
    if n == 0:  # nothing to launch
        return slots, found
    with torch.cuda.device(plane.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.library().deeprec_hash_lookup(
            plane.data_ptr(), plane.shape[0], keys.data_ptr(), n,
            max_probes, slots.data_ptr(), found.data_ptr(), stream)
    _build.check(err, "hash_lookup")
    hash_lookup.launches += 1
    return slots, found


def hash_lookup_or_insert(plane: torch.Tensor, size: torch.Tensor,
                          overflow: torch.Tensor, ukeys: torch.Tensor,
                          max_probes: int):
    """K5: find-or-claim slots for deduplicated ``ukeys``, as
    ``hashtable.lookup_or_insert_plain`` does. Returns ``(plane, size,
    overflow, slots, created)``: a new key plane (the input stays as it
    was), ``size`` and ``overflow`` advanced by the created and the failed
    keys, int64 ``slots`` and bool ``created``."""
    _check(plane, ukeys, max_probes)
    for t in (size, overflow):
        if t.shape != (1,) or t.dtype != torch.int64 or \
                t.device != plane.device:
            raise ValueError("size and overflow must be int64 [1] beside "
                             "the plane")
    ukeys = ukeys.contiguous()
    n, cap, dev = ukeys.shape[0], plane.shape[0], plane.device
    slots = torch.empty((n,), dtype=torch.int64, device=dev)
    created = torch.empty((n,), dtype=torch.bool, device=dev)
    if n == 0:  # nothing to launch; the table as it was, in new tensors
        return plane.clone(), size.clone(), overflow.clone(), slots, created
    out = torch.empty_like(plane)
    new_size, new_overflow = torch.empty_like(size), torch.empty_like(size)
    # per key: state, probe offset, claimed slot; per slot: the claim's
    # arbitration word; per round: the keys left (the kernel fills it all)
    rounds = max_probes + min(WINDOW, cap)
    scratch = torch.empty((3 * n + cap + rounds,), dtype=torch.int32,
                          device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.library().deeprec_hash_lookup_or_insert(
            plane.data_ptr(), out.data_ptr(), cap, ukeys.data_ptr(), n,
            max_probes, size.data_ptr(), overflow.data_ptr(),
            new_size.data_ptr(), new_overflow.data_ptr(), slots.data_ptr(),
            created.data_ptr(), scratch.data_ptr(), stream)
    _build.check(err, "hash_lookup_or_insert")
    hash_lookup_or_insert.launches += 1
    return out, new_size, new_overflow, slots, created


#: kernel launches, read by the card smoke
hash_lookup.launches = 0
hash_lookup_or_insert.launches = 0
