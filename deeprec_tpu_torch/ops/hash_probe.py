"""Kernels K4 and K5: the hash index's probe loops on the card.

``hash_lookup`` (K4) and ``hash_lookup_or_insert_`` (K5) launch
``csrc/hash_table.cu`` for ``sparse/hashtable.py``'s ``lookup`` and
``lookup_or_insert_`` on CUDA tensors. They have no Pallas counterpart:
the JAX package runs both loops as device loops
(``deeprec_tpu/sparse/hashtable.py:147,231``), and so do these kernels, so
no step, eval or predict waits on the host inside the hash table. Their
plain versions are ``hashtable.lookup_plain`` and
``hashtable.lookup_or_insert_plain_`` (the Python loops they replace, bit
for bit); ``hashtable.lookup`` and ``lookup_or_insert_`` take those for a
CPU tensor and these wrappers for a CUDA one. Each wrapper allocates its
outputs and scratch, launches one kernel on the current stream and never
synchronises; a build or launch failure raises.

K5 writes the key plane, ``size`` and ``overflow`` in place. Its
arbitration words (one a slot) come from :func:`arbitration_words`: one
buffer per device, capacity and stream, zeroed once when it is made; the
kernel leaves it all zero again, so no call zeroes it.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import _build

_COUNT_WORDS = 8  # after the [cap] words: the kernel's counts (5), padding

_ARB: Dict[Tuple[torch.device, int, int], torch.Tensor] = {}


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


def arbitration_words(device: torch.device, cap: int) -> torch.Tensor:
    """K5's arbitration words for a ``cap``-slot plane on ``device`` and
    its current stream: int32 ``[cap + 8]``, zeroed when first made, all
    zero between calls. Two inserts in flight on different streams never
    share one."""
    stream = torch.cuda.current_stream(device)
    key = (device, cap, stream.cuda_stream)
    words = _ARB.get(key)
    if words is None:
        with torch.cuda.stream(stream):
            words = torch.zeros((cap + _COUNT_WORDS,), dtype=torch.int32,
                                device=device)
        _ARB[key] = words
    return words


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


def hash_lookup_or_insert_(plane: torch.Tensor, size: torch.Tensor,
                           overflow: torch.Tensor, ukeys: torch.Tensor,
                           max_probes: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5: find-or-claim slots for deduplicated ``ukeys``, as
    ``hashtable.lookup_or_insert_plain_`` does, in place: the created keys
    are written into ``plane``, and ``size`` and ``overflow`` advance by
    the created and the failed keys. Returns int64 ``slots`` and bool
    ``created``."""
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
    if n == 0:  # nothing to launch
        return slots, created
    # per key: its state word and claimed slot (the kernel sets them)
    scratch = torch.empty((2 * n,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        arb = arbitration_words(dev, cap)
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.library().deeprec_hash_lookup_or_insert(
            plane.data_ptr(), cap, ukeys.data_ptr(), n, max_probes,
            size.data_ptr(), overflow.data_ptr(), slots.data_ptr(),
            created.data_ptr(), scratch.data_ptr(), arb.data_ptr(), stream)
    _build.check(err, "hash_lookup_or_insert_")
    hash_lookup_or_insert_.launches += 1
    return slots, created


#: kernel launches, read by the card smoke
hash_lookup.launches = 0
hash_lookup_or_insert_.launches = 0
