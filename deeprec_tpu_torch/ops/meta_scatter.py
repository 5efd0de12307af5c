"""Kernels K3a and K3b: metadata writes at unique slots of int32 planes.

``meta_scatter`` (K3a) fuses the three metadata writes of a host-index
``lookup_or_create`` into one in-place launch::

    create_steps[dest[i]] = gs
    versions[mdest[i]] = gs
    freqs[mdest[i]] += counts[i]

skipping every lane whose index lies outside ``[0, cap)``, where ``cap`` is
the planes' null row (their last element), so the null row keeps its
fill. Any plane may be None. ``scatter_set(plane, slots, val)`` is the same
kernel with one plane: K3a's own function, one scalar to a plane at U
slots. It replaces the Pallas TPU kernel ``benchmarks/pallas_meta_bench.py``
``pallas_dma_stores``.

``blocked_rmw_set`` (K3b) is ``out = plane[:cap]`` with ``out[slots[i]] =
vals[i]`` for ``0 <= slots[i] < cap``, computed out of place by two
kernels: one streams the plane to ``out``, and its programmatic dependent
stores the updates once the copy has landed. It replaces
``pallas_blocked_rmw`` of the same script and is not on the training path.

On a CUDA tensor each wrapper launches ``csrc/meta_scatter.cu`` (bound by
HBM bytes; see the source note); on a CPU tensor it runs its plain PyTorch
version, which the tests and the card smoke compare the kernel with. The
indices below ``cap`` must be unique, as a resolver's slots are: the
kernel writes them without atomics.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build

_IDX = (torch.int32, torch.int64)


def meta_scatter_plain(create_steps: Optional[torch.Tensor],
                       dest: torch.Tensor, versions: Optional[torch.Tensor],
                       freqs: Optional[torch.Tensor], mdest: torch.Tensor,
                       counts: Optional[torch.Tensor], gs: int, cap: int
                       ) -> None:
    if create_steps is not None:
        keep = (dest >= 0) & (dest < cap)
        create_steps.index_put_((dest[keep].long(),),
                                torch.tensor(gs, dtype=torch.int32,
                                             device=dest.device))
    if versions is not None or freqs is not None:
        keep = (mdest >= 0) & (mdest < cap)
        idx = mdest[keep].long()
        if versions is not None:
            versions.index_put_((idx,), torch.tensor(
                gs, dtype=torch.int32, device=mdest.device))
        if freqs is not None:
            freqs.index_add_(0, idx, counts[keep])


def _plane(p: Optional[torch.Tensor], n: int, dev) -> None:
    if p is None:
        return
    if p.dtype != torch.int32 or p.dim() != 1 or not p.is_contiguous():
        raise ValueError("metadata planes must be contiguous 1-D int32")
    if p.shape[0] != n or p.device != dev:
        raise ValueError("metadata planes differ in length or device")


def meta_scatter(create_steps: Optional[torch.Tensor], dest: torch.Tensor,
                 versions: Optional[torch.Tensor],
                 freqs: Optional[torch.Tensor], mdest: torch.Tensor,
                 counts: Optional[torch.Tensor], gs: int) -> None:
    """In-place fused metadata writes (see the module docstring)."""
    planes = [p for p in (create_steps, versions, freqs) if p is not None]
    if not planes:
        return
    n_rows, dev = planes[0].shape[0], planes[0].device
    for p in (create_steps, versions, freqs):
        _plane(p, n_rows, dev)
    if dest.dtype not in _IDX or mdest.dtype != dest.dtype or \
            dest.shape != mdest.shape or dest.dim() != 1:
        raise ValueError("dest and mdest must be 1-D int32/int64 of one "
                         "shape and dtype")
    if freqs is not None and (counts is None or counts.dtype != torch.int32
                              or counts.shape != mdest.shape):
        raise ValueError("freqs needs int32 counts shaped like mdest")
    if not dest.device == mdest.device == dev or \
            (counts is not None and counts.device != dev):
        raise ValueError("indices and planes are on different devices")
    cap = n_rows - 1
    if dev.type == "cpu":
        meta_scatter_plain(create_steps, dest, versions, freqs, mdest,
                           counts, gs, cap)
        return
    if dev.type != "cuda":
        raise ValueError(f"meta_scatter: unsupported device {dev}")
    dest, mdest = dest.contiguous(), mdest.contiguous()
    counts = counts.contiguous() if freqs is not None else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.library().deeprec_meta_scatter(
            ptr(create_steps), dest.data_ptr(), ptr(versions), ptr(freqs),
            mdest.data_ptr(), ptr(counts), int(dest.dtype == torch.int64),
            int(gs), dest.shape[0], cap, stream)
    _build.check(err, "meta_scatter")
    meta_scatter.launches += 1


def scatter_set(plane: torch.Tensor, slots: torch.Tensor, val: int) -> None:
    """``plane[slots[i]] = val`` in place for ``0 <= slots[i] < cap``
    (``cap = len(plane) - 1``, the null row): K3a's own function."""
    meta_scatter(None, slots, plane, None, slots, None, val)


def blocked_rmw_set_plain(plane: torch.Tensor, slots: torch.Tensor,
                          vals: torch.Tensor, cap: int) -> torch.Tensor:
    out = plane[:cap].clone()
    keep = (slots >= 0) & (slots < cap)
    out.index_put_((slots[keep].long(),), vals[keep])
    return out


def blocked_rmw_set(plane: torch.Tensor, slots: torch.Tensor,
                    vals: torch.Tensor, cap: int) -> torch.Tensor:
    """``[cap]`` copy of ``plane[:cap]`` with ``vals`` set at the in-range
    ``slots`` (K3b's function, out of place)."""
    if plane.dtype != torch.int32 or plane.dim() != 1 or \
            not 0 <= cap <= plane.shape[0]:
        raise ValueError("plane must be 1-D int32 with at least cap rows")
    if slots.dtype not in _IDX or slots.dim() != 1 or \
            vals.dtype != torch.int32 or vals.shape != slots.shape:
        raise ValueError("slots must be 1-D int32/int64 and vals int32 of "
                         "the same shape")
    if not plane.device == slots.device == vals.device:
        raise ValueError("plane, slots and vals are on different devices")
    if plane.device.type == "cpu":
        return blocked_rmw_set_plain(plane, slots, vals, cap)
    if plane.device.type != "cuda":
        raise ValueError(f"blocked_rmw_set: unsupported device "
                         f"{plane.device}")
    plane, slots, vals = plane.contiguous(), slots.contiguous(), \
        vals.contiguous()
    out = torch.empty((cap,), dtype=torch.int32, device=plane.device)
    vec4 = int(plane.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    with torch.cuda.device(plane.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.library().deeprec_blocked_rmw_set(
            plane.data_ptr(), slots.data_ptr(),
            int(slots.dtype == torch.int64), vals.data_ptr(), slots.shape[0],
            cap, out.data_ptr(), vec4, stream)
    _build.check(err, "blocked_rmw_set")
    blocked_rmw_set.launches += 1
    return out


#: kernel launches (CUDA path only), read by the card smoke
meta_scatter.launches = 0
blocked_rmw_set.launches = 0
