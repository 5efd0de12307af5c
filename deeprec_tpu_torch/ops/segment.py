"""Segment combiners for embedding pooling.

Port of ``deeprec_tpu/ops/segment.py``: ``segment_sum`` and
``segment_combine`` (the ``SparseSegment{Sum,Mean,SqrtN}`` combiners of
``embedding_lookup_sparse``). The JAX package lowers them to XLA
scatter-adds, not to a Pallas kernel, and XLA sums in an order that its
inputs fix. Segment ids outside ``[0, num_segments)`` are dropped, as
``jax.ops.segment_sum`` drops them; an empty segment is zero.

On the CPU, and for integer data anywhere (integer adds are exact in any
order), ``segment_sum`` is ``index_add_``. Float data on a CUDA tensor goes
through K2's backward, ``fused_pooled_lookup_backward`` with one lane a
row and ``sum``: ``index_add_`` there adds with float atomics, in an order
that changes from run to run, and the kernel adds each segment's rows in
an order the ids fix (in row order up to 32 rows a segment, as
``index_add_`` does on the CPU). A bfloat16 or float16 segment is summed
in float32 and rounded once; float64 on the card raises (the kernel has
no float64 sum). That path is a ``torch.autograd.Function``: the
cotangent of a row is its segment's, zero for a dropped id, a gather
(:func:`segment_sum_backward`), as ``jax.ops.segment_sum``'s transpose is.
"""
from __future__ import annotations

from typing import Optional

import torch

from .fused_lookup import fused_pooled_lookup_backward


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    keep = (segment_ids >= 0) & (segment_ids < num_segments)
    if data.is_cuda and data.is_floating_point():
        if data.dtype == torch.float64:
            raise ValueError("segment_sum on the card takes float32, "
                             "bfloat16 or float16 data, not float64")
        return _SegmentSum.apply(data, segment_ids, keep, num_segments)
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    # dropped lanes add zeros to segment 0: no host sync for a mask
    ids = torch.where(keep, segment_ids, 0).long()
    zero = torch.zeros((), dtype=data.dtype, device=data.device)
    mask = keep.reshape(keep.shape + (1,) * (data.dim() - 1))
    return out.index_add_(0, ids, torch.where(mask, data, zero))


def _ordered_segment_sum(data, segment_ids, keep, num_segments):
    """K2's backward with one lane a row and ``sum``; float16 summed in
    float32."""
    shape = (num_segments,) + tuple(data.shape[1:])
    if num_segments == 0 or data.numel() == 0:
        return torch.zeros(shape, dtype=data.dtype, device=data.device)
    ids = segment_ids.reshape(-1, 1)
    if ids.dtype not in (torch.int32, torch.int64):
        ids = ids.to(torch.int32)
    rows = data.reshape(data.shape[0], -1)
    if rows.dtype == torch.float16:
        rows = rows.float()
    out = fused_pooled_lookup_backward(rows, ids, keep.reshape(-1, 1), "sum",
                                       num_segments)
    return out.to(data.dtype).view(shape)


def segment_sum_backward(grad: torch.Tensor, segment_ids: torch.Tensor,
                         keep: torch.Tensor) -> torch.Tensor:
    """The cotangent of ``segment_sum``'s ``data`` given ``grad``
    (``[num_segments, ...]``): each row takes its segment's, a row whose
    id is dropped (``keep`` false) zero."""
    n = grad.shape[0]
    shape = tuple(segment_ids.shape) + tuple(grad.shape[1:])
    if n == 0:
        return torch.zeros(shape, dtype=grad.dtype, device=grad.device)
    rows = grad[segment_ids.clamp(0, n - 1).long()]
    mask = keep.reshape(keep.shape + (1,) * (grad.dim() - 1))
    return torch.where(mask, rows, torch.zeros((), dtype=grad.dtype,
                                               device=grad.device))


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, segment_ids, keep, num_segments):
        ctx.save_for_backward(segment_ids, keep)
        return _ordered_segment_sum(data, segment_ids, keep, num_segments)

    @staticmethod
    def backward(ctx, grad):
        segment_ids, keep = ctx.saved_tensors
        return segment_sum_backward(grad, segment_ids, keep), None, None, None


def segment_combine(data: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int, combiner: str = "mean",
                    weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pool rows into per-segment vectors.

    combiner: 'sum' | 'mean' | 'sqrtn'. ``weights`` multiplies rows before
    pooling and replaces counts in the mean/sqrtn denominators (the
    ``safe_embedding_lookup_sparse`` weighted semantics)."""
    if weights is not None:
        data = data * weights[..., None]
        denom_src = weights
    else:
        denom_src = torch.ones(data.shape[:1], dtype=data.dtype,
                               device=data.device)
    pooled = segment_sum(data, segment_ids, num_segments)
    if combiner == "sum":
        return pooled
    denom = segment_sum(denom_src, segment_ids, num_segments)
    if combiner == "mean":
        return pooled / torch.clamp_min(denom, 1e-12)[..., None]
    if combiner == "sqrtn":
        if weights is not None:
            denom = torch.sqrt(segment_sum(weights * weights, segment_ids,
                                           num_segments))
        else:
            denom = torch.sqrt(denom)
        return pooled / torch.clamp_min(denom, 1e-12)[..., None]
    raise ValueError(f"unknown combiner {combiner!r}")
