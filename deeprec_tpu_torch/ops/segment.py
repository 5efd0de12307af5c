"""Segment combiners for embedding pooling.

Port of ``deeprec_tpu/ops/segment.py``: ``segment_sum`` and
``segment_combine`` (the ``SparseSegment{Sum,Mean,SqrtN}`` combiners of
``embedding_lookup_sparse``). The JAX package lowers them to XLA
scatter-adds, not to a Pallas kernel, so they are plain PyTorch here
(``index_add_``). Segment ids outside ``[0, num_segments)`` are dropped, as
``jax.ops.segment_sum`` drops them.
"""
from __future__ import annotations

from typing import Optional

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    keep = (segment_ids >= 0) & (segment_ids < num_segments)
    # dropped lanes add zeros to segment 0: no host sync for a mask
    ids = torch.where(keep, segment_ids, 0).long()
    zero = torch.zeros((), dtype=data.dtype, device=data.device)
    mask = keep.reshape(keep.shape + (1,) * (data.dim() - 1))
    return out.index_add_(0, ids, torch.where(mask, data, zero))


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
