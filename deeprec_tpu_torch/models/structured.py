"""Structured model: compute the user tower once per request.

Port of ``deeprec_tpu/models/structured.py``. :func:`structured_forward`
runs the user tower at request granularity ``[B, ...]`` and the item tower
at candidate granularity ``[B, I, ...]`` (flattened to ``[B*I, ...]``),
then broadcasts the user activations across the item axis for the joint
head: the tile that the reference's graph pass inserted is one
``expand``.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..utils.tree import leaves_with_paths, map_leaves


def structured_forward(user_fn: Callable[..., torch.Tensor],
                       item_fn: Callable[..., torch.Tensor],
                       head_fn: Callable[[torch.Tensor, torch.Tensor],
                                         torch.Tensor],
                       user_inputs, item_inputs) -> torch.Tensor:
    """Score ``I`` candidate items per request with one user-tower pass.

    ``user_fn``: ``user_inputs ([B, ...]) -> [B, Du]``; ``item_fn``:
    applied to the flattened ``[B*I, ...]`` view of ``item_inputs`` (a
    tensor, or a tree of tuples, lists and dicts of tensors, all with the
    leading ``[B, I]``) -> ``[B*I, Di]``; ``head_fn``: ``([B, I, Du],
    [B, I, Di]) -> [B, I]``. Returns the ``[B, I]`` scores."""
    u = user_fn(user_inputs)                                  # [B, Du]
    first = leaves_with_paths(item_inputs)[0][1]
    b, i = first.shape[:2]
    flat = map_leaves(lambda _, x: x.reshape((b * i,) + tuple(x.shape[2:])),
                      item_inputs)
    v = item_fn(flat).reshape(b, i, -1)
    return head_fn(u[:, None, :].expand(b, i, u.shape[-1]), v)


def dot_head(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The common scorer: per-candidate dot product (retrieval ranking)."""
    return (u * v).sum(-1)
