"""Dense building blocks (port of ``deeprec_tpu/models/layers.py``):
``MLPTower``, ``DotInteraction``, ``CrossNetV2`` and ``FMInteraction``.

torch needs input widths up front, so each layer with weights takes its
``in_dim``. Each also describes its flax param tree (:meth:`flax_tree`):
a dict of the names flax gives its sub-layers, whose ``nn.Linear`` leaves
``models.ctr`` expands into ``kernel`` and ``bias``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn


class MLPTower(nn.Module):
    """Stacked Linear+ReLU; ``final_units`` adds a linear head without
    activation (``deeprec_tpu.models.layers.MLPTower``)."""

    def __init__(self, in_dim: int, units: Sequence[int],
                 final_units: Optional[int] = None):
        super().__init__()
        widths = [in_dim, *units]
        self.hidden = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))
        self.head = (nn.Linear(widths[-1], final_units)
                     if final_units is not None else None)
        self.out_dim = widths[-1] if final_units is None else final_units

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.hidden:
            x = torch.relu(layer(x))
        return self.head(x) if self.head is not None else x

    def flax_tree(self) -> dict:
        tree = {f"dense_{i}": lin for i, lin in enumerate(self.hidden)}
        if self.head is not None:
            tree["head"] = self.head
        return tree


class DotInteraction(nn.Module):
    """DLRM pairwise dot interaction: ``[B, F, d]`` features -> the
    strictly-lower-triangular entries of the ``[F, F]`` Gram matrix,
    row-major (the order of ``jnp.tril_indices(F, k=-1)``)."""

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        f = feats.shape[1]
        gram = torch.bmm(feats, feats.transpose(1, 2))
        rows, cols = torch.tril_indices(f, f, -1, device=feats.device)
        return gram[:, rows, cols]


class CrossNetV2(nn.Module):
    """DCN-v2 cross layers: ``x_{l+1} = x0 * (W x_l + b) + x_l``. With
    ``low_rank`` the product is ``U (V x_l)``: ``v_i`` without a bias, then
    ``u_i``, as the flax layer names them."""

    def __init__(self, in_dim: int, num_layers: int = 3,
                 low_rank: Optional[int] = None):
        super().__init__()
        self.low_rank = low_rank
        if low_rank:
            self.v = nn.ModuleList(nn.Linear(in_dim, low_rank, bias=False)
                                   for _ in range(num_layers))
            self.u = nn.ModuleList(nn.Linear(low_rank, in_dim)
                                   for _ in range(num_layers))
        else:
            self.w = nn.ModuleList(nn.Linear(in_dim, in_dim)
                                   for _ in range(num_layers))

    def forward(self, x0: torch.Tensor) -> torch.Tensor:
        x = x0
        layers = (zip(self.v, self.u) if self.low_rank
                  else ((w, None) for w in self.w))
        for first, second in layers:
            w = first(x) if second is None else second(first(x))
            x = x0 * w + x
        return x

    def flax_tree(self) -> dict:
        if self.low_rank:
            return {**{f"v_{i}": v for i, v in enumerate(self.v)},
                    **{f"u_{i}": u for i, u in enumerate(self.u)}}
        return {f"w_{i}": w for i, w in enumerate(self.w)}


class FMInteraction(nn.Module):
    """Second-order FM pooling by the sum-square trick:
    ``0.5 * sum_d((sum_f v)^2 - sum_f v^2)`` -> ``[B, 1]`` (DeepFM)."""

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        s = feats.sum(1)
        sq_sum = (feats * feats).sum(1)
        return 0.5 * (s * s - sq_sum).sum(-1, keepdim=True)
