"""Dense building blocks (port of ``deeprec_tpu/models/layers.py``):
``MLPTower``, ``DotInteraction``, ``CrossNetV2``, ``FMInteraction``, and
the sequence models' ``Dice``, ``DINAttention``, ``GRUCellP`` (also
flax's ``AUGRUCell`` when given an attention weight), ``GRU`` and
``AUGRU``.

torch needs input widths up front, so each layer with weights takes its
``in_dim``. Each also describes its flax param tree (:meth:`flax_tree`):
a dict of the names flax gives its sub-layers, whose ``nn.Linear`` leaves
``models.ctr`` expands into ``kernel`` and ``bias``. ``Dice`` keeps its
running statistics as buffers and describes them too
(:meth:`Dice.flax_batch_stats`: flax's ``batch_stats`` collection).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.interaction import interact


def linear(layer: nn.Linear, x: torch.Tensor,
          compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``layer(x)`` as flax's ``nn.Dense(dtype=compute_dtype)`` computes
    it: at float32 the layer itself; at another dtype the input, kernel
    and bias are cast to it (the parameters stay float32), the product is
    rounded to it and the bias added in it, two roundings as in flax."""
    if compute_dtype == torch.float32:
        return layer(x)
    y = torch.matmul(x.to(compute_dtype), layer.weight.to(compute_dtype).T)
    if layer.bias is not None:
        y = y + layer.bias.to(compute_dtype)
    return y


class MLPTower(nn.Module):
    """Stacked Linear+ReLU; ``final_units`` adds a linear head without
    activation (``deeprec_tpu.models.layers.MLPTower``). With a
    ``compute_dtype`` other than float32 (the zoo's ``--bf16``) every
    layer computes in it (:func:`linear`) and the output is cast back to
    float32."""

    def __init__(self, in_dim: int, units: Sequence[int],
                 final_units: Optional[int] = None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        widths = [in_dim, *units]
        self.hidden = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))
        self.head = (nn.Linear(widths[-1], final_units)
                     if final_units is not None else None)
        self.out_dim = widths[-1] if final_units is None else final_units
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        x = x.to(cd)
        for layer in self.hidden:
            x = torch.relu(linear(layer, x, cd))
        if self.head is not None:
            x = linear(self.head, x, cd)
        return x.float()

    def flax_tree(self) -> dict:
        tree = {f"dense_{i}": lin for i, lin in enumerate(self.hidden)}
        if self.head is not None:
            tree["head"] = self.head
        return tree


class DotInteraction(nn.Module):
    """DLRM pairwise dot interaction: ``[B, F, d]`` features -> the
    strictly-lower-triangular entries of the ``[F, F]`` Gram matrix,
    row-major (the order of ``jnp.tril_indices(F, k=-1)``). On the card
    the hand-written kernels of ``ops.interaction`` (forward and backward,
    no Gram matrix); on the CPU a ``bmm`` and a gather."""

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        return interact(feats)


class CrossNetV2(nn.Module):
    """DCN-v2 cross layers: ``x_{l+1} = x0 * (W x_l + b) + x_l``. With
    ``low_rank`` the product is ``U (V x_l)``: ``v_i`` without a bias, then
    ``u_i``, as the flax layer names them. ``compute_dtype`` as in
    :class:`MLPTower`: every product and sum in it, the output float32."""

    def __init__(self, in_dim: int, num_layers: int = 3,
                 low_rank: Optional[int] = None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.low_rank = low_rank
        self.compute_dtype = compute_dtype
        if low_rank:
            self.v = nn.ModuleList(nn.Linear(in_dim, low_rank, bias=False)
                                   for _ in range(num_layers))
            self.u = nn.ModuleList(nn.Linear(low_rank, in_dim)
                                   for _ in range(num_layers))
        else:
            self.w = nn.ModuleList(nn.Linear(in_dim, in_dim)
                                   for _ in range(num_layers))

    def forward(self, x0: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        x0 = x0.to(cd)
        x = x0
        layers = (zip(self.v, self.u) if self.low_rank
                  else ((w, None) for w in self.w))
        for first, second in layers:
            w = linear(first, x, cd)
            if second is not None:
                w = linear(second, w, cd)
            x = x0 * w + x
        return x.float()

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


class Dice(nn.Module):
    """Dice (DIN): a PReLU whose gate is a sigmoid of the batch-normalised
    input, ``p * x + (1 - p) * alpha * x``. With ``train`` it normalises
    with the batch's mean and population variance (``jnp.var``, ddof 0)
    and folds them into the running ``mean`` and ``var`` buffers (momentum
    0.99, no gradient); without it, it normalises with those buffers, so
    eval output does not depend on the rest of the batch."""

    def __init__(self, dim: int, epsilon: float = 1e-9,
                 momentum: float = 0.99):
        super().__init__()
        self.epsilon, self.momentum = epsilon, momentum
        self.alpha = nn.Parameter(torch.zeros(dim))
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("var", torch.ones(dim))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            mean = x.mean(0)
            var = x.var(0, unbiased=False)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        p = torch.sigmoid((x - mean) * torch.rsqrt(var + self.epsilon))
        return p * x + (1.0 - p) * self.alpha * x

    def flax_tree(self) -> dict:
        return {"alpha": self.alpha}

    def flax_batch_stats(self) -> dict:
        return {"mean": self.mean, "var": self.var}


class DINAttention(nn.Module):
    """DIN's local activation unit: an MLP (sigmoid hidden layers
    ``att_i``, then ``att_out``) scores each history position ``k``
    against the query ``q`` from ``[q, k, q - k, q * k]``; a softmax over
    the valid positions of the scores over sqrt(d) (padding at -1e9, its
    weight then 0) weights the history's sum -> ``[B, d]``."""

    scaled = True  # scores over sqrt(d) (DINAttentionScores: unscaled)

    def __init__(self, dim: int, hidden_units: Sequence[int] = (80, 40)):
        super().__init__()
        widths = [4 * dim, *hidden_units]
        self.att = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))
        self.att_out = nn.Linear(widths[-1], 1)

    def weights(self, query: torch.Tensor, keys: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        """``[B, L]`` attention weights, 0 at padded positions."""
        q = query[:, None, :].expand_as(keys)
        x = torch.cat([q, keys, q - keys, q * keys], -1)
        for layer in self.att:
            x = torch.sigmoid(layer(x))
        logits = torch.where(mask, self.att_out(x)[..., 0], -1e9)
        if self.scaled:
            logits = logits / math.sqrt(keys.shape[-1])
        return torch.where(mask, torch.softmax(logits, -1), 0.0)

    def forward(self, query, keys, mask) -> torch.Tensor:
        return torch.einsum("bl,bld->bd", self.weights(query, keys, mask),
                            keys)

    def flax_tree(self) -> dict:
        tree = {f"att_{i}": lin for i, lin in enumerate(self.att)}
        tree["att_out"] = self.att_out
        return tree


class GRUCellP(nn.Module):
    """DIEN's GRU cell. The reset gate scales ``h`` before the candidate's
    product, ``n = tanh(W [x, r * h])``, which is not ``torch.nn.GRUCell``
    (``tanh(W_x x + r * (W_h h))``), so the cell is written out."""

    def __init__(self, in_dim: int, features: int):
        super().__init__()
        self.gates = nn.Linear(in_dim + features, 2 * features)
        self.cand = nn.Linear(in_dim + features, features)

    def forward(self, h, x, a=None):
        z, r = torch.sigmoid(self.gates(torch.cat([x, h], -1))).chunk(2, -1)
        n = torch.tanh(self.cand(torch.cat([x, r * h], -1)))
        if a is not None:
            z = a[..., None] * z
        return (1.0 - z) * h + z * n

    def flax_tree(self) -> dict:
        return {"cand": self.cand, "gates": self.gates}


class GRU(nn.Module):
    """GRU over ``[B, L, d]``: all hidden states ``[B, L, features]``, from
    zeros; a padded step holds the previous state. A Python loop over L
    (``nn.scan`` in flax, whose names :meth:`flax_tree` gives)."""

    def __init__(self, in_dim: int, features: int):
        super().__init__()
        self.features = features
        self.cell = GRUCellP(in_dim, features)

    def forward(self, xs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        h = xs.new_zeros((xs.shape[0], self.features))
        hs = []
        for t in range(xs.shape[1]):
            h = torch.where(mask[:, t, None], self.cell(h, xs[:, t]), h)
            hs.append(h)
        return torch.stack(hs, 1)

    def flax_tree(self) -> dict:
        return {"gru": {"GRUCellP_0": self.cell.flax_tree()}}


class AUGRU(nn.Module):
    """AUGRU over ``[B, L, d]`` with attention weights ``[B, L]``: the
    last hidden state ``[B, features]``; a padded step holds the
    previous state. Its cell is a :class:`GRUCellP` whose update gate is
    scaled by the step's attention weight (flax's ``AUGRUCell``)."""

    def __init__(self, in_dim: int, features: int):
        super().__init__()
        self.features = features
        self.cell = GRUCellP(in_dim, features)

    def forward(self, xs: torch.Tensor, att: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        h = xs.new_zeros((xs.shape[0], self.features))
        for t in range(xs.shape[1]):
            h = torch.where(mask[:, t, None],
                            self.cell(h, xs[:, t], att[:, t]), h)
        return h

    def flax_tree(self) -> dict:
        return {"augru": {"AUGRUCell_0": self.cell.flax_tree()}}
