"""CTR models (port of ``deeprec_tpu/models/ctr.py``): DLRM, and the
functions that carry a flax-trained model's weights and its
``optax.adagrad`` state across.

Models consume ``dense [B, Dd]`` and ``emb``, a dict name -> ``[B, d]``
pooled embeddings, and return logits ``[B]``.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
from torch import nn

from .layers import DotInteraction, MLPTower


class DLRM(nn.Module):
    """DLRM: bottom MLP on the dense features -> ``emb_dim``, pairwise dot
    interaction over [bottom] + embeddings, top MLP -> one logit."""

    def __init__(self, emb_names: Sequence[str], emb_dim: int,
                 bottom_units: Sequence[int] = (512, 256),
                 top_units: Sequence[int] = (1024, 1024, 512, 256),
                 dense_dim: int = 13):
        super().__init__()
        self.emb_names = list(emb_names)
        n_feats = 1 + len(self.emb_names)
        self.bottom = MLPTower(dense_dim, bottom_units, final_units=emb_dim)
        self.interaction = DotInteraction()
        self.top = MLPTower(emb_dim + n_feats * (n_feats - 1) // 2,
                            top_units, final_units=1)

    def forward(self, dense: torch.Tensor, emb: Dict[str, torch.Tensor],
                wide=None, train: bool = False) -> torch.Tensor:
        bottom = self.bottom(dense)
        feats = torch.stack([bottom] + [emb[n] for n in self.emb_names], 1)
        inter = self.interaction(feats)
        return self.top(torch.cat([bottom, inter], -1))[:, 0]

    def flax_towers(self) -> List[MLPTower]:
        """Towers in flax's creation order (``MLPTower_0``, ``_1``)."""
        return [self.bottom, self.top]


def _flax_params(module: nn.Module):
    """``(flax path, torch Linear, leaf name)`` in the order
    ``jax.tree_util`` flattens the flax params dict: sorted keys at every
    level (``MLPTower_0/dense_0/bias``, ``.../kernel``, ...,
    ``MLPTower_0/head/...``, ``MLPTower_1/...``)."""
    out = []
    for ti, tower in enumerate(module.flax_towers()):
        layers = [(f"dense_{i}", lin) for i, lin in enumerate(tower.hidden)]
        if tower.head is not None:
            layers.append(("head", tower.head))
        for name, lin in layers:
            for leaf in ("bias", "kernel"):
                out.append(((f"MLPTower_{ti}", name, leaf), lin, leaf))
    out.sort(key=lambda t: t[0])
    return out


def _leaf(lin: nn.Linear, leaf: str) -> torch.Tensor:
    # flax kernels are [in, out], torch weights [out, in]
    return lin.bias if leaf == "bias" else lin.weight.T


def flax_leaves(module: nn.Module) -> List[np.ndarray]:
    """The module's parameters as the flax param leaves, in flatten order."""
    return [_leaf(lin, leaf).detach().cpu().numpy().copy()
            for _, lin, leaf in _flax_params(module)]


def load_flax_params(module: nn.Module, leaves: Sequence) -> nn.Module:
    """Copy flax param leaves into ``module`` in place and return it. Takes
    the leading leaves (a checkpoint's ``dense.npz`` continues with the
    optimizer state and the step); raises ``ValueError`` when they do not
    match the module's parameter structure."""
    spec = _flax_params(module)
    if len(leaves) < len(spec):
        raise ValueError(f"{len(leaves)} leaves for {len(spec)} parameters")
    with torch.no_grad():
        for (path, lin, leaf), value in zip(spec, leaves):
            dst = _leaf(lin, leaf)
            src = torch.tensor(np.asarray(value))
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(
                    f"checkpoint leaf {'/'.join(path)} has shape "
                    f"{tuple(src.shape)}, the model {tuple(dst.shape)}: the "
                    "dense leaves do not match the model's parameters")
            dst.copy_(src)
    return module


def load_flax_adagrad_state(module: nn.Module,
                            leaves: Sequence) -> List[torch.Tensor]:
    """The accumulators of an ``optax.adagrad`` state as the port's dense
    optimizer holds them (``optim.dense.Adagrad``): one tensor per entry of
    ``module.parameters()``, in that order. ``leaves`` are the state's
    ``sum_of_squares`` leaves, which follow the flax param flatten order
    (``jax.tree_util.tree_leaves(opt_state)``; leaves past the parameter
    count are ignored)."""
    spec = _flax_params(module)
    if len(leaves) < len(spec):
        raise ValueError(f"{len(leaves)} leaves for {len(spec)} parameters")
    by_param = {}
    for (path, lin, leaf), value in zip(spec, leaves):
        acc = torch.tensor(np.asarray(value))
        dst = lin.bias if leaf == "bias" else lin.weight
        acc = acc if leaf == "bias" else acc.T.contiguous()
        if tuple(acc.shape) != tuple(dst.shape):
            raise ValueError(f"adagrad leaf {'/'.join(path)} has shape "
                             f"{tuple(np.shape(value))}, which does not fit "
                             f"the model's {tuple(dst.shape)}")
        by_param[id(dst)] = acc.to(dst.device)
    return [by_param[id(p)] for p in module.parameters()]
