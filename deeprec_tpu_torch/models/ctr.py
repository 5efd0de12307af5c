"""CTR models (port of ``deeprec_tpu/models/ctr.py``): WDL, DLRM, DCN-v2,
DeepFM and DSSM, and the functions that carry a flax-trained model's
weights and its optax state across, in both directions.

Models consume ``dense [B, Dd]`` (None for DSSM, which has no numeric
columns), ``emb``, a dict name -> ``[B, d]`` pooled embeddings, and
``wide``, an optional dict name -> ``[B, 1]`` wide (dim-1) embeddings, and
return logits ``[B]``. torch needs input widths up front, so each
constructor takes them (``emb_dim``, ``dense_dim``). Parameters are
float32; ``compute_dtype`` (the zoo's ``--bf16``: ``torch.bfloat16``) is
the dtype the towers and cross layers compute in, as in the JAX models,
whose outputs come back as float32.

Each model describes its flax param tree by name (:meth:`flax_tree`):
nested dicts of the names flax gives its sub-modules and parameters, with
``nn.Linear`` leaves for Dense layers (a kernel, ``[in, out]`` in flax and
so the torch weight transposed, and a bias when it has one) and
``nn.Parameter`` leaves for scalar parameters. The carry functions flatten
it with sorted keys at every level (``utils.tree``), the order
``jax.tree_util`` flattens the flax params dict in: capitals first
(``CrossNetV2_0`` < ``MLPTower_0`` < ``head``), and lexical (``w_10`` <
``w_2``). A model with running statistics (DIN's and DIEN's ``Dice``)
also describes its buffers (``flax_batch_stats``); its flax variables are
then ``{"batch_stats": ..., "params": ...}``, flattened by the same rule,
so the statistics come first in every save. An optax state over those
variables holds leaves for the statistics too, which never get a gradient:
the optimizer-state carry writes them as the optimizer's initial value
and refuses a save whose leaves are not.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..utils.tree import leaves_with_paths
from .layers import CrossNetV2, DotInteraction, FMInteraction, MLPTower


def stack_emb(emb: Dict[str, torch.Tensor],
              names: Sequence[str]) -> torch.Tensor:
    """``[B, F, d]`` in a fixed feature order."""
    return torch.stack([emb[n] for n in names], 1)


def concat_emb(emb: Dict[str, torch.Tensor],
               names: Sequence[str]) -> torch.Tensor:
    return torch.cat([emb[n] for n in names], -1)


def _wide_sum(wide, names):
    # the JAX models' Python ``sum``: 0 + w_0 + w_1 + ...
    return sum(wide[n][:, 0] for n in names)


class WDL(nn.Module):
    """Wide & Deep: a deep MLP over ``[dense, embeddings]`` plus the sum of
    the dim-1 wide values and the scalar ``wide_bias`` (which exists when
    ``wide_names`` is given; the model is then called with ``wide=``)."""

    def __init__(self, emb_names: Sequence[str], wide_names: Sequence[str],
                 emb_dim: int, deep_units: Sequence[int] = (1024, 512, 256),
                 dense_dim: int = 13,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.emb_names, self.wide_names = list(emb_names), list(wide_names)
        self.deep = MLPTower(dense_dim + len(self.emb_names) * emb_dim,
                             deep_units, final_units=1,
                             compute_dtype=compute_dtype)
        if self.wide_names:
            self.wide_bias = nn.Parameter(torch.zeros(()))
        else:
            self.register_parameter("wide_bias", None)

    def forward(self, dense, emb, wide=None, train: bool = False):
        deep = self.deep(torch.cat([dense, concat_emb(emb, self.emb_names)],
                                   -1))[:, 0]
        if wide is None or not self.wide_names:
            return deep
        return deep + (_wide_sum(wide, self.wide_names) + self.wide_bias)

    def flax_tree(self) -> dict:
        tree = {"MLPTower_0": self.deep.flax_tree()}
        if self.wide_bias is not None:
            tree["wide_bias"] = self.wide_bias
        return tree


class DLRM(nn.Module):
    """DLRM: bottom MLP on the dense features -> ``emb_dim``, pairwise dot
    interaction over [bottom] + embeddings, top MLP -> one logit."""

    def __init__(self, emb_names: Sequence[str], emb_dim: int,
                 bottom_units: Sequence[int] = (512, 256),
                 top_units: Sequence[int] = (1024, 1024, 512, 256),
                 dense_dim: int = 13,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.emb_names = list(emb_names)
        n_feats = 1 + len(self.emb_names)
        self.bottom = MLPTower(dense_dim, bottom_units, final_units=emb_dim,
                               compute_dtype=compute_dtype)
        self.interaction = DotInteraction()
        self.top = MLPTower(emb_dim + n_feats * (n_feats - 1) // 2,
                            top_units, final_units=1,
                            compute_dtype=compute_dtype)

    def forward(self, dense: torch.Tensor, emb: Dict[str, torch.Tensor],
                wide=None, train: bool = False) -> torch.Tensor:
        bottom = self.bottom(dense)
        feats = torch.stack([bottom] + [emb[n] for n in self.emb_names], 1)
        inter = self.interaction(feats)
        return self.top(torch.cat([bottom, inter], -1))[:, 0]

    def flax_tree(self) -> dict:
        return {"MLPTower_0": self.bottom.flax_tree(),
                "MLPTower_1": self.top.flax_tree()}


class DCN(nn.Module):
    """DCN-v2: a cross network and a deep tower in parallel over
    ``x0 = [dense, embeddings]``, then a ``head`` Dense to one logit."""

    def __init__(self, emb_names: Sequence[str], emb_dim: int,
                 cross_layers: int = 3, low_rank: Optional[int] = None,
                 deep_units: Sequence[int] = (1024, 512, 256),
                 dense_dim: int = 13,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.emb_names = list(emb_names)
        d0 = dense_dim + len(self.emb_names) * emb_dim
        self.cross = CrossNetV2(d0, cross_layers, low_rank,
                                compute_dtype=compute_dtype)
        self.deep = MLPTower(d0, deep_units, compute_dtype=compute_dtype)
        self.head = nn.Linear(d0 + self.deep.out_dim, 1)

    def forward(self, dense, emb, wide=None, train: bool = False):
        x0 = torch.cat([dense, concat_emb(emb, self.emb_names)], -1)
        both = torch.cat([self.cross(x0), self.deep(x0)], -1)
        return self.head(both)[:, 0]

    def flax_tree(self) -> dict:
        return {"CrossNetV2_0": self.cross.flax_tree(),
                "MLPTower_0": self.deep.flax_tree(), "head": self.head}


class DeepFM(nn.Module):
    """DeepFM: second-order FM over the embedding stack, a deep MLP over
    ``[dense, embeddings]``, the first-order wide values and the scalar
    ``bias``, summed into one logit."""

    def __init__(self, emb_names: Sequence[str], wide_names: Sequence[str],
                 emb_dim: int, deep_units: Sequence[int] = (400, 400, 400),
                 dense_dim: int = 13,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.emb_names, self.wide_names = list(emb_names), list(wide_names)
        self.fm = FMInteraction()
        self.deep = MLPTower(dense_dim + len(self.emb_names) * emb_dim,
                             deep_units, final_units=1,
                             compute_dtype=compute_dtype)
        self.bias = nn.Parameter(torch.zeros(()))

    def forward(self, dense, emb, wide=None, train: bool = False):
        feats = stack_emb(emb, self.emb_names)
        fm = self.fm(feats)[:, 0]
        deep = self.deep(torch.cat([dense, feats.flatten(1)], -1))[:, 0]
        first = 0.0
        if wide is not None and self.wide_names:
            first = _wide_sum(wide, self.wide_names)
        return fm + deep + first + self.bias

    def flax_tree(self) -> dict:
        return {"MLPTower_0": self.deep.flax_tree(), "bias": self.bias}


class DSSM(nn.Module):
    """Two-tower DSSM: ``user_tower`` and ``item_tower`` MLPs, each output
    normalised, logit = their cosine over ``temperature``. The norm is
    ``u * rsqrt(sum(u*u) + 1e-12)``, as in the JAX package: smooth at 0,
    where an all-zero tower input lands (``F.normalize`` clamps the norm
    instead, another function)."""

    def __init__(self, user_emb_names: Sequence[str],
                 item_emb_names: Sequence[str], emb_dim: int,
                 user_dense_dim: int = 0,
                 tower_units: Sequence[int] = (256, 128), out_dim: int = 64,
                 temperature: float = 0.05,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.user_emb_names = list(user_emb_names)
        self.item_emb_names = list(item_emb_names)
        self.user_dense_dim = user_dense_dim
        self.temperature = temperature
        self.user_tower = MLPTower(
            user_dense_dim + len(self.user_emb_names) * emb_dim, tower_units,
            final_units=out_dim, compute_dtype=compute_dtype)
        self.item_tower = MLPTower(len(self.item_emb_names) * emb_dim,
                                   tower_units, final_units=out_dim,
                                   compute_dtype=compute_dtype)

    def forward(self, dense, emb, wide=None, train: bool = False):
        u_in = concat_emb(emb, self.user_emb_names)
        if self.user_dense_dim:
            u_in = torch.cat([dense[:, :self.user_dense_dim], u_in], -1)
        u = self.user_tower(u_in)
        v = self.item_tower(concat_emb(emb, self.item_emb_names))
        u = u * torch.rsqrt((u * u).sum(-1, keepdim=True) + 1e-12)
        v = v * torch.rsqrt((v * v).sum(-1, keepdim=True) + 1e-12)
        return (u * v).sum(-1) / self.temperature

    def flax_tree(self) -> dict:
        return {"user_tower": self.user_tower.flax_tree(),
                "item_tower": self.item_tower.flax_tree()}


# -- carrying weights and optimizer state to and from flax --------------------
class _Kernel:
    """A flax Dense kernel leaf: the torch weight, read as ``[in, out]``."""

    __slots__ = ("weight",)

    def __init__(self, weight: nn.Parameter):
        self.weight = weight


def _expand(tree: dict) -> dict:
    """``nn.Linear`` leaves -> ``{"kernel", "bias"}`` dicts."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, nn.Linear):
            out[k] = {"kernel": _Kernel(v.weight)}
            if v.bias is not None:
                out[k]["bias"] = v.bias
        elif isinstance(v, dict):
            out[k] = _expand(v)
        else:
            out[k] = v
    return out


def _flax_params(module: nn.Module) -> List[Tuple[str, torch.Tensor, bool]]:
    """``(flax path, parameter or buffer, transposed)`` per leaf of the
    flax variables, in flatten order."""
    tree = _expand(module.flax_tree())
    stats = getattr(module, "flax_batch_stats", lambda: {})()
    if stats:
        tree = {"batch_stats": stats, "params": tree}
    return [(path, leaf.weight, True) if isinstance(leaf, _Kernel)
            else (path, leaf, False)
            for path, leaf in leaves_with_paths(tree)]


def _as_flax(t: torch.Tensor, transposed: bool) -> torch.Tensor:
    return t.T if transposed else t


def flax_leaf_count(module: nn.Module) -> int:
    """The number of the module's flax variable leaves."""
    return len(_flax_params(module))


def flax_leaves(module: nn.Module) -> List[np.ndarray]:
    """The module's flax variables (parameters, and running statistics
    first when it has them) as leaves, in flatten order."""
    return [_as_flax(p, t).detach().cpu().numpy().copy()
            for _, p, t in _flax_params(module)]


def flax_state_leaves(module: nn.Module, per_param: Sequence[torch.Tensor],
                      fill: float = 0.0) -> List[np.ndarray]:
    """Per-parameter optimizer tensors (one per ``module.parameters()``
    entry, in that order) as the leaves of a variables-shaped optax state
    tree, in the flax flatten order (kernels transposed to ``[in, out]``;
    a running statistic's leaf is ``fill``, the value an optax state keeps
    for a leaf whose gradient is always 0). The inverse of
    :func:`load_flax_state`."""
    by_param = {id(p): s for p, s in zip(module.parameters(), per_param)}
    return [_as_flax(by_param[id(p)], t).detach().cpu().numpy().copy()
            if id(p) in by_param
            else np.full(tuple(p.shape), fill, np.float32)
            for _, p, t in _flax_params(module)]


def load_flax_state(module: nn.Module, leaves: Sequence,
                    what: str = "optimizer state",
                    fill: float = 0.0) -> List[torch.Tensor]:
    """The leaves of a variables-shaped optax state tree (flax flatten
    order; leaves past the variable count are ignored) as one tensor per
    ``module.parameters()`` entry, in that order, on the parameter's
    device. Raises ``ValueError`` when they do not fit the model, or when
    a running statistic's leaf is not ``fill`` (the optimizer never steps
    the statistics, so it would lose that state)."""
    spec = _flax_params(module)
    if len(leaves) < len(spec):
        raise ValueError(f"{len(leaves)} leaves for {len(spec)} variables")
    params = {id(p) for p in module.parameters()}
    by_param = {}
    for (path, p, t), value in zip(spec, leaves):
        if id(p) not in params:
            value = np.asarray(value)
            if value.shape != tuple(p.shape) or not (value == fill).all():
                raise ValueError(
                    f"{what} leaf {path} of a running statistic is not "
                    f"{fill} everywhere (shape {value.shape}): the "
                    "optimizer never steps the statistics")
            continue
        x = torch.tensor(np.asarray(value))
        x = x.T.contiguous() if t else x
        if tuple(x.shape) != tuple(p.shape):
            raise ValueError(f"{what} leaf {path} has shape "
                             f"{tuple(np.shape(value))}, which does not fit "
                             f"the model's {tuple(_as_flax(p, t).shape)}")
        by_param[id(p)] = x.to(p.device)
    return [by_param[id(p)] for p in module.parameters()]


def load_flax_params(module: nn.Module, leaves: Sequence) -> nn.Module:
    """Copy flax variable leaves (running statistics, then parameters)
    into ``module`` in place and return it. Takes the leading leaves (a
    checkpoint's ``dense.npz`` continues with the optimizer state and the
    step); raises ``ValueError`` when they do not match the module's
    variables."""
    spec = _flax_params(module)
    if len(leaves) < len(spec):
        raise ValueError(f"{len(leaves)} leaves for {len(spec)} variables")
    with torch.no_grad():
        for (path, p, t), value in zip(spec, leaves):
            dst = _as_flax(p, t)
            src = torch.tensor(np.asarray(value))
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(
                    f"checkpoint leaf {path} has shape {tuple(src.shape)}, "
                    f"the model {tuple(dst.shape)}: the dense leaves do not "
                    "match the model's parameters")
            dst.copy_(src)
    return module

