"""DLRM in plain PyTorch (Naumov et al. 2019, arXiv:1906.00091; DeepRec
modelzoo ``dlrm``): a bottom MLP (ReLU between layers, none after the last)
maps the dense features to ``d``; the ``F + 1`` vectors ``[bottom,
emb_1..emb_F]`` give their pairwise dot products, the strictly lower
triangle of the Gram matrix in row-major order; the top MLP over
``[bottom, dots]`` gives one logit."""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from .ctr import linear_params


def layers(cfg: dict) -> List[Tuple[str, int, int]]:
    d, nd, nf = cfg["emb_dim"], cfg["dense_features"], \
        cfg["categorical_columns"]
    f = nf + 1
    return (mlp("bottom", [nd, *cfg["bottom_units"], d])
            + mlp("top", [d + f * (f - 1) // 2, *cfg["top_units"], 1]))


def params(cfg: dict) -> list:
    return linear_params(layers(cfg))


def mlp(prefix: str, widths) -> List[Tuple[str, int, int]]:
    """An ``MLPTower``'s layers: ``hidden.i``, the last one ``head``."""
    n = len(widths) - 1
    return [(f"{prefix}.hidden.{i}" if i < n - 1 else f"{prefix}.head", a, b)
            for i, (a, b) in enumerate(zip(widths[:-1], widths[1:]))]


def run_mlp(w: Dict[str, torch.Tensor], prefix: str, n: int,
            x: torch.Tensor, relu_last: bool) -> torch.Tensor:
    for i in range(n):
        name = f"{prefix}.hidden.{i}" if i < n - 1 or relu_last \
            else f"{prefix}.head"
        x = x @ w[f"{name}.weight"].T + w[f"{name}.bias"]
        if i < n - 1 or relu_last:
            x = torch.relu(x)
    return x


def forward(cfg: dict, w: Dict[str, torch.Tensor], inputs: dict,
            train: bool):
    dense, emb = inputs["dense"], inputs["emb"]
    bottom = run_mlp(w, "bottom", len(cfg["bottom_units"]) + 1, dense, False)
    feats = torch.cat([bottom[:, None, :], emb], 1)
    f = feats.shape[1]
    gram = feats @ feats.transpose(1, 2)
    i, j = torch.tril_indices(f, f, -1, device=feats.device)
    top_in = torch.cat([bottom, gram[:, i, j]], 1)
    return run_mlp(w, "top", len(cfg["top_units"]) + 1, top_in,
                   False)[:, 0], None
