"""DCN-v2 in plain PyTorch (Wang et al. 2021, arXiv:2008.13535; DeepRec
modelzoo ``dcnv2``): ``x0 = [dense, emb_1..emb_F]``; full-rank cross
layers ``x_{l+1} = x0 * (W_l x_l + b_l) + x_l``; a deep MLP over ``x0``
with ReLU after every layer, in parallel; a last layer over ``[cross,
deep]`` gives the logit."""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from .ctr import linear_params
from .dlrm import run_mlp


def layers(cfg: dict) -> List[Tuple[str, int, int]]:
    x0 = cfg["dense_features"] + cfg["categorical_columns"] * cfg["emb_dim"]
    deep = [x0, *cfg["deep_units"]]
    return ([(f"cross.w.{i}", x0, x0) for i in range(cfg["cross_layers"])]
            + [(f"deep.hidden.{i}", a, b)
               for i, (a, b) in enumerate(zip(deep[:-1], deep[1:]))]
            + [("head", x0 + cfg["deep_units"][-1], 1)])


def params(cfg: dict) -> list:
    return linear_params(layers(cfg))


def forward(cfg: dict, w: Dict[str, torch.Tensor], inputs: dict,
            train: bool):
    x0 = torch.cat([inputs["dense"], inputs["emb"].flatten(1)], 1)
    x = x0
    for i in range(cfg["cross_layers"]):
        x = x0 * (x @ w[f"cross.w.{i}.weight"].T + w[f"cross.w.{i}.bias"]) \
            + x
    deep = run_mlp(w, "deep", len(cfg["deep_units"]), x0, True)
    both = torch.cat([x, deep], 1)
    return (both @ w["head.weight"].T + w["head.bias"])[:, 0], None
