"""The towers of the configurations, in plain PyTorch, one module a model:
``reference/<model>.py`` (``model`` in the configuration) defines

* ``layers(cfg)``: the dense layers ``(name, fan_in, fan_out)`` in the
  order of the program's ``nn.Linear`` modules, whose weights are handed
  in as ``{name + ".weight": [out, in], name + ".bias": [out]}``;
* ``forward(cfg, w, dense, emb)``: the logits ``[B]`` from the normalised
  dense features ``[B, Dd]`` and the pooled embeddings ``[B, F, d]`` (one
  id a column, so pooling is the row itself).
"""
from __future__ import annotations

import importlib
from typing import Dict, List, Tuple

import torch


def model(cfg: dict):
    return importlib.import_module(f"perfbench.reference.{cfg['model']}")


def layers(cfg: dict) -> List[Tuple[str, int, int]]:
    return model(cfg).layers(cfg)


def forward(cfg: dict, w: Dict[str, torch.Tensor], dense: torch.Tensor,
            emb: torch.Tensor) -> torch.Tensor:
    return model(cfg).forward(cfg, w, dense, emb)
