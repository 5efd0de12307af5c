"""The models of the configurations, in plain PyTorch, one module a model:
``reference/<model>.py`` (``model`` in the configuration) defines

* ``params(cfg)``: every trainable tensor ``(name, shape, init)`` in the
  order of the program model's ``named_parameters()``, under the same
  names; ``init`` is ``lecun`` (a normal over ``sqrt(fan_in)``, ``fan_in``
  the product of the shape but its first axis), ``zeros`` or ``ones``
  (``core/weights.py`` makes them);
* ``forward(cfg, w, inputs, train)``: ``(logits [B], aux)``, ``aux`` the
  model's auxiliary loss (a scalar) or None. ``inputs`` holds ``emb``,
  the one-id columns' rows ``[B, F, d]`` (one id a column, so pooling is
  the row itself) in the order of ``names``; ``seq``, each history column
  ``name -> ([B, L, d], mask [B, L])``, zeros at padding; ``dense``, the
  normalised dense features ``[B, Dd]``, or None.

The loss is the mean sigmoid cross-entropy of the logits, plus the
configuration's ``aux_loss_weight`` times ``aux`` where there is one
(``reference/train.py``).
"""
from __future__ import annotations

import importlib
from typing import List, Tuple


def model(cfg: dict):
    """The module ``reference/<cfg["model"]>.py``."""
    return importlib.import_module(f"perfbench.reference.{cfg['model']}")


def layers(cfg: dict) -> List[Tuple[str, int, int]]:
    """The dense layers ``(name, fan_in, fan_out)`` of a tower model
    (``arith/`` counts their products)."""
    return model(cfg).layers(cfg)


def linear_params(layers) -> list:
    """``params`` entries of dense layers ``(name, fan_in, fan_out)``: each
    weight ``[out, in]`` (LeCun), then its bias (zeros)."""
    return [p for name, a, b in layers
            for p in ((f"{name}.weight", (b, a), "lecun"),
                      (f"{name}.bias", (b,), "zeros"))]
