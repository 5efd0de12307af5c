"""The dense weights of a cell, made by the benchmark from ``--seed``.

One normal draw on the device for every weight of every layer, each
layer's slice scaled by ``1/sqrt(fan_in)`` (LeCun's normal); biases zero.
The same tensors go to the program (copied into its ``nn.Linear`` modules)
and to the reference, which therefore take nothing from each other.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

WEIGHT_SEED_SALT = 0x5DEECE66D


def make(layers: Sequence[Tuple[str, int, int]], seed: int,
         device) -> Dict[str, torch.Tensor]:
    """``{name.weight: [out, in], name.bias: [out]}`` float32 on
    ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) ^ WEIGHT_SEED_SALT) & (2 ** 63 - 1))
    total = sum(a * b for _, a, b in layers)
    flat = torch.randn((total,), generator=g, dtype=torch.float32,
                       device=device)
    out, o = {}, 0
    for name, fan_in, fan_out in layers:
        n = fan_in * fan_out
        out[f"{name}.weight"] = (flat[o:o + n].view(fan_out, fan_in)
                                 * fan_in ** -0.5)
        out[f"{name}.bias"] = torch.zeros((fan_out,), dtype=torch.float32,
                                          device=device)
        o += n
    return out
