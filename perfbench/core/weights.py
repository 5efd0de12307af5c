"""The dense weights of a cell, made by the benchmark from ``--seed``.

The reference lists every trainable tensor ``(name, shape, init)``
(``reference/<model>.py`` ``params``). One normal draw on the device
covers the ``lecun`` tensors, in that order, each one's slice scaled by
``1/sqrt(fan_in)`` (LeCun's normal; ``fan_in`` the product of the shape
but its first axis, a ``[out, in]`` weight's ``in``); ``zeros`` and
``ones`` tensors are filled. The same tensors go to the program (copied
into its parameters by name) and to the reference, which therefore take
nothing from each other.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch

WEIGHT_SEED_SALT = 0x5DEECE66D


def make(params: Sequence[Tuple[str, tuple, str]], seed: int,
         device) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` float32 on ``device``, in ``params``' order."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) ^ WEIGHT_SEED_SALT) & (2 ** 63 - 1))
    total = sum(math.prod(s) for _, s, init in params if init == "lecun")
    flat = torch.randn((total,), generator=g, dtype=torch.float32,
                       device=device)
    out, o = {}, 0
    for name, shape, init in params:
        if init == "lecun":
            n, fan_in = math.prod(shape), math.prod(shape[1:])
            out[name] = flat[o:o + n].view(*shape) * fan_in ** -0.5
            o += n
        elif init in ("zeros", "ones"):
            out[name] = (torch.zeros if init == "zeros" else torch.ones)(
                shape, dtype=torch.float32, device=device)
        else:
            raise ValueError(f"{name}: unknown init {init!r}")
    return out
