"""Dense optimizer: the counterpart of ``optax.adagrad``.

``optax.adagrad(lr)`` (``scale_by_rss`` then ``scale_by_learning_rate``)
keeps ``acc`` starting at ``initial_accumulator_value`` (0.1), and updates
``acc += g^2; p += -lr * (rsqrt(acc + eps) * g)`` with ``eps = 1e-7`` and
the rsqrt taken as 0 where ``acc`` is 0. That is not
``torch.optim.Adagrad`` with its defaults (acc from 0, ``g / (sqrt(acc) +
1e-10)``), so the port writes it out.
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence

import torch


class Adagrad(NamedTuple):
    learning_rate: float = 0.05
    initial_accumulator_value: float = 0.1
    eps: float = 1e-7

    def init(self, params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """One accumulator per parameter, in the given order."""
        return [torch.full_like(p, self.initial_accumulator_value,
                                memory_format=torch.contiguous_format)
                for p in params]

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor],
             state: Sequence[torch.Tensor]) -> None:
        """Update ``params`` in place from their ``.grad``."""
        for p, acc in zip(params, state):
            g = p.grad
            if g is None:
                continue
            acc.add_(g * g)
            scale = torch.where(acc > 0, torch.rsqrt(acc + self.eps), 0.0)
            p.add_(scale * g, alpha=-self.learning_rate)
