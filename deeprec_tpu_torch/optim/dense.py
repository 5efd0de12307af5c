"""Dense optimizers: the counterparts of ``optax.sgd`` (with and without
momentum), ``optax.adagrad`` and ``optax.adam``, written out, each with
its conversion to and from the leaves of the optax state tree (what a
checkpoint's ``dense.npz`` holds after the params).

``optax.adagrad(lr)`` (``scale_by_rss`` then ``scale_by_learning_rate``)
keeps ``acc`` starting at ``initial_accumulator_value`` (0.1), and updates
``acc += g^2; p += -lr * (rsqrt(acc + eps) * g)`` with ``eps = 1e-7`` and
the rsqrt taken as 0 where ``acc`` is 0. That is not
``torch.optim.Adagrad`` with its defaults (acc from 0, ``g / (sqrt(acc) +
1e-10)``). ``optax.adam(lr)`` (``scale_by_adam`` then
``scale_by_learning_rate``) keeps an int32 ``count`` that it bumps before
the bias correction, ``mu`` and ``nu``, and steps ``p += -lr * mu_hat /
(sqrt(nu_hat + eps_root) + eps)``; ``torch.optim.Adam`` rounds otherwise
(it folds the corrections into the step size). So the port writes both
out.

The state holds one tensor per entry of ``module.parameters()`` (in that
order) for each params-shaped leaf of the optax state;
``flax_state_leaves``/``load_flax_state`` convert it to and from the optax
leaves, which follow the flax variables' flatten order (``models.ctr``).
The JAX trainer runs optax over the whole variables dict, so a model with
running statistics (DIN, DIEN) has optax leaves for them too. Their
gradient is always 0, so they keep their initial value (Adam's moments 0,
Adagrad's accumulator 0.1): the port steps ``parameters()`` only, writes
that value for them in a save and refuses a save where they differ.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..models.ctr import (flax_leaf_count, flax_state_leaves,
                          load_flax_state)


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

    # -- the optax state: (ScaleByRssState(sum_of_squares), EmptyState()) --
    @staticmethod
    def state_leaf_count(n_leaves: int) -> int:
        """Optax leaves over ``n_leaves`` flax variable leaves."""
        return n_leaves

    def flax_state_leaves(self, module: torch.nn.Module,
                          state) -> List[np.ndarray]:
        """The ``sum_of_squares`` leaves."""
        return flax_state_leaves(module, state,
                                 self.initial_accumulator_value)

    def load_flax_state(self, module: torch.nn.Module,
                        leaves) -> List[torch.Tensor]:
        return load_flax_state(module, leaves, "adagrad",
                               self.initial_accumulator_value)


class AdamState(NamedTuple):
    count: torch.Tensor      # int32 scalar: steps taken
    mu: List[torch.Tensor]   # first moments, one per parameter
    nu: List[torch.Tensor]   # second moments


class Adam(NamedTuple):
    learning_rate: float = 0.001
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    eps_root: float = 0.0

    def init(self, params: Sequence[torch.Tensor]) -> AdamState:
        params = list(params)
        dev = params[0].device if params else None

        def zeros():
            return [torch.zeros_like(p, memory_format=torch.contiguous_format)
                    for p in params]
        return AdamState(torch.zeros((), dtype=torch.int32, device=dev),
                         zeros(), zeros())

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor], state: AdamState) -> None:
        """Update ``params`` and ``state`` in place from their ``.grad``.
        A parameter without a gradient steps with a zero one, as optax
        steps it (its moments decay, and the parameter moves by them)."""
        state.count.add_(1)   # optax bumps the count before the correction
        # 1 - b^count in f32, on the count's device (no host sync)
        c1 = 1.0 - torch.pow(self.b1, state.count)
        c2 = 1.0 - torch.pow(self.b2, state.count)
        for p, mu, nu in zip(params, state.mu, state.nu):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            upd = (mu / c1) / (torch.sqrt(nu / c2 + self.eps_root) + self.eps)
            p.add_(upd * -self.learning_rate)

    # -- the optax state: (ScaleByAdamState(count, mu, nu), EmptyState()) --
    @staticmethod
    def state_leaf_count(n_leaves: int) -> int:
        """Optax leaves over ``n_leaves`` flax variable leaves."""
        return 1 + 2 * n_leaves

    @staticmethod
    def flax_state_leaves(module: torch.nn.Module,
                          state: AdamState) -> List[np.ndarray]:
        """``count``, then the ``mu`` leaves, then the ``nu`` leaves."""
        return ([np.asarray(state.count.cpu().numpy(), np.int32)]
                + flax_state_leaves(module, state.mu)
                + flax_state_leaves(module, state.nu))

    @staticmethod
    def load_flax_state(module: torch.nn.Module, leaves) -> AdamState:
        leaves = list(leaves)
        n = flax_leaf_count(module)
        if len(leaves) < 1 + 2 * n:
            raise ValueError(f"{len(leaves)} adam leaves for {n} variables "
                             f"(count, mu and nu take {1 + 2 * n})")
        count = np.asarray(leaves[0])
        if count.shape != () or count.dtype.kind not in "iu":
            raise ValueError(f"the adam count leaf is {count.dtype} "
                             f"{count.shape}, not an int32 scalar")
        dev = next(module.parameters()).device
        return AdamState(
            torch.tensor(int(count), dtype=torch.int32, device=dev),
            load_flax_state(module, leaves[1:1 + n], "adam mu"),
            load_flax_state(module, leaves[1 + n:1 + 2 * n], "adam nu"))


class SGD(NamedTuple):
    """``optax.sgd(learning_rate, momentum)``: no state without momentum,
    else one ``trace`` per parameter. A parameter without a
    gradient steps with a zero one, as optax steps it."""
    learning_rate: float = 0.01
    momentum: Optional[float] = None

    def init(self, params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        if self.momentum is None:
            return []
        return [torch.zeros_like(p, memory_format=torch.contiguous_format)
                for p in params]

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor],
             state: Sequence[torch.Tensor]) -> None:
        """Update ``params`` (and the traces) in place from their
        ``.grad``."""
        if self.momentum is None:
            for p in params:
                if p.grad is not None:
                    p.add_(p.grad * -self.learning_rate)
            return
        for p, trace in zip(params, state):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            trace.copy_(g + self.momentum * trace)
            p.add_(trace * -self.learning_rate)

    # -- the optax state: (TraceState(trace), EmptyState()) with momentum,
    # -- (EmptyState(), EmptyState()) without
    def state_leaf_count(self, n_leaves: int) -> int:
        """Optax leaves over ``n_leaves`` flax variable leaves."""
        return 0 if self.momentum is None else n_leaves

    def flax_state_leaves(self, module: torch.nn.Module,
                          state) -> List[np.ndarray]:
        """The ``trace`` leaves (none without momentum)."""
        if self.momentum is None:
            return []
        return flax_state_leaves(module, state)

    def load_flax_state(self, module: torch.nn.Module,
                        leaves) -> List[torch.Tensor]:
        if self.momentum is None:
            return []
        return load_flax_state(module, leaves, "sgd trace")
