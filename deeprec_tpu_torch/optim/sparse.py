"""Sparse optimizers for EmbeddingVariable rows.

Port of part of ``deeprec_tpu/optim/sparse.py``: :class:`SparseOptimizer`,
``_lr_at``, ``_dest``, ``_scatter_set``, :func:`permute_slot_state`,
:func:`sparse_adagrad`, :func:`sparse_adam`, :func:`sparse_ftrl`,
:func:`sparse_adagrad_fused`, ``REGISTRY`` and :func:`make` (over the
names ported so far).

Semantics as there: updates apply to deduplicated rows (autograd already
summed the gradients of repeated ids onto the unique lanes); lanes not
admitted are skipped (``mask``); ``cur_rows`` are the effective current
rows under lazy init, so a created row persists init + update in one
write, and its optimizer state starts from the init value. An updater is
``(values, slot_state, slots, grads, mask, step, cur_rows=None,
created=None) -> (values, slot_state)``; here it updates ``values`` and
the slot leaves in place and returns them. Row reads of the values and of
each slot leaf go through kernel K1 (``gather_rows``), writes through
:func:`_scatter_set`. Slot dicts keep the JAX names, so a save's
``slot__<name>`` columns are the JAX package's.
"""
from __future__ import annotations

import itertools
from typing import Any, Callable, NamedTuple, Union

import torch

from ..ops.gather import gather_rows
from ..sparse import embedding_var as ev
from ..utils.tree import leaves_with_paths, map_leaves

Schedule = Union[float, Callable[[int], float]]


def _lr_at(lr: Schedule, step: int) -> float:
    return float(lr(step) if callable(lr) else lr)


class SparseOptimizer(NamedTuple):
    name: str
    init: Callable[[torch.Tensor], Any]     # values -> slot state
    apply: Callable[..., tuple]             # see the module docstring
    # per-leaf initial fill values of the slot state (unclaimed rows hold
    # them); empty for optimizers whose state lives in the value rows
    fills: Any = ()


def _dest(slots: torch.Tensor, mask: torch.Tensor,
          nrows: int) -> torch.Tensor:
    """Write destination: masked-out lanes point one past the last row
    (dropped by :func:`_scatter_set`)."""
    return torch.where(mask, slots, nrows)


def _scatter_set(arr: torch.Tensor, dest: torch.Tensor,
                 rows: torch.Tensor) -> None:
    """``arr[dest[i]] = rows[i]`` in place, dropping lanes with ``dest ==
    len(arr)``. The JAX package does this with an XLA scatter, not a Pallas
    kernel, so it stays plain PyTorch (``index_copy_``). To drop lanes
    without a host sync, they are routed to the last row (the null row,
    which no kept lane targets) and that row is restored afterwards. The
    kept destinations are unique (deduplicated admitted slots)."""
    last = arr.shape[0] - 1
    saved = arr[last].clone()
    arr.index_copy_(0, dest.clamp(max=last).long(), rows.to(arr.dtype))
    arr[last] = saved


def permute_slot_state(slot_state, old_to_new: torch.Tensor, new_cap: int,
                       fills=None):
    """Carry optimizer slot rows through a growth or eviction rebuild
    (``ev.permute_rows`` on every leaf with one row per slot; other leaves,
    such as scalars, pass through). ``fills`` is the optimizer's
    ``SparseOptimizer.fills`` tree: fresh rows take each leaf's init value,
    so a key that later claims one starts from it (0 when None)."""
    old_rows = int(old_to_new.shape[0]) + 1
    fill_vals = ([leaf for _, leaf in leaves_with_paths(fills)]
                 if fills is not None else None)
    k = itertools.count()

    def fix(_, leaf):
        fill = fill_vals[next(k)] if fill_vals is not None else 0
        if isinstance(leaf, torch.Tensor) and leaf.dim() >= 1 \
                and leaf.shape[0] == old_rows:
            return ev.permute_rows(leaf, old_to_new, new_cap, fill=fill)
        return leaf
    return map_leaves(fix, slot_state)


def _cur(values, slots, grads, cur_rows):
    """The rows the update starts from, in f32: ``cur_rows`` (lazy init's
    effective rows) or the stored rows, read through K1."""
    if cur_rows is None:
        cur_rows = gather_rows(values, slots, grads.shape[-1])
    return cur_rows.float()


def _full_f32(values, fill):
    return torch.full(values.shape, fill, dtype=torch.float32,
                      device=values.device)


def sparse_adagrad(learning_rate: Schedule = 0.05,
                   initial_accumulator_value: float = 0.1
                   ) -> SparseOptimizer:
    """Adagrad with the accumulator in its own slot leaf ``{"acc"}``:
    ``a += g^2; v -= lr*g*rsqrt(a)``. A row created this step starts from
    ``initial_accumulator_value`` whatever the store holds."""
    acc0 = float(initial_accumulator_value)

    def init(values):
        return {"acc": _full_f32(values, acc0)}

    def apply(values, slot_state, slots, grads, mask, step,
              cur_rows=None, created=None):
        lr = _lr_at(learning_rate, step)
        dest = _dest(slots, mask, values.shape[0])
        g = grads.float()
        acc = gather_rows(slot_state["acc"], slots)
        if created is not None:
            acc = torch.where(created[:, None], acc0, acc)
        acc = acc + g * g
        new = _cur(values, slots, g, cur_rows) - lr * g * torch.rsqrt(acc)
        _scatter_set(values, dest, new)
        _scatter_set(slot_state["acc"], dest, acc)
        return values, slot_state

    return SparseOptimizer("adagrad", init, apply, fills={"acc": acc0})


def sparse_adam(learning_rate: Schedule = 0.001, beta1: float = 0.9,
                beta2: float = 0.999, epsilon: float = 1e-8
                ) -> SparseOptimizer:
    """Adam with slot leaves ``{"m", "v"}``. Bias correction comes from the
    global step, ``t = step + 1``, not from a per-row count (the EV branch
    passes global_step into the kernel): ``alpha = lr*sqrt(1-b2^t) /
    (1-b1^t)``, computed in f32 as the JAX package does."""

    def init(values):
        return {"m": _full_f32(values, 0.0), "v": _full_f32(values, 0.0)}

    def apply(values, slot_state, slots, grads, mask, step,
              cur_rows=None, created=None):
        f32 = torch.float32
        lr = torch.tensor(_lr_at(learning_rate, step), dtype=f32)
        t = torch.tensor(step + 1.0, dtype=f32)
        b1p = torch.pow(torch.tensor(beta1, dtype=f32), t)
        b2p = torch.pow(torch.tensor(beta2, dtype=f32), t)
        alpha = float(lr * torch.sqrt(1.0 - b2p) / (1.0 - b1p))
        g = grads.float()
        dest = _dest(slots, mask, values.shape[0])
        m = beta1 * gather_rows(slot_state["m"], slots) + (1.0 - beta1) * g
        v = (beta2 * gather_rows(slot_state["v"], slots)
             + (1.0 - beta2) * g * g)
        new = _cur(values, slots, g, cur_rows) \
            - alpha * m / (torch.sqrt(v) + epsilon)
        _scatter_set(values, dest, new)
        _scatter_set(slot_state["m"], dest, m)
        _scatter_set(slot_state["v"], dest, v)
        return values, slot_state

    return SparseOptimizer("adam", init, apply, fills={"m": 0.0, "v": 0.0})


def sparse_ftrl(learning_rate: Schedule = 0.1,
                learning_rate_power: float = -0.5,
                initial_accumulator_value: float = 0.1,
                l1_regularization_strength: float = 0.0,
                l2_regularization_strength: float = 0.0) -> SparseOptimizer:
    """FTRL-proximal with slot leaves ``{"accum", "linear"}``: the wide
    (linear) tower's optimizer of WDL and DeepFM. A row created this step
    starts from ``initial_accumulator_value``."""
    l1, l2 = l1_regularization_strength, l2_regularization_strength
    acc0 = float(initial_accumulator_value)
    p = -learning_rate_power

    def init(values):
        return {"accum": _full_f32(values, acc0),
                "linear": _full_f32(values, 0.0)}

    def apply(values, slot_state, slots, grads, mask, step,
              cur_rows=None, created=None):
        lr = _lr_at(learning_rate, step)
        g = grads.float()
        dest = _dest(slots, mask, values.shape[0])
        accum = gather_rows(slot_state["accum"], slots)
        if created is not None:
            accum = torch.where(created[:, None], acc0, accum)
        linear = gather_rows(slot_state["linear"], slots)
        cur = _cur(values, slots, g, cur_rows)
        new_accum = accum + g * g
        sigma = (torch.pow(new_accum, p) - torch.pow(accum, p)) / lr
        new_linear = linear + g - sigma * cur
        quad = torch.pow(new_accum, p) / lr + 2.0 * l2
        l1_reg = (new_linear.clamp(-l1, l1) if l1 > 0
                  else torch.zeros_like(new_linear))
        new = (l1_reg - new_linear) / quad
        if l1 > 0:
            new = torch.where(new_linear.abs() > l1, new, 0.0)
        _scatter_set(values, dest, new)
        _scatter_set(slot_state["accum"], dest, new_accum)
        _scatter_set(slot_state["linear"], dest, new_linear)
        return values, slot_state

    return SparseOptimizer("ftrl", init, apply,
                           fills={"accum": acc0, "linear": 0.0})


def sparse_adagrad_fused(learning_rate: Schedule = 0.05,
                         initial_accumulator_value: float = 0.1
                         ) -> SparseOptimizer:
    """Adagrad with the accumulator stored in the values array's fused slot
    columns (the reference's ValuePtr row layout): one row read through
    kernel K1 and one row write per step. ``a += g^2; v -= lr*g*rsqrt(a)``.

    Pair with ``EmbeddingVariableConfig(fused_slot_columns=dim,
    fused_slot_init=initial_accumulator_value)``.
    """
    acc0 = float(initial_accumulator_value)

    def init(values):
        return ()  # slot state lives inside the values array

    def apply(values, slot_state, slots, grads, mask, step,
              cur_rows=None, created=None):
        lr = _lr_at(learning_rate, step)
        g = grads.float()
        dim = g.shape[-1]
        full = gather_rows(values, slots)      # K1: value + accumulator
        acc_raw = full[:, dim:].float()
        if created is not None:
            # lazy-init rows hold zeros; their logical accumulator is acc0
            acc_raw = torch.where(created[:, None], acc0, acc_raw)
        acc = acc_raw + g * g
        cur = (cur_rows if cur_rows is not None else full[:, :dim]).float()
        new = cur - lr * g * torch.rsqrt(acc)
        _scatter_set(values, _dest(slots, mask, values.shape[0]),
                     torch.cat([new, acc], -1))
        return values, slot_state

    return SparseOptimizer("adagrad_fused", init, apply, fills=())


REGISTRY = {
    "adagrad": sparse_adagrad,
    "adagrad_fused": sparse_adagrad_fused,
    "adam": sparse_adam,
    "ftrl": sparse_ftrl,
}

# the JAX package's other sparse optimizers, still to port
_NOT_PORTED = ("sgd", "adagrad_decay", "adagrad_decay_v2", "adam_fused",
               "adam_async", "momentum", "proximal_gd", "proximal_adagrad")


def make(name: str, **kwargs) -> SparseOptimizer:
    """The sparse optimizer registered as ``name``, built with ``kwargs``.
    Raises ``NotImplementedError`` for a JAX-package optimizer that is not
    ported yet, ``KeyError`` for an unknown name."""
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"sparse optimizer {name!r} is not ported to deeprec_tpu_torch "
            f"yet; ported: {sorted(REGISTRY)}")
    return REGISTRY[name](**kwargs)
