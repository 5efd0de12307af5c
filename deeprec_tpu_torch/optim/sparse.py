"""Sparse optimizers for EmbeddingVariable rows.

Port of ``deeprec_tpu/optim/sparse.py``: :class:`SparseOptimizer`,
``_lr_at``, ``_dest``, ``_scatter_set``, :func:`permute_slot_state`, the
twelve optimizers of ``REGISTRY`` (:func:`make` builds one by name) and
the :func:`group_lasso` wrapper.

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
``slot__<name>`` columns are the JAX package's. A slot state may be empty
(``sgd``, ``proximal_gd`` and the fused optimizers: ``()``), hold an int32
row leaf (``adagrad_decay``'s ``last_period``) or 0-d leaves (the beta
powers of ``adam_async`` and ``adam_fused``, saved as ``scalar__``
columns; they stay device tensors, advanced in place).
"""
from __future__ import annotations

import itertools
from typing import Any, Callable, NamedTuple, Union

import numpy as np
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




def sparse_sgd(learning_rate: Schedule = 0.01) -> SparseOptimizer:
    """Plain SGD, no slot state: ``v -= lr*g``. As in the JAX package the
    gradient is rounded to the table's dtype first and the difference
    taken in f32 (its f32 learning rate promotes a bf16 row)."""

    def init(values):
        return ()

    def apply(values, slot_state, slots, grads, mask, step,
              cur_rows=None, created=None):
        lr = _lr_at(learning_rate, step)
        cur = (cur_rows if cur_rows is not None
               else gather_rows(values, slots, grads.shape[-1]))
        new = cur.float() - lr * grads.to(cur.dtype).float()
        _scatter_set(values, _dest(slots, mask, values.shape[0]), new)
        return values, slot_state

    return SparseOptimizer("sgd", init, apply, fills=())


def sparse_adagrad_decay(learning_rate: Schedule = 0.05,
                         initial_accumulator_value: float = 0.1,
                         accumulator_decay_step: int = 10000,
                         accumulator_decay_rate: float = 0.9,
                         accumulator_baseline: float = 1e-7
                         ) -> SparseOptimizer:
    """AdagradDecay: every ``accumulator_decay_step`` global steps the
    accumulator is multiplied by ``accumulator_decay_rate``, floored at
    ``accumulator_baseline``. Rows decay lazily: a row catches up on the
    periods it missed since its last update, which the int32 slot leaf
    ``last_period`` (one value per row) records. Slot leaves ``{"acc",
    "last_period"}``; a row created this step starts from
    ``initial_accumulator_value``."""
    acc0 = float(initial_accumulator_value)

    def init(values):
        return {"acc": _full_f32(values, acc0),
                "last_period": torch.zeros((values.shape[0],),
                                           dtype=torch.int32,
                                           device=values.device)}

    def apply(values, slot_state, slots, grads, mask, step,
              cur_rows=None, created=None):
        lr = _lr_at(learning_rate, step)
        dest = _dest(slots, mask, values.shape[0])
        g = grads.float()
        period = int(step) // accumulator_decay_step
        # K1 copies rows of any element type: the int32 leaf as [cap+1, 1]
        last = gather_rows(slot_state["last_period"][:, None], slots)[:, 0]
        n = (period - last).clamp_min(0).float()
        decay = torch.pow(accumulator_decay_rate, n)[:, None]
        acc = gather_rows(slot_state["acc"], slots)
        if created is not None:
            acc = torch.where(created[:, None], acc0, acc)
        acc = torch.clamp_min(acc * decay, accumulator_baseline) + g * g
        new = _cur(values, slots, g, cur_rows) - lr * g * torch.rsqrt(acc)
        _scatter_set(values, dest, new)
        _scatter_set(slot_state["acc"], dest, acc)
        _scatter_set(slot_state["last_period"], dest,
                     torch.full_like(last, period))
        return values, slot_state

    return SparseOptimizer("adagrad_decay", init, apply,
                           fills={"acc": acc0, "last_period": 0})


def sparse_adagrad_decay_v2(learning_rate: Schedule = 0.05,
                            initial_accumulator_value: float = 0.1,
                            accumulator_decay_step: int = 100_000,
                            accumulator_decay_rate: float = 0.9
                            ) -> SparseOptimizer:
    """AdagradDecay V2: the decay floor is the initial accumulator value
    itself, so the effective learning rate never exceeds the initial
    one."""
    return sparse_adagrad_decay(
        learning_rate, initial_accumulator_value=initial_accumulator_value,
        accumulator_decay_step=accumulator_decay_step,
        accumulator_decay_rate=accumulator_decay_rate,
        accumulator_baseline=initial_accumulator_value,
    )._replace(name="adagrad_decay_v2")


def _adam_step(cur, g, m0, v0, b1p, b2p, lr, beta1, beta2, epsilon):
    """The bias-corrected Adam row update from 0-d beta powers (device
    tensors): ``(new rows, m, v)``."""
    alpha = lr * torch.sqrt(1.0 - b2p) / (1.0 - b1p)
    m = beta1 * m0 + (1.0 - beta1) * g
    v = beta2 * v0 + (1.0 - beta2) * g * g
    return cur - alpha * m / (torch.sqrt(v) + epsilon), m, v


def _beta_powers(values, beta1, beta2):
    return {"beta1_power": torch.tensor(beta1, dtype=torch.float32,
                                        device=values.device),
            "beta2_power": torch.tensor(beta2, dtype=torch.float32,
                                        device=values.device)}


def sparse_adam_async(learning_rate: Schedule = 0.001, beta1: float = 0.9,
                      beta2: float = 0.999, epsilon: float = 1e-8,
                      apply_sparse_rmsprop: bool = False
                      ) -> SparseOptimizer:
    """AdamAsync: slot leaves ``{"m", "v"}`` and the 0-d leaves
    ``beta1_power`` and ``beta2_power``, which every apply advances
    (whatever the mask) instead of deriving them from the global step.
    With ``apply_sparse_rmsprop`` the update skips the bias correction:
    ``v -= lr*m*rsqrt(v_slot + eps)``."""

    def init(values):
        return {"m": _full_f32(values, 0.0), "v": _full_f32(values, 0.0),
                **_beta_powers(values, beta1, beta2)}

    def apply(values, slot_state, slots, grads, mask, step,
              cur_rows=None, created=None):
        lr = _lr_at(learning_rate, step)
        g = grads.float()
        dest = _dest(slots, mask, values.shape[0])
        cur = _cur(values, slots, g, cur_rows)
        m0 = gather_rows(slot_state["m"], slots)
        v0 = gather_rows(slot_state["v"], slots)
        b1p, b2p = slot_state["beta1_power"], slot_state["beta2_power"]
        if apply_sparse_rmsprop:
            v = beta2 * v0 + (1.0 - beta2) * g * g
            m = beta1 * m0 + (1.0 - beta1) * g
            new = cur - lr * m * torch.rsqrt(v + epsilon)
        else:
            new, m, v = _adam_step(cur, g, m0, v0, b1p, b2p, lr, beta1,
                                   beta2, epsilon)
        _scatter_set(values, dest, new)
        _scatter_set(slot_state["m"], dest, m)
        _scatter_set(slot_state["v"], dest, v)
        b1p.mul_(beta1)  # in place on the device, whatever the mask
        b2p.mul_(beta2)
        return values, slot_state

    return SparseOptimizer("adam_async", init, apply,
                           fills={"m": 0.0, "v": 0.0, "beta1_power": 0.0,
                                  "beta2_power": 0.0})


def sparse_adam_fused(learning_rate: Schedule = 0.001, beta1: float = 0.9,
                      beta2: float = 0.999, epsilon: float = 1e-8
                      ) -> SparseOptimizer:
    """Adam with ``m`` and ``v`` in the values array's fused slot columns
    (``[value | m | v]``; one row read through K1 and one write per step)
    and the beta powers as 0-d leaves, as :func:`sparse_adam_async` keeps
    them. Pair with ``EmbeddingVariableConfig(fused_slot_columns=2*dim,
    fused_slot_init=0.0)``; lookups read only the first ``dim``
    columns."""

    def init(values):
        return _beta_powers(values, beta1, beta2)

    def apply(values, slot_state, slots, grads, mask, step,
              cur_rows=None, created=None):
        lr = _lr_at(learning_rate, step)
        g = grads.float()
        dim = g.shape[-1]
        full = gather_rows(values, slots)      # K1: value, m and v
        mv = full[:, dim:].float()
        if created is not None:
            # lazy-init rows hold zeros; their logical m0 = v0 = 0 already
            mv = torch.where(created[:, None], 0.0, mv)
        cur = (cur_rows if cur_rows is not None else full[:, :dim]).float()
        b1p, b2p = slot_state["beta1_power"], slot_state["beta2_power"]
        new, m, v = _adam_step(cur, g, mv[:, :dim], mv[:, dim:], b1p, b2p,
                               lr, beta1, beta2, epsilon)
        _scatter_set(values, _dest(slots, mask, values.shape[0]),
                     torch.cat([new, m, v], -1))
        b1p.mul_(beta1)
        b2p.mul_(beta2)
        return values, slot_state

    return SparseOptimizer("adam_fused", init, apply,
                           fills={"beta1_power": beta1,
                                  "beta2_power": beta2})


def _prox(prox, lr, l1, l2):
    """The l1/l2 proximal operator: ``sign(p) / (1 + lr*l2) *
    max(|p| - lr*l1, 0)`` (``lr`` a float or a per-element tensor)."""
    return (torch.sign(prox) / (1.0 + lr * l2)
            * torch.clamp_min(prox.abs() - lr * l1, 0.0))


def sparse_proximal_gradient_descent(
        learning_rate: Schedule = 0.01,
        l1_regularization_strength: float = 0.0,
        l2_regularization_strength: float = 0.0) -> SparseOptimizer:
    """ProximalGradientDescent, no slot state: a gradient step, then the
    l1/l2 proximal operator."""
    l1 = np.float32(l1_regularization_strength)
    l2 = np.float32(l2_regularization_strength)

    def init(values):
        return ()

    def apply(values, slot_state, slots, grads, mask, step,
              cur_rows=None, created=None):
        # the JAX package's f32 scalar arithmetic (lr*l2, lr*l1)
        lr = np.float32(_lr_at(learning_rate, step))
        g = grads.float()
        prox = _cur(values, slots, g, cur_rows) - float(lr) * g
        new = _prox(prox, lr, l1, l2)
        _scatter_set(values, _dest(slots, mask, values.shape[0]), new)
        return values, slot_state

    return SparseOptimizer("proximal_gd", init, apply, fills=())


def sparse_proximal_adagrad(learning_rate: Schedule = 0.05,
                            initial_accumulator_value: float = 0.1,
                            l1_regularization_strength: float = 0.0,
                            l2_regularization_strength: float = 0.0
                            ) -> SparseOptimizer:
    """ProximalAdagrad, slot leaf ``{"acc"}``: ``acc += g^2; lr_t = lr *
    rsqrt(acc)``, a gradient step at ``lr_t``, then the proximal operator
    at ``lr_t``. A row created this step starts from
    ``initial_accumulator_value``."""
    acc0 = float(initial_accumulator_value)
    l1 = np.float32(l1_regularization_strength)
    l2 = np.float32(l2_regularization_strength)

    def init(values):
        return {"acc": _full_f32(values, acc0)}

    def apply(values, slot_state, slots, grads, mask, step,
              cur_rows=None, created=None):
        lr = _lr_at(learning_rate, step)
        g = grads.float()
        acc = gather_rows(slot_state["acc"], slots)
        if created is not None:
            acc = torch.where(created[:, None], acc0, acc)
        acc = acc + g * g
        lr_t = lr * torch.rsqrt(acc)
        new = _prox(_cur(values, slots, g, cur_rows) - lr_t * g, lr_t, l1, l2)
        dest = _dest(slots, mask, values.shape[0])
        _scatter_set(values, dest, new)
        _scatter_set(slot_state["acc"], dest, acc)
        return values, slot_state

    return SparseOptimizer("proximal_adagrad", init, apply,
                           fills={"acc": acc0})


def sparse_momentum(learning_rate: Schedule = 0.01, momentum: float = 0.9,
                    use_nesterov: bool = False) -> SparseOptimizer:
    """Momentum, slot leaf ``{"mom"}``: ``mom = momentum*mom + g``, then
    ``v -= lr*mom`` (Nesterov: ``v -= lr*(g + momentum*mom)``)."""

    def init(values):
        return {"mom": _full_f32(values, 0.0)}

    def apply(values, slot_state, slots, grads, mask, step,
              cur_rows=None, created=None):
        lr = _lr_at(learning_rate, step)
        g = grads.float()
        mom = momentum * gather_rows(slot_state["mom"], slots) + g
        cur = _cur(values, slots, g, cur_rows)
        new = (cur - lr * (g + momentum * mom) if use_nesterov
               else cur - lr * mom)
        dest = _dest(slots, mask, values.shape[0])
        _scatter_set(values, dest, new)
        _scatter_set(slot_state["mom"], dest, mom)
        return values, slot_state

    return SparseOptimizer("momentum", init, apply, fills={"mom": 0.0})


def group_lasso(inner: SparseOptimizer, strength: float) -> SparseOptimizer:
    """Group-lasso proximal wrapper: after ``inner``'s update each touched
    row, read back through K1 at its full width (fused slot columns
    included, as the JAX package reads ``values[slots]``), is scaled by
    ``max(0, 1 - strength / max(||row||, 1e-12))``. The JAX docstring
    speaks of ``strength*lr``; its code, ported here, takes ``strength``
    alone. Slot state ``{"inner": inner's}``."""

    def init(values):
        return {"inner": inner.init(values)}

    def apply(values, slot_state, slots, grads, mask, step,
              cur_rows=None, created=None):
        values, inner_state = inner.apply(values, slot_state["inner"], slots,
                                          grads, mask, step,
                                          cur_rows=cur_rows, created=created)
        rows = gather_rows(values, slots).float()
        norm = torch.sqrt((rows * rows).sum(-1, keepdim=True))
        scale = torch.clamp_min(1.0 - strength / norm.clamp_min(1e-12), 0.0)
        _scatter_set(values, _dest(slots, mask, values.shape[0]),
                     rows * scale)
        return values, {"inner": inner_state}

    return SparseOptimizer(f"group_lasso({inner.name})", init, apply,
                           fills={"inner": inner.fills})


REGISTRY = {
    "sgd": sparse_sgd,
    "adagrad": sparse_adagrad,
    "adagrad_fused": sparse_adagrad_fused,
    "adagrad_decay": sparse_adagrad_decay,
    "adagrad_decay_v2": sparse_adagrad_decay_v2,
    "adam": sparse_adam,
    "adam_fused": sparse_adam_fused,
    "adam_async": sparse_adam_async,
    "ftrl": sparse_ftrl,
    "momentum": sparse_momentum,
    "proximal_gd": sparse_proximal_gradient_descent,
    "proximal_adagrad": sparse_proximal_adagrad,
}


def make(name: str, **kwargs) -> SparseOptimizer:
    """The sparse optimizer registered as ``name``, built with
    ``kwargs``."""
    return REGISTRY[name](**kwargs)
