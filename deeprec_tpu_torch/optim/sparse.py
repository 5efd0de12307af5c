"""Sparse optimizers for EmbeddingVariable rows.

Port of part of ``deeprec_tpu/optim/sparse.py``: :class:`SparseOptimizer`,
``_lr_at``, ``_dest``, ``_scatter_set`` and :func:`sparse_adagrad_fused`.

Semantics as there: updates apply to deduplicated rows (autograd already
summed the gradients of repeated ids onto the unique lanes); lanes not
admitted are skipped (``mask``); ``cur_rows`` are the effective current
rows under lazy init, so a created row persists init + update in one
write, and its optimizer state starts from the init value. An updater is
``(values, slot_state, slots, grads, mask, step, cur_rows=None,
created=None) -> (values, slot_state)``; here it updates ``values`` in
place and returns it.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Union

import torch

from ..ops.gather import gather_rows

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
