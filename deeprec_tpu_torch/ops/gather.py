"""Kernel K1: embedding row gather.

``gather_rows(values, slots, d_out)`` is ``values[clamp(slots, 0, R-1),
:d_out]``. It replaces the Pallas TPU kernel
``deeprec_tpu/ops/pallas_gather.py`` ``gather_rows``. On a CUDA tensor it
launches the hand-written kernel ``csrc/gather_rows.cu`` (bound by HBM
bytes at large row counts, by the launch and one round trip of the slot
and row loads at small ones; several rows in flight a thread, one wave
of blocks, a programmatic dependent launch); on a CPU tensor it runs
:func:`gather_rows_plain`, the plain PyTorch version the tests and the
card smoke compare the kernel with. ``values`` may be a view with a row
stride wider than ``d_out`` (the serving table keeps fused optimizer
columns after the embedding): only the first ``d_out`` columns are read,
so the slice costs no extra copy.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build


def gather_rows_plain(values: torch.Tensor, slots: torch.Tensor,
                      d_out: int) -> torch.Tensor:
    return values[slots.clamp(0, values.shape[0] - 1), :d_out]


def _check(values: torch.Tensor, slots: torch.Tensor, d_out: int) -> None:
    if values.dim() != 2 or values.stride(1) != 1:
        raise ValueError("values must be [R, C] with unit column stride")
    if values.shape[0] == 0:
        raise ValueError("values has no rows")
    if slots.dim() != 1 or slots.dtype not in (torch.int32, torch.int64):
        raise ValueError("slots must be a 1-D int32/int64 tensor")
    if not 0 < d_out <= values.shape[1]:
        raise ValueError(f"d_out={d_out} outside (0, {values.shape[1]}]")
    if slots.device != values.device:
        raise ValueError("values and slots are on different devices")


def _unit(*byte_counts: int) -> int:
    """Widest vector load (bytes) that divides every count."""
    for unit in (16, 8, 4, 2):
        if all(b % unit == 0 for b in byte_counts):
            return unit
    return 1


def gather_rows(values: torch.Tensor, slots: torch.Tensor,
                d_out: Optional[int] = None) -> torch.Tensor:
    """``[N, d_out]`` rows ``values[clamp(slots[i], 0, R-1), :d_out]``."""
    d_out = values.shape[1] if d_out is None else d_out
    _check(values, slots, d_out)
    if values.device.type == "cpu":
        return gather_rows_plain(values, slots, d_out)
    if values.device.type != "cuda":
        raise ValueError(f"gather_rows: unsupported device {values.device}")
    slots = slots.contiguous()
    n = slots.shape[0]
    out = torch.empty((n, d_out), dtype=values.dtype, device=values.device)
    if n == 0:  # no rows: nothing to launch
        return out
    es = values.element_size()
    row_bytes, ld_bytes = d_out * es, values.stride(0) * es
    unit = _unit(row_bytes, ld_bytes, values.data_ptr(), out.data_ptr())
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.library().deeprec_gather_rows(
            values.data_ptr(), ld_bytes, values.shape[0], slots.data_ptr(),
            int(slots.dtype == torch.int64), n, row_bytes, out.data_ptr(),
            unit, stream)
    _build.check(err, "gather_rows")
    gather_rows.launches += 1
    return out


#: kernel launches (CUDA path only), read by the card smoke
gather_rows.launches = 0
