"""Kernel K2: fused gather + pool.

``fused_pooled_lookup(values, slots, valid, combiner)`` pools, for each bag
``b``, the rows ``values[clamp(slots[b, k], 0, R-1)]`` of its valid lanes:
``sum``, ``mean`` (÷ ``max(n, 1)``) or ``sqrtn`` (÷ ``sqrt(max(n, 1))``);
an all-invalid bag gives 0. It replaces the Pallas TPU kernel
``deeprec_tpu/ops/pallas_fused_lookup.py`` ``fused_pooled_lookup``. On a
CUDA tensor it launches the hand-written kernel
``csrc/fused_pooled_lookup.cu`` (bound by HBM bytes: valid rows read +
pooled rows written; the ``[B*w, D]`` expanded rows are never written); on
a CPU tensor it runs :func:`fused_pooled_lookup_plain`, the plain PyTorch
version the tests and the card smoke compare the kernel with. ``slots``
and ``valid`` may be strided views.

The backward, ``fused_pooled_lookup_backward`` (``d_values [R, D]`` from
``d_pooled [B, D]``), is the port's own kernel in the same source: the
Pallas kernel has no VJP. Its result is a function of its inputs: it adds
no float atomics, so two runs of one training stream stay bit-equal, as
the JAX package's XLA scatter-adds do.

On the card both directions take float32 and bfloat16 (a
``value_dtype="bfloat16"`` table) and raise for any other dtype. A bf16
forward adds the rows in f32, applies the combiner in f32 and rounds the
pooled row once to bf16, as :func:`fused_pooled_lookup_plain` (torch's
CPU bf16 sum accumulates in f32) and the JAX package's XLA path do; the
Pallas kernel's accumulator has the table's dtype, which the port does
not copy. A bf16 backward widens ``d_pooled`` to f32 as it loads it, sums
each row in f32 and rounds it once to bf16 as it writes it (autograd wants
the dtype of ``values``). :func:`pooled_lookup` is the differentiable
entry, a ``torch.autograd.Function`` whose forward is K2 and whose
backward is that kernel; the collections pool through it.
"""
from __future__ import annotations

import functools

import torch

from . import _build

COMBINERS = ("sum", "mean", "sqrtn")
CARD_DTYPES = (torch.float32, torch.bfloat16)  # what the CUDA kernels take


def fused_pooled_lookup_plain(values: torch.Tensor, slots: torch.Tensor,
                              valid: torch.Tensor,
                              combiner: str) -> torch.Tensor:
    """Sums and scales in f32 (bf16 rows are widened) and rounds the result
    to the values' dtype once."""
    rows = values[slots.clamp(0, values.shape[0] - 1)].float()  # [B, w, D]
    total = torch.where(valid[..., None], rows, 0).sum(1)
    if combiner != "sum":
        n = valid.sum(1, keepdim=True).clamp_min(1).float()
        total = total / (n if combiner == "mean" else n.sqrt())
    return total.to(values.dtype)


def _check(values, slots, valid, combiner) -> None:
    if combiner not in COMBINERS:
        raise ValueError(f"unknown combiner {combiner!r}")
    if values.dim() != 2 or values.stride(1) != 1 or values.shape[0] == 0:
        raise ValueError("values must be non-empty [R, D] with unit "
                         "column stride")
    if slots.dim() != 2 or slots.dtype not in (torch.int32, torch.int64):
        raise ValueError("slots must be a [B, w] int32/int64 tensor")
    if valid.shape != slots.shape or valid.dtype != torch.bool:
        raise ValueError("valid must be a bool tensor shaped like slots")
    if not slots.device == valid.device == values.device:
        raise ValueError("values, slots and valid are on different devices")


def fused_pooled_lookup(values: torch.Tensor, slots: torch.Tensor,
                        valid: torch.Tensor,
                        combiner: str = "mean") -> torch.Tensor:
    """``[B, D]`` pooled rows of ``values [R, D]`` over ``slots [B, w]``
    where ``valid [B, w]``."""
    _check(values, slots, valid, combiner)
    if values.device.type == "cpu":
        return fused_pooled_lookup_plain(values, slots, valid, combiner)
    if values.device.type != "cuda":
        raise ValueError(f"fused_pooled_lookup: unsupported device "
                         f"{values.device}")
    if values.dtype not in CARD_DTYPES:
        raise ValueError(f"the CUDA fused_pooled_lookup takes float32 or "
                         f"bfloat16 values, not {values.dtype}")
    n_bags, w = slots.shape
    d, ld = values.shape[1], values.stride(0)
    out = torch.empty((n_bags, d), dtype=values.dtype, device=values.device)
    bf16 = values.dtype == torch.bfloat16
    lanes = 8 if bf16 else 4  # of a 16-byte vector
    vec = int(d % lanes == 0 and ld % lanes == 0
              and values.data_ptr() % 16 == 0)
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.library().deeprec_fused_pooled_lookup(
            values.data_ptr(), ld, values.shape[0], d, slots.data_ptr(),
            int(slots.dtype == torch.int64), slots.stride(0),
            slots.stride(1), valid.data_ptr(), valid.stride(0),
            valid.stride(1), n_bags, w, COMBINERS.index(combiner),
            out.data_ptr(), vec, int(bf16), stream)
    _build.check(err, "fused_pooled_lookup")
    fused_pooled_lookup.launches += 1
    return out


def fused_pooled_lookup_backward_plain(d_pooled: torch.Tensor,
                                       slots: torch.Tensor,
                                       valid: torch.Tensor, combiner: str,
                                       n_rows: int) -> torch.Tensor:
    """Adds in f32 (a bf16 gradient is widened) and rounds the sums to the
    gradient's dtype once."""
    g = d_pooled.float()
    if combiner != "sum":
        n = valid.sum(1, keepdim=True).clamp_min(1).float()
        g = g / (n if combiner == "mean" else n.sqrt())
    lanes = torch.where(valid[..., None], g[:, None, :], 0)    # [B, w, D]
    out = torch.zeros((n_rows, d_pooled.shape[1]), dtype=torch.float32,
                      device=d_pooled.device)
    out.index_add_(0, slots.clamp(0, n_rows - 1).reshape(-1),
                   lanes.reshape(-1, d_pooled.shape[1]))
    return out.to(d_pooled.dtype)


def fused_pooled_lookup_backward(d_pooled: torch.Tensor,
                                 slots: torch.Tensor, valid: torch.Tensor,
                                 combiner: str, n_rows: int) -> torch.Tensor:
    """``[n_rows, D]`` gradient of :func:`fused_pooled_lookup` with respect
    to ``values``, given ``d_pooled [B, D]``, of ``d_pooled``'s dtype. On
    CUDA two kernels compute it: a cooperative one groups the valid lanes
    by row (a counting sort placed with integer atomics), and its
    dependent puts each row's lanes back in lane order and adds their
    terms in that order, with no float atomics, writing each row once
    (zeros where no valid lane lands). A row of at most 32 valid lanes
    adds them in lane order, as :func:`fused_pooled_lookup_backward_plain`'s
    ``index_add_`` does on the CPU, so its sum is bit-equal to the plain
    version's; a longer row adds contiguous runs of its lanes, then the
    runs in order. A bf16 ``d_pooled`` is summed in f32 and each row
    rounded once to bf16."""
    d_pooled = d_pooled.contiguous()  # autograd may hand an expanded view
    if n_rows <= 0 or d_pooled.dim() != 2 or \
            d_pooled.shape[0] != slots.shape[0]:
        raise ValueError("d_pooled must be [B, D] for slots [B, w] and "
                         "n_rows > 0")
    _check(d_pooled, slots, valid, combiner)
    if d_pooled.device.type == "cpu":
        return fused_pooled_lookup_backward_plain(d_pooled, slots, valid,
                                                  combiner, n_rows)
    if d_pooled.device.type != "cuda":
        raise ValueError(f"fused_pooled_lookup_backward: unsupported device "
                         f"{d_pooled.device}")
    if d_pooled.dtype not in CARD_DTYPES:
        raise ValueError(f"the CUDA fused_pooled_lookup_backward takes "
                         f"float32 or bfloat16 gradients, not "
                         f"{d_pooled.dtype}")
    n_bags, w = slots.shape
    if n_bags * w >= 2 ** 31 - 1 or n_rows >= 2 ** 31 - 1:
        raise ValueError("the CUDA fused_pooled_lookup_backward takes fewer "
                         "than 2^31 - 1 lanes and rows")
    d = d_pooled.shape[1]
    out = torch.empty((n_rows, d), dtype=d_pooled.dtype,
                      device=d_pooled.device)
    es = d_pooled.element_size()
    vec = next(v for v in (4, 2, 1) if d % v == 0
               and d_pooled.data_ptr() % (es * v) == 0)
    with torch.cuda.device(d_pooled.device):
        scratch = torch.empty(_scratch_bytes(n_bags, w, n_rows),
                              dtype=torch.uint8, device=d_pooled.device)
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.library().deeprec_fused_pooled_lookup_bwd(
            d_pooled.data_ptr(), d, slots.data_ptr(),
            int(slots.dtype == torch.int64), slots.stride(0), slots.stride(1),
            valid.data_ptr(), valid.stride(0), valid.stride(1), n_bags, w,
            COMBINERS.index(combiner), out.data_ptr(), n_rows, vec,
            int(d_pooled.dtype == torch.bfloat16), scratch.data_ptr(),
            stream)
    _build.check(err, "fused_pooled_lookup_backward")
    fused_pooled_lookup_backward.launches += 1
    return out


@functools.lru_cache(maxsize=64)
def _scratch_bytes(n_bags: int, w: int, n_rows: int) -> int:
    """The backward's scratch (each row's count and segment, the lanes
    grouped by row, a long row's lanes sorted, the bags' scales, the rows
    of more than 16 lanes listed)."""
    return max(1, _build.library().deeprec_fused_pooled_lookup_bwd_scratch(
        n_bags, w, n_rows))


class _PooledLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, slots, valid, combiner):
        ctx.save_for_backward(slots, valid)
        ctx.combiner = combiner
        ctx.n_rows = values.shape[0]
        return fused_pooled_lookup(values, slots, valid, combiner)

    @staticmethod
    def backward(ctx, d_pooled):
        slots, valid = ctx.saved_tensors
        d_values = fused_pooled_lookup_backward(d_pooled, slots, valid,
                                                ctx.combiner, ctx.n_rows)
        return d_values, None, None, None


def pooled_lookup(values: torch.Tensor, slots: torch.Tensor,
                  valid: torch.Tensor, combiner: str = "mean"
                  ) -> torch.Tensor:
    """:func:`fused_pooled_lookup` that autograd differentiates with
    respect to ``values`` through :func:`fused_pooled_lookup_backward`."""
    return _PooledLookup.apply(values, slots, valid, combiner)


#: kernel launches (CUDA path only), read by the card smoke
fused_pooled_lookup.launches = 0
fused_pooled_lookup_backward.launches = 0
