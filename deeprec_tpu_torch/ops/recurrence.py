"""DIEN's GRU and AUGRU recurrences on the card, forward and backward.

``gru_scan(xs, mask, weights, att)`` runs the recurrence of
``models.layers.GRUCellP`` over ``xs [B, L, d]`` from ``h = 0``, holding
``h`` where ``mask [B, L]`` is False; with ``att [B, L]`` the update gate is
scaled by the step's attention weight (the AUGRU). ``weights`` are the
cell's ``(gates.weight, gates.bias, cand.weight, cand.bias)`` in their
``nn.Linear`` layout (columns ``[x | h]``). It launches the forward kernel of
``csrc/gru_scan.cu``; ``gru_scan_backward`` launches its backward kernel,
and :class:`GRUScanFunction` puts them under autograd, the weight and bias
gradients being one matrix product over all ``B L`` positions. Both take
float32
CUDA tensors of widths ``d`` and ``g`` up to :data:`MAX_WIDTH`, and raise on
anything else; neither reads a device value on the host.

The rows are handed to the kernels longest span first (the span: the last
valid step + 1), so a tile of rows stops near its rows' own length; no
row's arithmetic depends on the order.

:func:`scan` is what ``models.layers.GRU`` and ``AUGRU`` call on a CUDA
tensor; on any other device they run their loop (``GRU._scan``,
``AUGRU._scan``), the plain version the tests and the card smoke hold the
kernels to.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build

#: the widest ``d`` (input) and ``g`` (state) the kernels take
MAX_WIDTH = 64


def act_width(d: int, g: int) -> int:
    """Columns of the backward's ``act``: ``[x, h_{t-1}, r h_{t-1}, 1]``,
    zeros to a multiple of 4 (the kernel's ``act_width``)."""
    return (d + 2 * g + 1 + 3) // 4 * 4

Weights = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _check(xs: torch.Tensor, mask: torch.Tensor, weights: Weights,
           att: Optional[torch.Tensor]) -> None:
    if xs.dim() != 3:
        raise ValueError(f"xs must be [B, L, d], got {tuple(xs.shape)}")
    b, L, d = xs.shape
    wg, bg, wc, bc = weights
    g = wc.shape[0]
    shapes = {"mask": (mask, (b, L)), "gates.weight": (wg, (2 * g, d + g)),
              "gates.bias": (bg, (2 * g,)), "cand.weight": (wc, (g, d + g)),
              "cand.bias": (bc, (g,))}
    if att is not None:
        shapes["att"] = (att, (b, L))
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got "
                             f"{list(t.shape)}")
    if mask.dtype != torch.bool:
        raise ValueError(f"mask must be bool, not {mask.dtype}")
    floats = [xs, *weights] + ([att] if att is not None else [])
    for t in floats:
        if t.dtype != torch.float32:
            raise ValueError(f"gru_scan takes float32, not {t.dtype}")
    if not (1 <= d <= MAX_WIDTH and 1 <= g <= MAX_WIDTH):
        raise ValueError(f"gru_scan takes widths d, g in [1, {MAX_WIDTH}], "
                         f"got d {d}, g {g}")
    for t in (mask, *floats):
        if t.device.type != "cuda" or t.device != xs.device:
            raise ValueError(f"gru_scan launches a CUDA kernel on one card; "
                             f"got {t.device} (the modules' loop runs "
                             f"elsewhere)")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def row_order(mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(span, order)``: each row's last valid step + 1 (0 for a row with
    none), and the rows by span, longest first. int64, on the mask's
    device; no host sync."""
    L = mask.shape[1]
    steps = torch.arange(1, L + 1, device=mask.device)
    span = torch.where(mask, steps, 0).amax(1)
    return span, torch.argsort(span, descending=True)


def gru_scan(xs: torch.Tensor, mask: torch.Tensor, weights: Weights,
             att: Optional[torch.Tensor] = None, save: bool = False):
    """``(out, hs, gates, span, order)``. ``out``: the GRU's states ``[B,
    L, g]`` (``att`` None; ``hs`` is ``out``) or the AUGRU's last state
    ``[B, g]``. With ``save`` also what :func:`gru_scan_backward` reads:
    the states of each row's span (the AUGRU's ``hs``) and ``gates [B, L,
    3g]``, the activations of z (before ``att``), r and n at the valid
    positions (left unwritten at padded ones)."""
    _check(xs, mask, weights, att)
    b, L, d = xs.shape
    g = weights[2].shape[0]
    new = xs.new_empty
    hs = new((b, L, g)) if att is None or save else None
    last = new((b, g)) if att is not None else None
    gates = new((b, L, 3 * g)) if save else None
    out = hs if att is None else last
    if b == 0 or L == 0:  # nothing to launch; the AUGRU's state stays 0
        if last is not None:
            last.zero_()
        return out, hs, gates, None, None
    span, order = row_order(mask)
    xs, mask = xs.contiguous(), mask.contiguous()
    att = None if att is None else att.contiguous()
    wg, bg, wc, bc = (w.contiguous() for w in weights)
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.library().deeprec_gru_scan(
            xs.data_ptr(), mask.data_ptr(), _ptr(att), wg.data_ptr(),
            bg.data_ptr(), wc.data_ptr(), bc.data_ptr(), order.data_ptr(),
            span.data_ptr(), _ptr(hs), _ptr(last), _ptr(gates), b, L, d, g,
            stream)
    _build.check(err, "gru_scan")
    gru_scan.launches += 1
    return out, hs, gates, span, order


def gru_scan_backward(grad: torch.Tensor, xs: torch.Tensor,
                      mask: torch.Tensor, wg: torch.Tensor, wc: torch.Tensor,
                      att: Optional[torch.Tensor], hs: torch.Tensor,
                      gates: torch.Tensor, span: torch.Tensor,
                      order: torch.Tensor):
    """``(dx [B, L, d], d_att [B, L] or None, d_pre [B, L, 3g], act [B, L,
    W])`` of :func:`gru_scan`'s ``save`` call on ``xs`` given its output's
    gradient ``grad`` (``wg``, ``wc``: the gates' and the candidate's
    weights): ``d_pre`` the gradients of z, r and n before their
    activations, ``act`` ``[x_t, h_{t-1}, r h_{t-1}, 1, 0...]``
    (:func:`act_width` columns), both zero at padded positions: the weight
    and bias gradients are ``d_pre^T act``."""
    b, L, g = hs.shape
    d = xs.shape[-1]
    want = (b, L, g) if att is None else (b, g)
    if tuple(grad.shape) != want:
        raise ValueError(f"grad must be {list(want)}, got "
                         f"{list(grad.shape)}")
    if grad.dtype != torch.float32 or grad.device != hs.device:
        raise ValueError("grad must be float32 on the states' device")
    new, w = hs.new_empty, act_width(d, g)
    dx, d_pre, act = new((b, L, d)), new((b, L, 3 * g)), new((b, L, w))
    d_att = new((b, L)) if att is not None else None
    if b == 0 or L == 0:
        return dx, d_att, d_pre, act
    xs, mask, grad = xs.contiguous(), mask.contiguous(), grad.contiguous()
    att = None if att is None else att.contiguous()
    wg, wc = wg.contiguous(), wc.contiguous()
    with torch.cuda.device(hs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.library().deeprec_gru_scan_backward(
            mask.data_ptr(), _ptr(att), wg.data_ptr(), wc.data_ptr(),
            order.data_ptr(), span.data_ptr(), xs.data_ptr(), hs.data_ptr(),
            gates.data_ptr(), grad.data_ptr(), dx.data_ptr(),
            d_pre.data_ptr(), act.data_ptr(), _ptr(d_att), b, L, d, g, w,
            stream)
    _build.check(err, "gru_scan_backward")
    gru_scan_backward.launches += 1
    return dx, d_att, d_pre, act


#: kernel launches, read by the card smoke and the spans
gru_scan.launches = 0
gru_scan_backward.launches = 0


class GRUScanFunction(torch.autograd.Function):
    """:func:`gru_scan` with :func:`gru_scan_backward` as its backward; the
    weight gradients ``d_gates^T [x, h_{t-1}]`` and ``d_cand^T [x, r
    h_{t-1}]`` and the biases' sums are blocks of one product ``d_pre^T
    act`` over all ``B L`` positions."""

    @staticmethod
    def forward(ctx, xs, att, mask, wg, bg, wc, bc):
        out, hs, gates, span, order = gru_scan(xs, mask, (wg, bg, wc, bc),
                                               att, save=True)
        ctx.save_for_backward(xs, att, mask, wg, wc, hs, gates, span, order)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        xs, att, mask, wg, wc, hs, gates, span, order = ctx.saved_tensors
        d, g = xs.shape[-1], wc.shape[0]
        dx, d_att, d_pre, act = gru_scan_backward(
            grad, xs, mask, wg, wc, att, hs, gates, span, order)
        prod = d_pre.view(-1, 3 * g).T @ act.view(-1, act.shape[-1])
        dwg = prod[:2 * g, :d + g]
        dwc = torch.cat([prod[2 * g:, :d], prod[2 * g:, d + g:d + 2 * g]], 1)
        db = prod[:, d + 2 * g]
        return dx, d_att, None, dwg, db[:2 * g], dwc, db[2 * g:]


def scan(xs: torch.Tensor, mask: torch.Tensor, weights: Weights,
         att: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The recurrence as ``GRU``/``AUGRU`` compute it on a card: under
    autograd where an input or weight needs a gradient, else the forward
    kernel alone (nothing kept)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (xs, att, *weights)):
        return GRUScanFunction.apply(xs, att, mask, *weights)
    with torch.no_grad():
        return gru_scan(xs, mask, weights, att)[0]
