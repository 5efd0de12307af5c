"""DIN's attention unit on the card, forward and backward.

``din_attention(query, keys, mask, params, scale)`` gives the ``[B, L]``
attention weights of ``models.layers.DINAttention.weights``: each valid
history position ``t`` (``mask [B, L]``) of ``keys [B, L, g]`` is scored
against ``query [B, g]`` by the sigmoid MLP over ``[q, k, q - k, q * k]``
(``params``: ``(att_0.weight, att_0.bias, att_1.weight, att_1.bias,
att_out.weight, att_out.bias)`` in their ``nn.Linear`` layout), the score
times ``scale`` (``1 / sqrt(g)`` for DIN, 1 for DIEN's
``DINAttentionScores``), and a softmax over the example's valid positions
gives the weights, exactly 0 at padded ones (and on a row with none). It
launches the forward kernel of ``csrc/din_attention.cu``;
``din_attention_backward`` launches its backward, which returns the
query's, the keys' and every parameter's gradient, and
:class:`DINAttentionFunction` puts them under autograd. The kernels visit
the valid positions only and keep each position's activations on chip;
they sum the first layer in another order (the query's share once an
example; ``csrc/din_attention.cu``), float32 throughout. Both take float32
CUDA tensors of one card, key widths ``g`` up to :data:`MAX_WIDTH` and two
hidden layers of widths up to :data:`MAX_HIDDEN`, and raise on anything
else; neither reads a device value on the host.

:func:`attention` is what ``DINAttention.weights`` calls on any CUDA
tensor; on the CPU the module runs its plain code
(``DINAttention._plain``), the version the tests and the card smoke hold
the kernels to.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from . import _build

#: the widest keys and hidden layers the kernels take: the zoo's 80-40 at
#: the widest ``g`` whose backward fits a block's shared memory on an H100
MAX_WIDTH = 40
MAX_HIDDEN = (80, 40)

Params = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
               torch.Tensor, torch.Tensor]


def _check(query: torch.Tensor, keys: torch.Tensor, mask: torch.Tensor,
           params: Params) -> None:
    if keys.dim() != 3:
        raise ValueError(f"keys must be [B, L, g], got {tuple(keys.shape)}")
    b, L, g = keys.shape
    if len(params) != 6:
        raise ValueError("params are the two hidden layers' and att_out's "
                         f"weights and biases, six tensors; got {len(params)}")
    w1, b1, w2, b2, w3, b3 = params
    h1, h2 = w1.shape[0], w2.shape[0]
    shapes = {"query": (query, (b, g)), "mask": (mask, (b, L)),
              "att_0.weight": (w1, (h1, 4 * g)), "att_0.bias": (b1, (h1,)),
              "att_1.weight": (w2, (h2, h1)), "att_1.bias": (b2, (h2,)),
              "att_out.weight": (w3, (1, h2)), "att_out.bias": (b3, (1,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got "
                             f"{list(t.shape)}")
    if mask.dtype != torch.bool:
        raise ValueError(f"mask must be bool, not {mask.dtype}")
    floats = (query, keys, *params)
    for t in floats:
        if t.dtype != torch.float32:
            raise ValueError(f"din_attention takes float32, not {t.dtype}")
    if not (1 <= g <= MAX_WIDTH and 1 <= h1 <= MAX_HIDDEN[0]
            and 1 <= h2 <= MAX_HIDDEN[1]):
        raise ValueError(f"din_attention takes g in [1, {MAX_WIDTH}] and "
                         f"hidden widths up to {list(MAX_HIDDEN)}, got g "
                         f"{g}, hidden {h1}, {h2}")
    for t in (mask, *floats):
        if t.device.type != "cuda" or t.device != keys.device:
            raise ValueError(f"din_attention launches a CUDA kernel on one "
                             f"card; got {t.device} (the module's plain "
                             f"code runs on the CPU)")


@functools.cache
def _scratch_bytes(b: int, L: int, g: int, h1: int, h2: int,
                   backward: bool) -> int:
    """The kernels' scratch at these widths, asked of the library once a
    shape: a training step then makes no call that leaves Python but its
    two launches."""
    return _build.library().deeprec_din_attention_scratch(
        b, L, g, h1, h2, int(backward))


def _scratch(keys: torch.Tensor, h1: int, h2: int,
             backward: bool) -> torch.Tensor:
    n = _scratch_bytes(*keys.shape, h1, h2, backward)
    return torch.empty(n, dtype=torch.uint8, device=keys.device)


def din_attention(query: torch.Tensor, keys: torch.Tensor,
                  mask: torch.Tensor, params: Params,
                  scale: float) -> torch.Tensor:
    """The attention weights ``[B, L]``: the softmax over each example's
    valid positions of the MLP's scores times ``scale``; 0 where padded."""
    _check(query, keys, mask, params)
    b, L, g = keys.shape
    out = keys.new_empty((b, L))
    if b == 0 or L == 0:
        return out
    w1, b1, w2, b2, w3, b3 = (p.contiguous() for p in params)
    query, keys, mask = (t.contiguous() for t in (query, keys, mask))
    h1, h2 = w1.shape[0], w2.shape[0]
    scratch = _scratch(keys, h1, h2, False)
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.library().deeprec_din_attention(
            query.data_ptr(), keys.data_ptr(), mask.data_ptr(),
            w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            w3.data_ptr(), b3.data_ptr(), scale, out.data_ptr(),
            scratch.data_ptr(), b, L, g, h1, h2, stream)
    _build.check(err, "din_attention")
    din_attention.launches += 1
    return out


def din_attention_backward(grad: torch.Tensor, query: torch.Tensor,
                           keys: torch.Tensor, mask: torch.Tensor,
                           params: Params, weights: torch.Tensor,
                           scale: float):
    """``(d_query, d_keys, d_params)`` of :func:`din_attention`'s call on
    these inputs, ``weights`` its output and ``grad`` the output's
    gradient; ``d_keys`` 0 at padded positions, ``d_params`` one tensor a
    parameter, shaped as ``params``."""
    b, L, g = keys.shape
    if tuple(grad.shape) != (b, L) or tuple(weights.shape) != (b, L):
        raise ValueError(f"grad and weights must be [{b}, {L}], got "
                         f"{list(grad.shape)} and {list(weights.shape)}")
    if grad.dtype != torch.float32 or grad.device != keys.device:
        raise ValueError("grad must be float32 on the keys' device")
    w1, b1, w2, b2, w3, b3 = (p.contiguous() for p in params)
    h1, h2 = w1.shape[0], w2.shape[0]
    d_query, d_keys = query.new_empty((b, g)), keys.new_empty((b, L, g))
    flat = keys.new_empty(4 * g * h1 + h1 + h2 * h1 + 2 * h2 + 1)
    sizes = [t.numel() for t in (w1, b1, w2, b2, w3, b3)]
    d_params = tuple(t.view_as(p) for t, p in zip(flat.split(sizes),
                                                  params))
    if b == 0 or L == 0:
        d_query.zero_()
        flat.zero_()
        return d_query, d_keys, d_params
    query, keys, mask, grad, weights = (
        t.contiguous() for t in (query, keys, mask, grad, weights))
    scratch = _scratch(keys, h1, h2, True)
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.library().deeprec_din_attention_backward(
            query.data_ptr(), keys.data_ptr(), mask.data_ptr(),
            w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            w3.data_ptr(), weights.data_ptr(), grad.data_ptr(), scale,
            d_query.data_ptr(), d_keys.data_ptr(), flat.data_ptr(),
            scratch.data_ptr(), b, L, g, h1, h2, stream)
    _build.check(err, "din_attention_backward")
    din_attention_backward.launches += 1
    return d_query, d_keys, d_params


#: kernel launches, read by the card smoke and the spans
din_attention.launches = 0
din_attention_backward.launches = 0


class DINAttentionFunction(torch.autograd.Function):
    """:func:`din_attention` with :func:`din_attention_backward` as its
    backward."""

    @staticmethod
    def forward(ctx, query, keys, mask, scale, *params):
        out = din_attention(query, keys, mask, params, scale)
        ctx.save_for_backward(query, keys, mask, out, *params)
        ctx.scale = scale
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        query, keys, mask, out, *params = ctx.saved_tensors
        d_query, d_keys, d_params = din_attention_backward(
            grad, query, keys, mask, tuple(params), out, ctx.scale)
        return (d_query, d_keys, None, None, *d_params)


def attention(query: torch.Tensor, keys: torch.Tensor, mask: torch.Tensor,
              params: Params, scale: float) -> torch.Tensor:
    """The weights as ``DINAttention`` computes them on a card: under
    autograd where an input or parameter needs a gradient, else the
    forward kernel alone (nothing kept)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (query, keys, *params)):
        return DINAttentionFunction.apply(query, keys, mask, scale, *params)
    with torch.no_grad():
        return din_attention(query, keys, mask, params, scale)
