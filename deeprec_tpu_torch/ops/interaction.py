"""DLRM's pairwise dot interaction, forward and backward.

``dot_interaction(feats)`` takes ``[B, F, d]`` features to the ``[B,
F (F - 1) / 2]`` dot products of each pair ``(i, j)``, ``i > j``, in the
row-major order of ``torch.tril_indices(F, F, -1)`` (the order of
``deeprec_tpu.models.layers.DotInteraction``). ``dot_interaction_backward
(feats, grad)`` is its cotangent: ``d_feats[b, i] = sum over j != i of
grad[b, pair(i, j)] * feats[b, j]``. Each launches its hand-written kernel
in ``csrc/dot_interaction.cu``, which never forms the ``[B, F, F]`` Gram
matrix, adds in a fixed order and uses no atomics. They take float32 CUDA
tensors of any ``F`` and ``d`` whose one example fits the card's shared
memory, and raise on anything else.

:func:`interact` is what ``models.layers.DotInteraction`` calls: on a CUDA
tensor :class:`DotInteractionFunction`, whose backward is the backward
kernel; on any other device :func:`dot_interaction_plain` (a ``bmm`` and a
gather) under ordinary autograd, the plain version the tests and the card
smoke hold the kernels to.
"""
from __future__ import annotations

import torch

from . import _build


def dot_interaction_plain(feats: torch.Tensor) -> torch.Tensor:
    f = feats.shape[1]
    gram = torch.bmm(feats, feats.transpose(1, 2))
    rows, cols = torch.tril_indices(f, f, -1, device=feats.device)
    return gram[:, rows, cols]


def _check(feats: torch.Tensor) -> None:
    if feats.dim() != 3:
        raise ValueError(f"feats must be [B, F, d], got {tuple(feats.shape)}")
    if feats.device.type != "cuda":
        raise ValueError(f"dot_interaction launches a CUDA kernel; "
                         f"{feats.device} takes dot_interaction_plain")
    if feats.dtype != torch.float32:
        raise ValueError(f"dot_interaction takes float32, not {feats.dtype}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (where 4 divides d
    the kernels load 16-byte units)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def dot_interaction(feats: torch.Tensor) -> torch.Tensor:
    """``[B, F (F - 1) / 2]`` pairwise dots of ``feats [B, F, d]``."""
    _check(feats)
    b, f, d = feats.shape
    out = torch.empty((b, f * (f - 1) // 2), dtype=feats.dtype,
                      device=feats.device)
    if out.numel() == 0:  # no examples or no pairs: nothing to launch
        return out
    feats = _aligned(feats)
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.library().deeprec_dot_interaction(
            feats.data_ptr(), b, f, d, out.data_ptr(), stream)
    _build.check(err, "dot_interaction")
    dot_interaction.launches += 1
    return out


def dot_interaction_backward(feats: torch.Tensor,
                             grad: torch.Tensor) -> torch.Tensor:
    """``d_feats [B, F, d]`` of :func:`dot_interaction` given ``grad [B,
    F (F - 1) / 2]``."""
    b, f, d = feats.shape
    if tuple(grad.shape) != (b, f * (f - 1) // 2):
        raise ValueError(f"grad must be [{b}, {f * (f - 1) // 2}], got "
                         f"{tuple(grad.shape)}")
    if grad.device != feats.device or grad.dtype != feats.dtype:
        raise ValueError("grad and feats differ in device or dtype")
    _check(feats)
    if grad.numel() == 0:  # no examples, or no pairs: a zero gradient
        return torch.zeros_like(feats)
    feats, grad = _aligned(feats), grad.contiguous()
    d_feats = torch.empty_like(feats)
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.library().deeprec_dot_interaction_backward(
            feats.data_ptr(), grad.data_ptr(), b, f, d, d_feats.data_ptr(),
            stream)
    _build.check(err, "dot_interaction_backward")
    dot_interaction_backward.launches += 1
    return d_feats


#: kernel launches, read by the card smoke and the spans
dot_interaction.launches = 0
dot_interaction_backward.launches = 0


class DotInteractionFunction(torch.autograd.Function):
    """:func:`dot_interaction` with :func:`dot_interaction_backward` as its
    backward; ``feats`` is saved for it."""

    @staticmethod
    def forward(ctx, feats):
        ctx.save_for_backward(feats)
        return dot_interaction(feats)

    @staticmethod
    def backward(ctx, grad):
        feats, = ctx.saved_tensors
        return dot_interaction_backward(feats, grad)


def interact(feats: torch.Tensor) -> torch.Tensor:
    """The interaction as ``DotInteraction`` computes it: the kernels on
    the card, the plain version under autograd elsewhere."""
    if feats.device.type != "cuda":
        return dot_interaction_plain(feats)
    return DotInteractionFunction.apply(feats)
