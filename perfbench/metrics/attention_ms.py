"""Device time a step of the self-attention kernels, forward and backward:
PyTorch's memory-efficient scaled-dot-product attention
(``fmha_cutlassF_*`` and ``fmha_cutlassB_*``, its ``AttentionKernel`` and
``AttentionBackwardKernel``), which BST's block runs on the card
(``models/layers.py`` ``MultiHeadSelfAttention``). Their names hold
``cutlass``, so ``gemm_ms`` counts the same kernels too. The mask's
conversion to an additive bias and the layout copies around them are
ATen kernels, in ``pointwise_ms``. A cell whose model runs no such
attention reads nothing."""
import re

from perfbench.metrics import _kernels

ATTENTION = re.compile(r"\bfmha_cutlass[FB]_|MemEffAttention::"
                       r"Attention(Backward)?Kernel")


def attention(op) -> bool:
    return op.cat == "kernel" and ATTENTION.search(op.name) is not None


def read(ctx):
    if ctx.trace is None:
        return None
    return _kernels.ms_per_step(ctx, attention)
