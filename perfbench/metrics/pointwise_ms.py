"""Device time a step of ATen's own kernels (``at::native::`` in the
kernel's name) that no other reader counts (``metrics/_kernels.py``'s
embedding, index and GEMM patterns): the elementwise, reduction, ``cat``,
``where`` and indexing kernels between the port's own kernels and the
GEMMs. In DIEN that is the GRU and AUGRU gate chain, Dice and the
softmax; in DLRM the towers' elementwise chain."""
import re

from perfbench.metrics import _kernels

ATEN = re.compile(r"\bat::native::")


def pointwise(op) -> bool:
    return (op.cat == "kernel" and ATEN.search(op.name) is not None
            and not (_kernels.embedding(op) or _kernels.index(op)
                     or _kernels.gemm(op)))


def read(ctx):
    if ctx.trace is None:
        return None
    return _kernels.ms_per_step(ctx, pointwise)
