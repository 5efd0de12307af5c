"""Device time a step of the GEMMs and batched GEMMs, forward and
backward (cuBLAS and CUTLASS kernels, matched by name in
``metrics/_kernels.py``)."""
from perfbench.metrics import _kernels


def read(ctx):
    if ctx.trace is None:
        return None
    return _kernels.ms_per_step(ctx, _kernels.gemm)
