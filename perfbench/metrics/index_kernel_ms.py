"""Device time a step of the hash index (K5, K4) and the dedup's sort
kernels (those matched by name, ``metrics/_kernels.py``)."""
from perfbench.metrics import _kernels


def read(ctx):
    if ctx.trace is None:
        return None
    return _kernels.ms_per_step(ctx, _kernels.index)
