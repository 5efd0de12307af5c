"""Device time a step of the embedding kernels: K1, K2, K2-bwd, K3a."""
from perfbench.metrics import _kernels


def read(ctx):
    if ctx.trace is None:
        return None
    return _kernels.ms_per_step(ctx, _kernels.embedding)
