"""The HBM bound of the step's embedding functions
(``arith/embedding.py``, from the traced steps' shapes) over the device
time of the kernels that did them."""
from perfbench.arith import embedding
from perfbench.core import peaks
from perfbench.metrics import _kernels


def read(ctx):
    if ctx.trace is None:
        return None
    ms = _kernels.ms_per_step(ctx, _kernels.embedding)
    if not ms:
        return None
    d = ctx.cfg["emb_dim"]
    nbytes = sum(embedding.step_bytes(
        ctx.cfg["categorical_columns"] * ctx.batch, ctx.width, u, d, 2 * d)
        for u in ctx.unique_counts)
    bound_ms = nbytes / peaks.HBM_BYTES_PER_S * 1e3 / ctx.steps
    return 100.0 * bound_ms / ms
