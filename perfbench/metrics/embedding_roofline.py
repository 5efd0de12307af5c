"""The HBM bound of the step's embedding functions
(``arith/embedding.py``, from the traced steps' shapes: their id lanes,
the dedup's width, their distinct keys, the stored row's width) over the
device time of the kernels that did them."""
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
    row = embedding.row_floats(ctx.cfg)
    nbytes = sum(embedding.step_bytes(lanes, ctx.width, u, d, row)
                 for lanes, u in zip(ctx.lanes, ctx.unique_counts))
    bound_ms = nbytes / peaks.HBM_BYTES_PER_S * 1e3 / ctx.steps
    return 100.0 * bound_ms / ms
