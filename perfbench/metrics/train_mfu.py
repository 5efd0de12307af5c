"""The step's matrix-product FLOPs (``arith/<config>.py``) over the traced
window's examples and time, as a share of the float32 peak."""
from perfbench.core import peaks


def read(ctx):
    if ctx.trace is None or not ctx.trace.ops:
        return None
    flops = ctx.arith.train_flops_per_example(ctx.cfg) * ctx.examples
    return 100.0 * flops / ctx.trace.window_s / peaks.FP32_FLOPS
