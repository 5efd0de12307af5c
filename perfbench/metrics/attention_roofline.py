"""The least time the step's self-attention could take on the card, over
the device time of the kernels that did it (``attention_ms``): the larger
of its operations over the float32 peak and its bytes over the HBM peak
(``arith/<config>.py`` ``attention_flops_per_example`` and
``attention_bytes_per_example``, both counted at the valid tokens only, so
the work spent on padding lowers the share). A configuration without
those functions, or a trace without the kernels, reads nothing."""
from perfbench.core import peaks
from perfbench.metrics import attention_ms


def read(ctx):
    flops = getattr(ctx.arith, "attention_flops_per_example", None)
    nbytes = getattr(ctx.arith, "attention_bytes_per_example", None)
    if flops is None or nbytes is None:
        return None
    ms = attention_ms.read(ctx)
    if not ms:
        return None
    bound_s = max(flops(ctx.cfg) / peaks.FP32_FLOPS,
                  nbytes(ctx.cfg) / peaks.HBM_BYTES_PER_S) * ctx.examples
    return 100.0 * bound_s * 1e3 / ctx.steps / ms
