"""Device kernels, copies and sets a step in the traced window."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.ops:
        return None
    return len(ctx.trace.ops) / ctx.steps
