"""Mean host time, over the traced steps' batches, of packing one into the
step's page-locked host tensors (``Trainer.prepare_host``: the numpy
packing of ids and dense features, then the copies into page-locked
memory), as the CLI's prefetch workers run it beside the step."""


def read(ctx):
    if not ctx.pack_s:
        return None
    return 1e3 * sum(ctx.pack_s) / len(ctx.pack_s)
