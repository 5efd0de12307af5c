"""One reader per per-layer metric: ``metrics/<name>.py`` defines
``read(ctx)``, which returns the metric's value from the traced run, or
None where it finds nothing to read (the harness then leaves the metric
out of the line). ``ctx`` is ``core.session.TracedRun``: the trace
(``core.trace.Trace``), the traced steps and examples, the
configuration, its arith module, and the step's dedup width and distinct
keys."""
import importlib


def load(name: str):
    """The reader ``metrics/<name>.py``."""
    return importlib.import_module(f"perfbench.metrics.{name}")
