"""Which thread, and which of the program's spans, held each idle gap of a
cell's traced window.

    python3 perfbench/idle_report.py --workload <cell> --seed <n> \\
        [--out trace.json]

Runs the cell as ``run.py --trace 1`` does (the benchmark's own session:
set-up, the lead and traced steps through the CLI's loop, the check), with
``core.host_spans.SpanCapture`` in place of the window's capture, so the
program's span recorder runs over the same window. The last line of
standard output is ``run.py``'s result line with ``spans_report`` added
(``core.host_spans.report``); ``--out`` writes the window's Chrome trace,
the program's spans in it, to that path. A diagnostic beside the
benchmark, on a card only: ``run.py`` never runs it.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import run  # noqa: E402  (its cache settings, power_limit)
from perfbench.core import host_spans, session  # noqa: E402
from perfbench.core import trace as tracing  # noqa: E402


def traced(cell: dict, cfg: dict, mix: dict, seed: int, device: str,
           t_start: float, log=print):
    """``session.run`` traced, the program's spans recorded over its
    window. Returns the result line with ``spans_report``, and the raw
    trace."""
    caps = []

    def capture(cuda):
        caps.append(host_spans.SpanCapture(cuda))
        return caps[-1]
    saved, tracing.Capture = tracing.Capture, capture
    try:
        out = session.run(cell, cfg, mix, seed, 0.0, True, device, t_start,
                          session.benchmark(), log)
    finally:
        tracing.Capture = saved
    (cap,) = caps
    out["spans_report"] = host_spans.report(
        cap.raw, tracing.RUNTIME_CATS if cap.cuda else ("cpu_op",))
    return out, cap.raw


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--out", default="")
    a = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        run.log("needs a CUDA card: no result")
        return 2
    cell = session.load_json("cells", a.workload)
    cfg = session.load_json("configs", cell["config"])
    mix = session.load_json("traffic", cell["traffic"])
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(cfg["tf32"])
    run.log(f"card: {run.power_limit()}")
    out, raw = traced(cell, cfg, mix, a.seed, "cuda", T_START, run.log)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(raw, f)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
