"""Readings that a cell's correctness limits are set from.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--variants 3] [--out FILE]

For each seed: the cell's set-up and checked steps as a run makes them
(``core.session.prepare``, at the cell's own size), the program's state
freed, then the comparison's numbers of

* ``program``: the program against the reference (sound runs: the lower
  reading is their largest);
* ``control`` (first ``--variants`` seeds): the reference computed with
  TF32 products, the nearest precision below the configuration's float32,
  put in the program's place;
* ``half`` (same seeds): the reference over the first half of each batch,
  the mean taken over it, in the program's place (a fault).

A step that returns its state unchanged reads 1 on every gap and needs no
run. One JSON line a seed and side, then the summary: per number, the
program's largest reading and the smallest of each variant.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))


def seed_readings(cell: dict, cfg: dict, mix: dict, seed: int, device: str,
                  variants: bool) -> dict:
    """``{side: numbers}`` of one seed."""
    import torch
    from perfbench.core import compare, session
    p = session.prepare(cell, cfg, mix, seed, device)
    p = p._replace(tr=None, state=None)
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    ref = session.reference_readings(cfg, p, device)
    out = {"program": {**compare.numbers(p.side, ref),
                       "worst": compare.worst_leaves(p.side, ref)}}
    if variants:
        for side, kw in (("control", {"tf32": True}),
                         ("half", {"half": True})):
            other = session.reference_readings(cfg, p, device, **kw)
            out[side] = {**compare.numbers(other, ref),
                         "worst": compare.worst_leaves(other, ref)}
    return out


def summarize(rows) -> dict:
    """The program's largest reading and each variant's smallest, per
    number."""
    from perfbench.core.compare import NUMBERS
    out = {}
    for side, pick in (("program", max), ("control", min), ("half", min)):
        got = [r[side] for r in rows if side in r]
        if got:
            out[side] = {k: pick(g[k] for g in got) for k in NUMBERS}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variants", type=int, default=3)
    ap.add_argument("--out", default="")
    a = ap.parse_args(argv)
    import torch
    from perfbench.core import session
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 2
    cell = session.load_json("cells", a.workload)
    cfg = session.load_json("configs", cell["config"])
    mix = session.load_json("traffic", cell["traffic"])
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(cfg["tf32"])
    rows = []
    for i, s in enumerate(int(x) for x in a.seeds.split(",")):
        r = seed_readings(cell, cfg, mix, s, "cuda", i < a.variants)
        rows.append(r)
        for side, nums in r.items():
            print(json.dumps({"cell": a.workload, "seed": s, "side": side,
                              **nums}), flush=True)
    summary = {"cell": a.workload, "seeds": a.seeds,
               "card": torch.cuda.get_device_name(0), **summarize(rows)}
    print(json.dumps(summary), flush=True)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps({"rows": rows,
                                           "summary": summary}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
