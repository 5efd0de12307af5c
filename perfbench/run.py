"""Run one cell of the port's benchmark and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

``<cell>`` names ``perfbench/cells/<cell>.json``, which names its
configuration (``configs/``) and traffic mix (``traffic/``). The last line
of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the end-to-end metrics, or with ``--trace 1`` the
per-layer ones), ``device`` and, traced, ``breakdown``; its last key,
``checks``, gives each number compared with its limit, as do the last
lines of standard error. Without a CUDA card, or with fewer cards than the
cell asks for, it prints no result and exits 2. It exits 3, with no
result, where the process has loaded JAX or the JAX package.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# caches at fixed paths inside the checkout: only a cell's first run there
# builds or compiles
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(HERE / ".cache" / sub)
sys.path.insert(0, str(ROOT))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "not read"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    import torch
    from perfbench.core import session
    try:
        cell = session.load_json("cells", a.workload)
    except FileNotFoundError:
        log(f"no cell {a.workload!r} under {HERE / 'cells'}")
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell.get("chips", 1)):
        log(f"cell {a.workload} needs {cell.get('chips', 1)} CUDA card(s); "
            f"torch sees {torch.cuda.device_count()}: no result")
        return 2
    cfg = session.load_json("configs", cell["config"])
    mix = session.load_json("traffic", cell["traffic"])
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(cfg["tf32"])
    log(f"card: {power_limit()}")
    out = session.run(cell, cfg, mix, a.seed, a.seconds, bool(a.trace),
                      "cuda", T_START, session.benchmark(), log)
    bad = session.forbidden_modules()
    if bad:
        log(f"the run loaded {', '.join(bad)}: no result")
        return 3
    for k, v in out["checks"].items():
        log(f"check {k}: {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
