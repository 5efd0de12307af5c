"""Design probe for K2's backward: the port's kernel beside copies of it
with one design constant changed, at the K2-backward shapes of
:func:`kernel_probe.k2_bwd_shapes`.

Each variant is a copy of the package in a temporary directory whose
``csrc/fused_pooled_lookup.cu`` has one line replaced (:data:`VARIANTS`),
built there by ``ops/_build.py`` (all variants at once, one process each)
and timed in a process of its own: device ms per call (the median of 11
CUDA-event samples of 20 back-to-back calls, L2 warm) and each kernel's
device us a call (torch.profiler), after a check against the plain version
(rows of at most 32 lanes bit-equal). The port itself is timed the same
way before and after the variants. Run from the root of a checkout on a
machine with one card:

    python -m deeprec_tpu_torch.probes.k2_bwd_variants [name ...]
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
_KERNEL = Path("csrc") / "fused_pooled_lookup.cu"

#: name: (the port's line, the variant's)
VARIANTS = {
    "8 threads a short row": ("constexpr int kRowLanes = 4;",
                              "constexpr int kRowLanes = 8;"),
    "256-thread ordering blocks": ("constexpr int kOrderThreads = 1024;",
                                   "constexpr int kOrderThreads = 256;"),
    "listed rows' blocks at most one an SM": (
        "most = 2 * sm_count();", "most = sm_count();"),
}


def time_here(tag: str) -> None:
    """Times the package this process imports (the port or a variant's
    copy) at the probe's shapes; prints a line a shape."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ..ops.fused_lookup import (fused_pooled_lookup_backward as port,
                                    fused_pooled_lookup_backward_plain as plain)
    from .kernel_probe import k2_bwd_shapes, time_ms
    dev = torch.device("cuda")
    for what, (dp, slots, valid, u) in k2_bwd_shapes(
            dev, torch.Generator().manual_seed(1)).items():
        got = port(dp, slots, valid, "sum", u).cpu()
        ref = plain(dp.cpu(), slots.cpu(), valid.cpu(), "sum", u)
        lanes = torch.bincount(
            slots.cpu().clamp(0, u - 1)[valid.cpu()].long(), minlength=u)
        if not torch.equal(got[lanes <= 32], ref[lanes <= 32]):
            raise SystemExit(f"k2_bwd_variants: {tag} is wrong at {what}")
        ms = time_ms(lambda: port(dp, slots, valid, "sum", u), 11)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                port(dp, slots, valid, "sum", u)
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        us = {k: round(sum(e.self_device_time_total for e in kernels
                           if f"{k}_kernel" in e.key) / 20, 2)
              for k in ("order", "rows")}
        print(f"  {tag}, {what}: {ms:.4f} ms, device us a call {us}",
              flush=True)


def _copy(name: str, root: Path) -> Path:
    """The package copied under root with the variant's line in place."""
    old, new = VARIANTS[name]
    shutil.copytree(_PKG, root / _PKG.name,
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    shutil.copytree(_PKG.parent / "native", root / "native")
    src = root / _PKG.name / _KERNEL
    text = src.read_text()
    if text.count(old) != 1:
        raise SystemExit(f"k2_bwd_variants: {name!r}: the port has no line "
                         f"{old!r}")
    src.write_text(text.replace(old, new))
    return root


def main() -> None:
    if len(sys.argv) > 2 and sys.argv[1] == "--time":  # a child process
        time_here(sys.argv[2])
        return
    if not torch.cuda.is_available():
        raise SystemExit("k2_bwd_variants: needs a CUDA card")
    names = sys.argv[1:] or list(VARIANTS)
    with tempfile.TemporaryDirectory() as tmp:
        roots = {n: _copy(n, Path(tmp) / f"v{i}") for i, n in enumerate(names)}
        build = "from deeprec_tpu_torch.ops import _build; _build.library()"
        procs = {n: subprocess.Popen([sys.executable, "-c", build], cwd=r,
                                     stderr=subprocess.PIPE, text=True)
                 for n, r in roots.items()}
        for n, proc in procs.items():
            _, err = proc.communicate()
            if proc.returncode:
                raise SystemExit(f"k2_bwd_variants: {n!r} did not build:\n"
                                 f"{err}")

        def run(tag, root):
            env = dict(os.environ, PYTHONPATH=str(root))
            subprocess.run([sys.executable, "-m",
                            "deeprec_tpu_torch.probes.k2_bwd_variants",
                            "--time", tag], cwd=root, env=env, check=True)
        run("the port", _PKG.parent)
        for n, root in roots.items():
            run(n, root)
        run("the port", _PKG.parent)


if __name__ == "__main__":
    main()
