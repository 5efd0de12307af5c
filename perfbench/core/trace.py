"""The traced window: a ``torch.profiler`` trace and its reduction.

:class:`Capture` records the device's kernels, copies and sets and the
host's CUDA runtime calls (``ProfilerActivity.CUDA`` alone: recording
every CPU op besides slowed a 65,536-example DLRM step by half, and the
window is to stand for an untraced one) from :meth:`Capture.start`, which
follows a synchronize and records a CUDA event, to :meth:`Capture.stop`,
which synchronizes first, so that the first runtime call and the end of
the last one bound the window. Both can be called between two steps of a
running loop. A short throwaway profile at construction takes the
profiler's own start-up. The trace goes through the profiler's
Chrome-trace export, read back and deleted.

:class:`Trace` holds, clipped to the window: every device operation, the
busy time (the union of the device intervals), and the idle gaps, each
labelled by the runtime call the host was in at its middle (a copy that
waits, a launch, a synchronize), or by none (the host in Python or in
ATen between calls).
"""
from __future__ import annotations

import collections
import json
import os
import tempfile
from typing import List, NamedTuple, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
NO_CALL = "host: no CUDA call (Python, ATen)"


class DeviceOp(NamedTuple):
    name: str
    cat: str
    ts: float      # microseconds on the trace's clock
    dur: float


class Trace(NamedTuple):
    ops: List[DeviceOp]
    window: Tuple[float, float]
    busy_us: float
    gaps: List[Tuple[float, float, str]]  # start, length, label

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    @property
    def busy_s(self) -> float:
        return self.busy_us / 1e6


class Capture:
    """A profiler window opened and closed between steps. On the CPU (the
    tests) the CPU ops stand in for the runtime calls."""

    def __init__(self, cuda: bool):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self._torch, self.cuda = torch, cuda
        self._acts = [ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]
        self._profile = profile
        with profile(activities=self._acts):
            self._mark()
        self._prof = None
        self.trace: Optional[Trace] = None

    def _sync(self):
        if self.cuda:
            self._torch.cuda.synchronize()

    def _mark(self):
        self._sync()
        if self.cuda:
            self._torch.cuda.Event().record()
        else:
            self._torch.zeros(1).add_(1)

    def start(self):
        self._prof = self._profile(activities=self._acts)
        self._prof.start()
        self._mark()

    def stop(self) -> Trace:
        self._mark()
        self._prof.stop()
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        self._prof = None
        self.trace = reduce(events, RUNTIME_CATS if self.cuda
                            else ("cpu_op",))
        return self.trace


def _cat(e) -> str:
    return str(e.get("cat", "")).lower()


def reduce(events: List[dict], host_cats=RUNTIME_CATS) -> Trace:
    x = [e for e in events if e.get("ph") == "X" and "ts" in e]
    host = sorted((e for e in x if _cat(e) in host_cats),
                  key=lambda e: float(e["ts"]))
    dev = [e for e in x if _cat(e) in DEVICE_CATS]
    if not host:
        raise RuntimeError("the trace holds no host call to bound its window")
    w0 = float(host[0]["ts"])
    w1 = max(float(e["ts"]) + float(e["dur"]) for e in host)
    ops = []
    for e in dev:
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e["dur"]), w1)
        if b > a:
            ops.append(DeviceOp(e["name"], _cat(e), a, b - a))
    spans = sorted((o.ts, o.ts + o.dur) for o in ops)
    merged: List[list] = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    holes, t = [], w0
    for a, b in merged:
        if a > t:
            holes.append((t, a - t))
        t = max(t, b)
    if w1 > t:
        holes.append((t, w1 - t))
    # the host call open at each hole's middle: a sweep over the calls
    # sorted by start, keeping the latest-started one still open
    gaps, i, open_calls = [], 0, []
    for s, d in sorted(holes):
        mid = s + d / 2
        while i < len(host) and float(host[i]["ts"]) <= mid:
            open_calls.append(host[i])
            i += 1
        open_calls = [e for e in open_calls
                      if float(e["ts"]) + float(e["dur"]) > mid]
        label = open_calls[-1]["name"] if open_calls else NO_CALL
        gaps.append((s, d, label))
    return Trace(ops, (w0, w1), busy, gaps)


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time and the idle time by what
    the host was doing, each ``[name, seconds]``, at most ``top``."""
    by_op = collections.Counter()
    for o in tr.ops:
        by_op[o.name] += o.dur / 1e6
    by_gap = collections.Counter()
    for _, d, label in tr.gaps:
        by_gap[label] += d / 1e6
    return {"device_ops": [[n, s] for n, s in by_op.most_common(top)],
            "idle_gaps": [[n, s] for n, s in by_gap.most_common(top)]}
