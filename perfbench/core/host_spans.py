"""The program's spans on the device trace's timeline: what the main thread
and the prefetch workers were doing in each idle gap of a traced window.

:class:`SpanCapture` is :class:`core.trace.Capture` that also runs the
program's recorder (``deeprec_tpu_torch/utils/spans.py``) from the window's
first mark to its last and keeps the whole Chrome trace, the program's
spans written into it (category ``deeprec``, ``tid`` the thread's native
id, on the trace's clock). It marks the window inside a program span
``capture.mark``, so the trace's own ``cudaEventRecord`` shows how far the
two clocks agree.

:func:`report` reads such a trace. The main thread is the one whose spans
hold ``step``; the traced steps are its ``step`` spans that begin inside
the window, and their batch numbers pick the other spans:

* ``batch_wait_ms``: ``loop.next_batch`` per traced step.
* ``pack_ms``: mean ``pack`` of the traced steps' batches (a batch packed
  before the recorder started has none).
* ``idle_in_step_pct``, ``idle_awaiting_batch_pct``: the share of the
  window in which the device is idle while the main thread is inside
  ``step``, or inside ``loop.next_batch``: each idle gap intersected with
  those spans.
* ``idle_by_span``: idle seconds by the main thread's innermost span
  (``main``), and, for each thread, by the runtime call it had open
  (``calls``).
* ``spans``: by name, the count in the window, mean ms, self ms per traced
  step (its time less its children's) and the threads; ``counters``: the
  recorder's counters per traced step.
* ``launches_in_spans_pct``: the main thread's ``cudaLaunchKernel`` calls
  in the window that lie inside its ``step`` or ``loop.fence`` spans.
* ``clock_us``: each ``capture.mark``'s ``[lead, lag]``: how far its
  ``cudaEventRecord`` call starts after the span starts, and ends before
  it ends, on the shared clock.

``python3 perfbench/idle_report.py`` runs a cell's traced window through
the benchmark's own session with this capture and prints the report.
"""
from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

from perfbench.core import trace as tracing

CAT = "deeprec"
NONE = "none"
LAUNCH = "cudaLaunchKernel"
EVENT_RECORD = ("cudaEventRecord", "cudaEventRecordWithFlags")


class SpanCapture(tracing.Capture):
    """A :class:`core.trace.Capture` that records the program's spans over
    the window and keeps the raw trace (``raw``) beside its reduction."""

    def __init__(self, cuda: bool):
        from deeprec_tpu_torch.utils import spans
        self._spans = spans
        self.raw: Optional[dict] = None
        super().__init__(cuda)

    def _mark(self):
        self._sync()
        with self._spans.span("capture.mark"):
            if self.cuda:
                self._torch.cuda.Event().record()
            else:
                self._torch.zeros(1).add_(1)

    def start(self):
        self._spans.start()
        super().start()

    def stop(self) -> tracing.Trace:
        self._mark()
        self._prof.stop()
        snap = self._spans.stop()
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            self._prof.export_chrome_trace(path)
            self._spans.add_to_chrome_trace(path, snap)
            with open(path) as f:
                self.raw = json.load(f)
        self._prof = None
        self.trace = tracing.reduce(
            self.raw["traceEvents"],
            tracing.RUNTIME_CATS if self.cuda else ("cpu_op",))
        return self.trace


class Span(NamedTuple):
    start: float    # microseconds on the trace's clock
    end: float
    name: str
    tid: int
    batch: Optional[int]
    id: Optional[int]
    parent: Optional[int]
    thread: str


def program_spans(events: Sequence[dict]) -> List[Span]:
    out = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == CAT:
            a, s = e.get("args", {}), float(e["ts"])
            out.append(Span(s, s + float(e["dur"]), e["name"], e["tid"],
                            a.get("batch"), a.get("id"), a.get("parent"),
                            a.get("thread", f"tid {e['tid']}")))
    return sorted(out, key=lambda x: (x.start, x.end))


def innermost(intervals: Sequence[Tuple[float, float, str]]
              ) -> List[Tuple[float, float, str]]:
    """Non-overlapping pieces ``(start, end, label)`` of nested intervals,
    each labelled by the innermost interval covering it."""
    out: List[Tuple[float, float, str]] = []
    stack: List[Tuple[float, float, str]] = []
    t = None

    def emit(upto):
        if stack and upto > t:
            out.append((t, upto, stack[-1][2]))
    for s, e, label in sorted(intervals, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][1] <= s:
            emit(stack[-1][1])
            t = max(t, stack.pop()[1])
        if stack:
            emit(s)
        t = s
        stack.append((s, e, label))
    while stack:
        emit(stack[-1][1])
        t = max(t, stack.pop()[1])
    return out


def overlap(gaps: Sequence[Tuple[float, float]],
            pieces: Sequence[Tuple[float, float, str]]) -> Dict[str, float]:
    """Microseconds of ``gaps`` (sorted, disjoint ``(start, end)``) covered
    by each label of ``pieces`` (sorted, disjoint), the rest under
    ``none``."""
    out: Dict[str, float] = collections.Counter()
    i = 0
    for gs, ge in gaps:
        covered = 0.0
        while i < len(pieces) and pieces[i][1] <= gs:
            i += 1
        j = i
        while j < len(pieces) and pieces[j][0] < ge:
            a, b = max(gs, pieces[j][0]), min(ge, pieces[j][1])
            if b > a:
                out[pieces[j][2]] += b - a
                covered += b - a
            j += 1
        if ge - gs > covered:
            out[NONE] += ge - gs - covered
    return out


def _within(starts, pieces, a: float, b: float) -> bool:
    """Whether ``[a, b]`` lies inside one of ``pieces`` (sorted, disjoint;
    ``starts`` their starts)."""
    i = bisect.bisect_right(starts, a) - 1
    return i >= 0 and pieces[i][1] >= b


def thread_ids(prog: Sequence[Span], calls: Dict[int, list],
               main_tid: int) -> Dict[int, int]:
    """The program thread (native id) of each trace id of runtime calls.
    CUPTI gives a thread's CUDA calls an id of its own, neither the native
    id nor the pthread id (torch 2.11, CUDA 12.8), so: an id the program's
    spans carry is itself; the main thread's is the one whose
    ``cudaEventRecord`` lies inside the window's ``capture.mark`` spans;
    another's is the program thread whose spans hold at least half of its
    calls' midpoints and twice the share any other thread's spans hold (a
    thread's calls lie inside its own spans; the main thread, whose spans
    cover nearly all the time, is matched first, by its marks). An id left
    unmatched (the autograd engine's device thread) stays as it is."""
    out = {t: t for t in calls if any(s.tid == t for s in prog)}
    marks = [(s.start, s.end) for s in prog
             if s.name == "capture.mark" and s.tid == main_tid]
    for t, cs in calls.items():
        if t not in out and any(name in EVENT_RECORD and a < me and b > ms
                                for a, b, name in cs for ms, me in marks):
            out[t] = main_tid
    others = sorted({s.tid for s in prog} - set(out.values()))
    cover = {}
    for tid in others:
        pieces = innermost([(s.start, s.end, s.name) for s in prog
                            if s.tid == tid])
        cover[tid] = ([p[0] for p in pieces], pieces)

    def share(cs, tid):
        return sum(_within(*cover[tid], (a + b) / 2, (a + b) / 2)
                   for a, b, _ in cs) / len(cs)
    matches = []
    for t, cs in calls.items():
        if t in out or not cs or not others:
            continue
        ranked = sorted(((share(cs, tid), tid) for tid in others),
                        reverse=True) + [(0.0, None)]
        (best, tid), (second, _) = ranked[0], ranked[1]
        if best >= 0.5 and best >= 2 * second:
            matches.append((best, len(cs), t, tid))
    for _, _, t, tid in sorted(matches, reverse=True):
        if tid not in out.values():  # one trace id a thread
            out[t] = tid
    return out


def report(raw: dict, host_cats=tracing.RUNTIME_CATS) -> Optional[dict]:
    """The readings of one traced window (module docstring), or None where
    the trace holds no program ``step`` span."""
    events = raw["traceEvents"]
    tr = tracing.reduce(events, host_cats)
    w0, w1 = tr.window
    win = (w1 - w0) or 1.0
    prog = program_spans(events)
    holders = collections.Counter(s.tid for s in prog if s.name == "step")
    if not holders:
        return None
    main_tid = holders.most_common(1)[0][0]
    steps = [s for s in prog if s.name == "step" and s.tid == main_tid
             and w0 <= s.start <= w1]
    if not steps:
        return None
    n = len(steps)
    batches = {s.batch for s in steps}
    gaps = [(s, s + d) for s, d, _ in sorted(tr.gaps)]

    def on_main(*names):
        return sorted((s.start, s.end, s.name) for s in prog
                      if s.tid == main_tid and s.name in names)

    def idle_pct(name):
        return 100.0 * overlap(gaps, on_main(name)).get(name, 0.0) / win
    waits = [s for s in prog if s.name == "loop.next_batch"
             and s.tid == main_tid and s.batch in batches]
    packs = [s for s in prog if s.name == "pack" and s.batch in batches]
    out = {"steps": n,
           "batch_wait_ms": sum(s.end - s.start for s in waits) / 1e3 / n,
           "pack_ms": (sum(s.end - s.start for s in packs) / 1e3 / len(packs)
                       if packs else None),
           "idle_in_step_pct": idle_pct("step"),
           "idle_awaiting_batch_pct": idle_pct("loop.next_batch")}

    # idle by the main thread's innermost span, and by each thread's call
    main_pieces = innermost([(s.start, s.end, s.name) for s in prog
                             if s.tid == main_tid])
    names = {s.tid: s.thread for s in prog}
    raw_calls: Dict[int, list] = collections.defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and str(e.get("cat", "")).lower() \
                in host_cats:
            s = float(e["ts"])
            if s < w1 and s + float(e["dur"]) > w0:
                raw_calls[e["tid"]].append((s, s + float(e["dur"]),
                                            e["name"]))
    ids = thread_ids(prog, raw_calls, main_tid)
    calls_by_tid: Dict[int, list] = collections.defaultdict(list)
    for t, cs in raw_calls.items():
        calls_by_tid[ids.get(t, t)].extend(cs)
    by_thread = {}
    for tid, calls in sorted(calls_by_tid.items(), key=lambda x: str(x[0])):
        name = names.get(tid, f"tid {tid}")
        if tid == main_tid:
            name += " (main)"
        by_thread[name] = _seconds(overlap(gaps, innermost(calls)))
    out["idle_by_span"] = {"main": _seconds(overlap(gaps, main_pieces)),
                           "calls": by_thread}

    # every span name in the window: count, mean, self time per step
    inwin = [s for s in prog if w0 <= s.start <= w1]
    child = collections.Counter()
    for s in inwin:
        if s.parent is not None:
            child[s.parent] += s.end - s.start
    table = {}
    for name in sorted({s.name for s in inwin}):
        mine = [s for s in inwin if s.name == name]
        total = sum(s.end - s.start for s in mine)
        self_t = total - sum(child[s.id] for s in mine)
        table[name] = {"count": len(mine),
                       "mean_ms": total / 1e3 / len(mine),
                       "self_ms_per_step": self_t / 1e3 / n,
                       "threads": ",".join(sorted({s.thread for s in mine}))}
    out["spans"] = table
    counters = raw.get(CAT, {}).get("counters", {})
    out["counters"] = {k: v / n for k, v in sorted(counters.items())}
    out["dropped"] = raw.get(CAT, {}).get("dropped", 0)

    # the shared clock: launches inside their spans, and the window's marks
    launches = [(s, e) for s, e, name in calls_by_tid.get(main_tid, [])
                if name == LAUNCH and w0 <= s <= w1]
    if launches:
        host = on_main("step", "loop.fence")
        starts = [p[0] for p in host]
        out["launches_in_spans_pct"] = 100.0 * sum(
            _within(starts, host, a, b) for a, b in launches) / len(launches)
    marks = [s for s in prog if s.name == "capture.mark"]
    records = sorted((s, e) for s, e, name in calls_by_tid.get(main_tid, [])
                     if name in EVENT_RECORD)
    clock = []
    for m in marks:
        inside = [(a, b) for a, b in records if a < m.end and b > m.start]
        if inside:
            a, b = inside[0]
            clock.append([a - m.start, m.end - b])
    out["clock_us"] = clock
    return out


def _seconds(us: Dict[str, float]) -> Dict[str, float]:
    return {k: v / 1e6 for k, v in sorted(us.items(), key=lambda x: -x[1])}
