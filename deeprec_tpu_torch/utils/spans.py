"""Spans and counters of the training loop, on the clock of a
``torch.profiler`` trace.

The recorder is off until :func:`start` and off again after :func:`stop`.
Off, :func:`span` returns one shared do-nothing context manager after a
single flag check and :func:`count` returns at once: nothing is allocated
and no tensor is made. On:

* :func:`span` ``(name, batch=None)`` times a ``with`` block. Its record
  holds the name, its parent (the innermost span open on the same thread
  when it began), the thread's native id and name, the batch number (the
  parent's where none is given: one number links a batch's packing, copy,
  wait and step across threads) and its start and end in Unix nanoseconds
  (``time.perf_counter_ns`` plus one offset taken at :func:`start`). That
  is the clock of a Chrome trace exported by ``torch.profiler``, where a
  time is ``ts * 1000 + baseTimeNanoseconds``, so :func:`add_to_chrome_trace`
  puts the spans on the device's timeline.
* :func:`count` ``(name, n)`` adds ``n``, an int or a 0-dim tensor that the
  step computes anyway. Tensors are kept and summed once, at :func:`stop`:
  a counter adds no kernel and no host sync to a step.

:func:`stop` returns a :class:`Snapshot`: the records in the order their
spans ended, the counters (the kernel wrappers' ``.launches`` among them,
as ``launches.<wrapper>``, counted from :func:`start`) and how many
records and counts the bounded buffer dropped. Spans and counts from any
thread are safe. A span still open at :func:`stop` is not recorded.

The spans of the training loop (``train/cli.py``, ``train/trainer.py``,
``train/pipeline.py``), by thread:

* prefetch worker: ``pack`` (a batch's host half in the device-index loop;
  inside it ``pack.np``, ``Trainer.pack_np``, and ``pack.pin``,
  ``Trainer.resolve_packed``: the spans of ``Trainer.prepare_host``), then
  ``copy`` (issuing its ``non_blocking`` copies); in the host-index loop
  ``pack`` is ``pack_np`` alone.
* ``HostStepPipeline``'s threads: ``resolve`` and ``transfer``.
* main: ``loop.next_batch`` (waiting for the next batch), ``step``
  (``Trainer._train_step``: ``step.sparse_lookup``,
  ``step.forward_backward``, ``step.sparse_apply``, ``step.dense_apply``,
  ``step.metrics``) and ``loop.fence`` (the loop's fence work); inside
  ``step.forward_backward``, DIEN's forward (``models/sequence.py``):
  ``dien.interest_extractor`` (the GRU), ``dien.attention``,
  ``dien.interest_evolution`` (the AUGRU), ``dien.tower`` and
  ``dien.aux_loss`` (the forward's launches only: the backward runs in
  ``loss.backward()`` after them); BST's forward: ``bst.tokens`` (the
  token layout and the position rows), ``bst.attention`` (the attention
  and the first LayerNorm), ``bst.ffn`` (the FFN, the second LayerNorm,
  the padded outputs zeroed) and ``bst.tower``, forward only too.

Counters: ``lookup.lanes`` (the key lanes of a step's lookups),
``lookup.unique`` and ``lookup.overflow`` (their dedup's ``n_unique`` and
``n_overflow``: the device's, or the host resolver's, as its wire carries
them); the CLI's ``--profile`` adds ``rows.created`` (keys its
device-index indexes gained while it recorded). DIEN's forward counts
``seq.lanes`` (history positions, padding included, an int),
``seq.valid_lanes`` (the valid ones: the mask's sum, a 0-dim tensor the
forward makes on or off) and ``seq.recurrence_steps`` (GRU and AUGRU cell
steps, ``2 * L``); BST's counts ``seq.lanes``, ``seq.valid_lanes``,
``bst.tokens`` (the block's tokens, ``B * (L + 1)``, an int) and
``bst.valid_tokens`` (the valid slots and the candidates).
"""
from __future__ import annotations

import itertools
import json
import os
import sys
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch

#: records (and counts) kept between :func:`start` and :func:`stop`
CAPACITY = 1 << 20
#: the kernel wrappers whose ``.launches`` a snapshot reports
LAUNCH_COUNTERS = (("ops.gather", "gather_rows"),
                   ("ops.fused_lookup", "fused_pooled_lookup"),
                   ("ops.fused_lookup", "fused_pooled_lookup_backward"),
                   ("ops.meta_scatter", "lookup_meta"),
                   ("ops.meta_scatter", "meta_scatter"),
                   ("ops.meta_scatter", "blocked_rmw_set"),
                   ("ops.hash_probe", "hash_lookup"),
                   ("ops.hash_probe", "hash_lookup_or_insert_"),
                   ("ops.interaction", "dot_interaction"),
                   ("ops.interaction", "dot_interaction_backward"),
                   ("ops.recurrence", "gru_scan"),
                   ("ops.recurrence", "gru_scan_backward"),
                   ("ops.din_attention", "din_attention"),
                   ("ops.din_attention", "din_attention_backward"))
_PACKAGE = __name__.rsplit(".", 2)[0]


class Record(NamedTuple):
    name: str
    id: int
    parent: Optional[int]   # the id of the enclosing span on its thread
    tid: int                # the thread's native id
    thread: str
    batch: Optional[int]
    start_ns: int           # Unix nanoseconds
    end_ns: int


class Snapshot(NamedTuple):
    records: List[Record]
    counters: Dict[str, int]
    dropped: int


class _Off:
    """The shared span of a recorder that is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Buffer:
    def __init__(self):
        self.lock = threading.Lock()
        self.records: List[Record] = []
        self.counts: Dict[str, list] = {}
        self.n_counts = 0
        self.dropped = 0
        self.open = True
        self.offset = time.time_ns() - time.perf_counter_ns()
        self.launches = _launches()


_buf: Optional[_Buffer] = None
_ids = itertools.count()
_local = threading.local()


def _launches() -> Dict[str, int]:
    out = {}
    for mod, fn in LAUNCH_COUNTERS:
        m = sys.modules.get(f"{_PACKAGE}.{mod}")
        if m is not None:
            out[fn] = getattr(m, fn).launches
    return out


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        _local.tid = threading.get_native_id()
        _local.thread = threading.current_thread().name
        return _local.stack


class _Span:
    __slots__ = ("buf", "name", "batch", "id", "parent", "start")

    def __init__(self, buf: _Buffer, name: str, batch: Optional[int]):
        self.buf, self.name, self.batch = buf, name, batch

    def __enter__(self):
        stack = _stack()
        parent = stack[-1] if stack else None
        self.parent = parent.id if parent is not None else None
        if self.batch is None and parent is not None:
            self.batch = parent.batch
        self.id = next(_ids)
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _local.stack.pop()
        buf = self.buf
        with buf.lock:
            if not buf.open:
                return False
            if len(buf.records) >= CAPACITY:
                buf.dropped += 1
                return False
            buf.records.append(Record(
                self.name, self.id, self.parent, _local.tid, _local.thread,
                self.batch, self.start + buf.offset, end + buf.offset))
        return False


def span(name: str, batch: Optional[int] = None):
    """A context manager that records the ``with`` block as ``name``."""
    buf = _buf
    if buf is None:
        return _OFF
    return _Span(buf, name, batch)


def count(name: str, n) -> None:
    """Add ``n`` (an int, or a 0-dim integer tensor) to counter ``name``."""
    buf = _buf
    if buf is None:
        return
    with buf.lock:
        if not buf.open:
            return
        if buf.n_counts >= CAPACITY:
            buf.dropped += 1
            return
        buf.n_counts += 1
        buf.counts.setdefault(name, []).append(n)


def recording() -> bool:
    return _buf is not None


def start() -> None:
    """Start recording (from nothing); a no-op when already on."""
    global _buf
    if _buf is None:
        _buf = _Buffer()


def stop() -> Snapshot:
    """Stop recording and return what was recorded since :func:`start`
    (an empty snapshot when the recorder was off)."""
    global _buf
    buf, _buf = _buf, None
    if buf is None:
        return Snapshot([], {}, 0)
    with buf.lock:
        buf.open = False
    counters = {}
    for name, vals in buf.counts.items():
        total = sum(v for v in vals if isinstance(v, int))
        ts = [v.reshape(()).to(torch.int64) for v in vals
              if isinstance(v, torch.Tensor)]
        if ts:
            total += int(torch.stack(ts).sum())
        counters[name] = total
    for fn, n in _launches().items():
        counters[f"launches.{fn}"] = n - buf.launches.get(fn, 0)
    return Snapshot(buf.records, counters, buf.dropped)


def add_to_chrome_trace(path: str, snap: Snapshot) -> None:
    """Write ``snap`` into the Chrome trace at ``path`` (an export of
    ``torch.profiler``): each record a complete event of category
    ``deeprec`` on the trace's clock (``ts`` and ``dur`` in microseconds
    after its ``baseTimeNanoseconds``; ``tid`` the thread's native id, as
    the profiler writes its CPU ops), the counters and drops under the
    top-level key ``deeprec``."""
    with open(path) as f:
        trace = json.load(f)
    base, pid = int(trace.get("baseTimeNanoseconds", 0)), os.getpid()
    trace.setdefault("traceEvents", []).extend(
        {"ph": "X", "cat": "deeprec", "name": r.name, "pid": pid,
         "tid": r.tid, "ts": (r.start_ns - base) / 1e3,
         "dur": (r.end_ns - r.start_ns) / 1e3,
         "args": {"batch": r.batch, "thread": r.thread, "id": r.id,
                  "parent": r.parent}}
        for r in snap.records)
    trace["deeprec"] = {"counters": snap.counters, "dropped": snap.dropped}
    with open(path, "w") as f:
        json.dump(trace, f)
