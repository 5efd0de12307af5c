"""Async input staging: host batches packed ahead in worker threads.

Port of ``deeprec_tpu/data/prefetch.py``: :class:`Prefetcher` and
:func:`staged`, the ``tf.staged`` / PrefetchRunner analog. Worker threads
draw from the source iterator and run ``prepare`` (pure numpy packing)
and then ``device_put`` on each item; a turnstile keeps the source order
across workers, and a bounded queue of ``depth`` items sits between them
and the consumer. The JAX package's default ``device_put`` stage is
``jax.device_put``; here it is the identity: the host-index training loop
copies its batches on ``train.pipeline.HostStepPipeline``'s side stream
after the step-order resolve, as the JAX CLI passes an identity there too.
The device-index loop and the ``Estimator`` pass a stage that copies the
prepared (page-locked) tensors to the card with ``non_blocking=True``
(``train.pipeline.to_device``).
The worker loop, the turnstile, the consumer and ``close`` are the JAX
package's code (``tests/test_torch_imports.py`` holds them to it).
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

_END = object()


def _identity(item):
    return item


class Prefetcher:
    """Background host-pack + device-put pipeline over a batch iterator.

    Args:
      it: source iterator of raw host batches.
      prepare: host-side packing fn — runs in the worker threads (numpy
        only on the host-index path: the resolve runs in step order in
        the pipeline's resolve stage).
      depth: max staged batches (the DataBuffer capacity analog).
      workers: host packing threads (PrefetchRunner thread count analog).
      device_put: optional placement fn run on the prepared item in the
        worker (default: none, the identity).
    """

    def __init__(
        self,
        it: Iterable,
        prepare: Optional[Callable] = None,
        depth: int = 2,
        workers: int = 1,
        device_put: Optional[Callable] = None,
    ):
        self._src = iter(it)
        self._prepare = prepare or (lambda x: x)
        self._put = device_put if device_put is not None else _identity
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._src_lock = threading.Lock()
        self._seq = 0
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._run, daemon=True, name=f"prefetch-{i}")
            for i in range(max(1, workers))
        ]
        self._next_emit = 0
        self._emit_cv = threading.Condition()
        for t in self._threads:
            t.start()

    def _run(self):
        while not self._stop.is_set():
            with self._src_lock:
                seq = self._seq
                try:
                    raw = next(self._src)
                except StopIteration:
                    raw = _END
                except Exception as e:  # source error: surface, don't hang
                    raw = e
                self._seq += 1
            if raw is _END:
                self._emit(seq, _END)
                return
            if isinstance(raw, Exception):
                self._emit(seq, raw)
                return
            try:
                staged = self._put(self._prepare(raw))
            except Exception as e:  # surfaced on the consumer side
                staged = e
            self._emit(seq, staged)

    def _emit(self, seq: int, item):
        """Preserve source order across workers (elastic thread speeds must
        not reorder the stream — determinism for tests/repro): a turnstile —
        each worker waits for its sequence number's turn to enqueue."""
        with self._emit_cv:
            while seq != self._next_emit and not self._stop.is_set():
                self._emit_cv.wait(0.05)
            if self._stop.is_set():
                return
        self._q.put(item)  # may block when the buffer is full
        with self._emit_cv:
            self._next_emit += 1
            self._emit_cv.notify_all()

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        item = self._q.get()
        if item is _END:
            self._stop.set()
            raise StopIteration
        if isinstance(item, Exception):
            self._stop.set()
            raise item
        return item

    def close(self):
        self._stop.set()
        # drain so blocked workers can exit
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def staged(it: Iterable, prepare: Optional[Callable] = None, depth: int = 2,
           workers: int = 1, device_put: Optional[Callable] = None) -> Prefetcher:
    """``tf.staged`` analog (python/ops/prefetch.py:54): wrap an input
    iterator into an async staged pipeline."""
    return Prefetcher(it, prepare=prepare, depth=depth, workers=workers,
                      device_put=device_put)
