"""Host-step pipeline: keep the host half of a host-index step ahead of the
device step.

Port of ``deeprec_tpu/train/pipeline.py`` ``HostStepPipeline``. A step's
host work has two stages with different rules:

* **resolve** (key -> slot; mutates the index): single-threaded, in step
  order. ``Trainer.prepare_host(batch, pin=True)`` is this stage: numpy
  packing and the C++ resolve, written into page-locked tensors.
* **transfer** (the copies to the card): order-free. Here it replaces the
  JAX package's ``jax.device_put``: the pinned buffers are copied with
  ``non_blocking=True`` on a side ``torch.cuda.Stream``, an event is
  recorded there, and :meth:`HostStepPipeline.take` makes the consuming
  stream wait on that event and calls ``record_stream`` on the copies, so
  the caching allocator does not hand their memory to the side stream
  again while the step still reads it. PyTorch's pinned-memory allocator
  records each async copy on its host buffer, so a buffer the resolve
  stage frees early is not reused before its copy lands. On a CPU device
  the transfer is a plain ``.to``.

Each stage runs on its own single-worker executor, chained per item: the
device runs step N while the transfer thread copies step N+1 and the
resolve thread indexes step N+2; the main thread only launches steps.

Draining rule: work that reads or rewrites table state off the step path
(checkpoint saves, growth, eval, health) must see a resolver exactly as
far as the device state. :meth:`HostStepPipeline.run` drains before each
fence; call :meth:`HostStepPipeline.drain` before any other such work.
"""
from __future__ import annotations

from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Iterable, List, NamedTuple, Optional

import torch

from ..utils import spans


def to_device(tree, device, non_blocking: bool = False):
    """Copy every tensor (and wire: an object with ``to`` and
    ``tensors``, ``host_index.ResolvedWire`` or ``parallel.host_sharded.
    HostShardedWire``) of a tuple/list/dict tree to ``device``."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor) or hasattr(tree, "tensors"):
        return tree.to(device, non_blocking=non_blocking)
    if isinstance(tree, dict):
        return {k: to_device(v, device, non_blocking) for k, v in tree.items()}
    return type(tree)(to_device(v, device, non_blocking) for v in tree)


def _tensors(tree) -> List[torch.Tensor]:
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if hasattr(tree, "tensors"):  # a resolved wire
        return tree.tensors()
    vals = tree.values() if isinstance(tree, dict) else tree
    return [t for v in vals for t in _tensors(v)]


class _InFlight(NamedTuple):
    out: Any                 # the device copies
    done: torch.cuda.Event   # recorded on the side stream after them


class HostStepPipeline:
    """Two-stage (resolve -> transfer) pipeline over source items.

    Args:
      resolve: the step-order host stage. Takes one source item and
        returns the step's arguments as a tuple/list/dict tree of CPU
        tensors and wires (pinned, for an async copy). Runs on one
        dedicated thread, in submission order.
      depth: the most items in flight (2-3 hides resolve and copy under a
        device step at least as long as the slower stage).
      device: where the transfer stage copies to: the card unless the
        caller names the CPU.
    """

    def __init__(self, resolve: Callable[[Any], Any], depth: int = 3,
                 device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("HostStepPipeline(device='cuda') but torch "
                               "sees no CUDA device")
        self._resolve = resolve
        self._side = (torch.cuda.Stream(self.device)
                      if self.device.type == "cuda" else None)
        self._exR = ThreadPoolExecutor(1, thread_name_prefix="hidx-resolve")
        self._exT = ThreadPoolExecutor(1, thread_name_prefix="hidx-h2d")
        self._q: deque = deque()
        self.depth = max(1, int(depth))
        self._closed = False

    # -- core ------------------------------------------------------------
    def _copy(self, host):
        if self._side is None:
            return to_device(host, self.device)
        with torch.cuda.stream(self._side):
            out = to_device(host, self.device, non_blocking=True)
        done = torch.cuda.Event()
        done.record(self._side)
        return _InFlight(out, done)

    def feed(self, item, batch: Optional[int] = None) -> None:
        """Schedule one source item through resolve -> transfer (spans
        ``resolve`` and ``transfer``, numbered ``batch``)."""
        if self._closed:
            raise RuntimeError("pipeline closed")
        fr = self._exR.submit(self._stage_r, item, batch)
        self._q.append(self._exT.submit(self._stage_t, fr, batch))

    def _stage_r(self, item, batch):
        with spans.span("resolve", batch):
            return self._resolve(item)

    def _stage_t(self, fr: Future, batch):
        host = fr.result()
        with spans.span("transfer", batch):
            return self._copy(host)

    def take(self):
        """The oldest item, ready for the current stream: its copies are
        ordered before any work queued on that stream from here on."""
        item = self._q.popleft().result()
        if not isinstance(item, _InFlight):
            return item
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(item.done)
        for t in _tensors(item.out):
            t.record_stream(stream)
        return item.out

    def __len__(self) -> int:
        return len(self._q)

    # -- loop helpers ------------------------------------------------------
    def run(self, source: Iterable, step: Callable[[Any], None],
            fence_every: int = 0, on_fence: Optional[Callable] = None) -> int:
        """Drive ``step(args)`` over ``source`` with the pipeline primed
        ``depth`` ahead; every ``fence_every`` consumed items the pipeline
        is drained (the resolver as far as the device state) and
        ``on_fence(n_done)`` runs. Returns the number of steps."""
        it = iter(source)
        done = 0
        exhausted = False
        while not exhausted or len(self):
            while not exhausted and len(self) < self.depth:
                try:
                    self.feed(next(it))
                except StopIteration:
                    exhausted = True
            if not len(self):
                break
            step(self.take())
            done += 1
            if fence_every and done % fence_every == 0:
                done += self.drain(step)
                if on_fence is not None:
                    on_fence(done)
        return done

    def drain(self, step: Callable[[Any], None]) -> int:
        """Consume every in-flight item through ``step``; afterwards the
        resolver state matches the launched device state."""
        n = 0
        while len(self):
            step(self.take())
            n += 1
        return n

    def close(self) -> None:
        self._closed = True
        self._exR.shutdown(wait=False)
        self._exT.shutdown(wait=False)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
