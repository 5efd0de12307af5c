"""Design probe for run-to-run drift on the card: one training step run
twice from one state and one batch, every tensor it makes compared bit for
bit, the first that differs reported.

:func:`capture_step` runs ``trainer._train_step`` once (a ``Trainer`` or a
``ShardedTrainer``, either engine) and records, in the order the step
makes them: the model's inputs (the pooled embeddings), each module's
forward output, the cotangents of the rows the collections pool from (as
backward reaches them), every parameter's ``.grad``, and the updated state
(tables and slot states, parameters, buffers, the dense optimizer's state,
the metrics). :func:`bisect` restores the state and the model between two
such runs and returns the first tensor whose bits differ. ``chip_smoke.py``'s
``determinism`` phase runs it on every one-card training path.

:func:`finder` runs one step under
``torch.use_deterministic_algorithms(True, warn_only=True)`` and returns
the warnings torch raises for the ops on the step that have no
deterministic implementation (ops torch makes deterministic in that mode
raise none, nor do the port's kernels); the previous mode is restored
after. It finds candidates and proves nothing: no code of the port's
training or serving path sets that mode. ``python3 chip_smoke.py
--find-nondeterminism``, from the root of a checkout on a machine with
one card, runs the finder and the bisect on the smoke's paths and prints
one line each. Nothing here runs at import.
"""
from __future__ import annotations

import warnings
from typing import Any, Callable, List, Optional, Tuple

import torch

from ..utils.tree import leaves_with_paths, map_leaves

Record = List[Tuple[str, torch.Tensor]]
_POOLING = ("embeddings", "sequence_embeddings", "embeddings_from_rows",
            "sequence_embeddings_from_rows")


def _tensors(x, path: str = "") -> List[Tuple[str, torch.Tensor]]:
    """The tensors of an output tree (tuples, lists, dicts, NamedTuples)."""
    if isinstance(x, torch.Tensor):
        return [(path, x)]
    if isinstance(x, dict):
        return [t for k in x for t in _tensors(x[k], f"{path}[{k!r}]")]
    if isinstance(x, (tuple, list)):
        return [t for i, v in enumerate(x) for t in _tensors(v, f"{path}[{i}]")]
    return []


def clone_state(state):
    """A copy of a train state whose tensors a step may update in place."""
    return map_leaves(lambda _, x: x.clone() if isinstance(x, torch.Tensor)
                      else x, state)


def capture_step(tr, state, args) -> Tuple[Any, Record]:
    """``tr._train_step(state, *args)`` with every tensor it makes recorded
    (detached copies), in the order it makes them. Returns the new state
    and the record."""
    rec: Record = []

    def put(name, x):
        for p, t in _tensors(x):
            rec.append((name + p, t.detach().clone()))

    hooks = [tr.model.register_forward_pre_hook(
        lambda m, a, kw: put("model input", (a, kw)), with_kwargs=True)]
    hooks += [m.register_forward_hook(
        lambda m, i, o, n=n: put(f"forward {n or 'model'}", o))
        for n, m in tr.model.named_modules()]
    hooked = set()

    def wrap(table, name, fn):
        def pool(rows, *a, **kw):
            if rows.requires_grad and id(rows) not in hooked:
                hooked.add(id(rows))
                rows.register_hook(
                    lambda g: put(f"cotangent {table} rows", g))
            out = fn(rows, *a, **kw)
            put(f"{table} {name}", out)
            return out
        return pool
    patched = []
    for table, coll in tr.collections.items():
        for name in _POOLING:
            fn = getattr(coll, name, None)
            if fn is not None:
                setattr(coll, name, wrap(table, name, fn))
                patched.append((coll, name))
    try:
        new = tr._train_step(state, *args)
    finally:
        for h in hooks:
            h.remove()
        for coll, name in patched:
            delattr(coll, name)  # the class's method again
    for n, p in tr.model.named_parameters():
        if p.grad is not None:
            put(f"grad {n}", p.grad)
    for name, b in new.tables.items():
        for p, x in leaves_with_paths((b.ev, b.slot)):
            if isinstance(x, torch.Tensor):
                put(f"state {name}{p}", x)
    for n, x in list(tr.model.named_parameters()) + \
            list(tr.model.named_buffers()):
        put(f"state {n}", x)
    for p, x in leaves_with_paths((new.opt_state, new.metrics)):
        if isinstance(x, torch.Tensor):
            put(f"state opt/metrics{p}", x)
    return new, rec


def _sync():
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _bits(t: torch.Tensor) -> torch.Tensor:
    if not t.is_floating_point() or t.numel() == 0:
        return t
    return t.contiguous().view({2: torch.int16, 4: torch.int32,
                                8: torch.int64}[t.element_size()])


def first_difference(a: Record, b: Record) -> Optional[Tuple[str, float]]:
    """The first tensor of two records whose bits differ, and its largest
    difference; None when every tensor is bit-equal."""
    if [n for n, _ in a] != [n for n, _ in b]:
        return ("the two runs made different tensors", float("nan"))
    for (n, x), (_, y) in zip(a, b):
        if x.shape != y.shape or x.dtype != y.dtype or \
                not torch.equal(_bits(x), _bits(y)):
            d = ((x.double() - y.double()).abs().max().item()
                 if x.shape == y.shape and x.numel() else float("nan"))
            return n, d
    return None


def bisect(tr, state, args: Callable[[], Any]):
    """Two runs of one step from ``state``: the model's parameters and
    buffers and the state restored between them, ``args()`` giving the
    step's arguments each time. Returns ``(first difference or None,
    tensors compared, the second run's new state)``."""
    saved = {k: v.detach().clone() for k, v in tr.model.state_dict().items()}
    _, one = capture_step(tr, clone_state(state), args())
    with torch.no_grad():
        tr.model.load_state_dict(saved)
    new, two = capture_step(tr, clone_state(state), args())
    _sync()
    return first_difference(one, two), len(one), new


def finder(tr, state, args) -> List[str]:
    """The nondeterminism warnings torch raises over one step from a copy
    of ``state`` (the model restored after it)."""
    was = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    saved = {k: v.detach().clone() for k, v in tr.model.state_dict().items()}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            tr._train_step(clone_state(state), *args)
            _sync()
        finally:
            torch.use_deterministic_algorithms(was, warn_only=warn_only)
    with torch.no_grad():
        tr.model.load_state_dict(saved)
    return sorted({str(w.message).split("\n")[0] for w in caught
                   if "deterministic" in str(w.message)})

