"""The system under test: the port's trainer for a configuration, built as
its entry points build it, its training loop, and the readings taken from
its state.

:func:`build` is ``cli.make_trainer(mod.build(args), args)`` over the
flags the configuration states, its ``flags`` last
(``deeprec_tpu_torch/modelzoo/<M>/train.py`` without its data reading).
:func:`drive` trains through the CLI's own device-index loop
(``train/cli.py`` ``_device_index_loop``, the loop of ``cli.run``): its
prefetch workers pack each batch into page-locked tensors and copy them
to the card while the main thread runs ``Trainer._train_step``.
:func:`admit` fills the table through the collection's own
``lookup_or_create``. :func:`checked_steps` runs the cell's first steps
through :func:`drive` and reads what ``core/compare.py`` compares; the
benchmark reads the program's index, rows, optimizer slots, frequencies
and parameters only to judge them.
"""
from __future__ import annotations

import importlib
from typing import Callable, Dict, Iterable, Optional, Sequence

import numpy as np
import torch

COLLECTION = "emb"


def build(cfg: dict, batch: int, max_unique_ratio: float, seed: int,
          device: str):
    """The trainer of configuration ``cfg`` on ``device``."""
    from deeprec_tpu_torch.train import cli
    mod = importlib.import_module(
        f"deeprec_tpu_torch.modelzoo.{cfg['zoo_model']}.train")
    argv = ["--batch_size", str(batch), "--emb_dim", str(cfg["emb_dim"]),
            "--capacity", str(cfg["capacity"]),
            "--optimizer", cfg["optimizer"],
            "--learning_rate", repr(float(cfg["learning_rate"])),
            "--ev_filter_freq", str(cfg["ev_filter_freq"]),
            "--ev_evict_steps", str(cfg["ev_evict_steps"]),
            "--max_unique_ratio", repr(float(max_unique_ratio)),
            "--seed", str(int(seed) & (2 ** 63 - 1)), "--device", device,
            *cfg.get("flags", [])]
    args = cli.base_parser(cfg["zoo_model"]).parse_args(argv)
    return cli.make_trainer(mod.build(args), args), args


def drive(tr, args, state, batches: Iterable[dict],
          after: Optional[Callable] = None):
    """Train on ``batches`` through the CLI's device-index loop, with the
    CLI's prefetch depth and workers. ``after(state, done)``, where given,
    runs after every step as the CLI's fence work does (and returns the
    state); without it no fence runs. Returns ``(state, steps)``."""
    from deeprec_tpu_torch.train import cli
    every = 1 if after is not None else 1 << 62
    return cli._device_index_loop(tr, state, batches, args, every,
                                  after or (lambda st, done: st))


def load_weights(tr, params: Sequence, weights: Dict[str, torch.Tensor]):
    """Copy the benchmark's weights into the program's parameters, which
    must be the configuration's (``params``: name, shape, init), by name
    and shape, in ``named_parameters()`` order."""
    mine = [(n, tuple(p.shape)) for n, p in tr.model.named_parameters()]
    want = [(n, tuple(s)) for n, s, _ in params]
    if mine != want:
        raise RuntimeError(f"the program's parameters {mine} are not the "
                           f"configuration's {want}")
    with torch.no_grad():
        for n, p in tr.model.named_parameters():
            p.copy_(weights[n])


def admit(tr, state, pool, passes: int):
    """Fill the table at step 0, space by space (``pool.spaces``; each
    looked up under its first column, so a shared space is admitted once):
    every pool batch's valid lanes of every space looked up ``passes``
    times (the pool's keys enter the index in the order a job first meets
    them), then every id of each space's range ``0..count-1`` looked up
    ``passes`` times, in chunks of distinct ids under the dedup's width.
    The table then holds the dataset's whole id space, every key admitted
    by CounterFilter(``passes``)."""
    coll = tr.collections[COLLECTION]
    bundle = state.tables[COLLECTION]
    ev = bundle.ev
    none = torch.zeros((0,), dtype=torch.int64, device=tr.device)

    def lookup(ev, parts):
        chunk = {c.name: none for c in coll.columns}
        chunk.update({sp.columns[0]: t
                      for sp, t in zip(pool.spaces, parts)})
        return coll.lookup_or_create(ev, chunk, 0)[0]
    ids = [torch.from_numpy(sp.ids).to(tr.device) for sp in pool.spaces]
    for _ in range(passes):
        for b in range(len(pool.batches)):
            ev = lookup(ev, [x[int(sp.ends[b]):int(sp.ends[b + 1])]
                             for sp, x in zip(pool.spaces, ids)])
    del ids
    ends = np.cumsum([0] + [sp.count for sp in pool.spaces])
    width = coll.config.max_unique - 1
    for _ in range(passes):
        for s in range(0, int(ends[-1]), width):
            e = min(s + width, int(ends[-1]))
            parts = []
            for c in range(len(pool.spaces)):
                lo = min(max(s, ends[c]), ends[c + 1]) - ends[c]
                hi = max(min(e, ends[c + 1]), ends[c]) - ends[c]
                parts.append(torch.arange(int(lo), int(hi),
                                          dtype=torch.int64,
                                          device=tr.device))
            ev = lookup(ev, parts)
    return state._replace(tables={**state.tables,
                                  COLLECTION: bundle._replace(ev=ev)})


def table_keys(state) -> Dict[str, int]:
    """The keys the table's index holds, its slots, and the inserts it
    has failed."""
    from deeprec_tpu_torch.sparse import keys as K
    index = state.tables[COLLECTION].ev.index
    return {"keys": int((index.keys != K.EMPTY).sum()),
            "slots": int(index.capacity),
            "failed_inserts": int(index.overflow[0])}


class Probe:
    """The program's slots for the reference's keys (``KeySet`` order)."""

    def __init__(self, tr, keyset):
        from deeprec_tpu_torch.sparse import hashtable
        self._lookup = hashtable.lookup
        coll = tr.collections[COLLECTION]
        self.dim = coll.config.embedding_dim
        self.max_probes = coll.config.max_probes
        keys = np.concatenate([coll.transform_raw_keys(c, ids)
                               for c, ids in zip(keyset.columns, keyset.ids)])
        self.keys = torch.from_numpy(keys).to(tr.device)

    def find(self, state):
        ev = state.tables[COLLECTION].ev
        return self._lookup(ev.index, self.keys, self.max_probes)

    def rows(self, state):
        slots, found = self.find(state)
        ev = state.tables[COLLECTION].ev
        return ev.values[slots], slots, found


def _norm(t) -> float:
    return 0.0 if t is None else float(t.detach().double().norm())


def first_row_grads(cfg: dict, v0, rows1, d: int):
    """The gradient each row was given in the first step, worked out from
    its value before (``v0``) and its row and slots after (``rows1``):
    Adagrad's ``v1 = v0 - lr * g * rsqrt(a1)`` solved for ``g``; Adam's
    first moment ``m1 = (1 - b1) g``."""
    if cfg["optimizer"] == "adagrad":
        lr = float(cfg["learning_rate"])
        return (v0 - rows1[:, :d]) * torch.sqrt(rows1[:, d:2 * d]) / lr
    if cfg["optimizer"] == "adam":
        return rows1[:, d:2 * d] / (1.0 - float(cfg["adam"]["beta1"]))
    raise ValueError(f"no reading of {cfg['optimizer']!r}'s slots")


def checked_steps(tr, args, state, cfg: dict,
                  weights: Dict[str, torch.Tensor], batches: Sequence[dict],
                  keyset):
    """Run ``batches`` (the cell's first steps) through :func:`drive` and
    read them after each step: every trainable parameter's first gradient
    and three-step change, and the checked keys' rows. Returns ``(state,
    readings)``."""
    probe = Probe(tr, keyset)
    d = probe.dim
    rows0, _, _ = probe.rows(state)
    v0 = rows0[:, :d].clone()
    lead = torch.from_numpy(keyset.member(batches[0], len(
        batches[0]["label"]))).to(tr.device)
    params = dict(tr.model.named_parameters())
    losses, grad = [], {}
    before = [float(state.metrics.loss_sum)]

    def read(state, done):
        after = float(state.metrics.loss_sum)
        losses.append((after - before[0]) / len(batches[done - 1]["label"]))
        before[0] = after
        if done == 1:
            for name, p in params.items():
                grad[name] = _norm(p.grad)
            rows1, _, _ = probe.rows(state)
            grad["emb"] = _norm(first_row_grads(cfg, v0, rows1, d)[lead])
        return state
    state, _ = drive(tr, args, state, list(batches), read)
    rows3, slots3, found3 = probe.rows(state)
    ev = state.tables[COLLECTION].ev
    with torch.no_grad():
        change = {name: _norm(p - weights[name])
                  for name, p in params.items()}
    change["emb"] = _norm(rows3[:, :d] - v0)
    misses = int((~found3 | (slots3 == ev.capacity)).sum())
    return state, {"loss": losses, "grad": grad, "change": change,
                   "index_misses": misses,
                   "freqs": ev.freqs[slots3].cpu().numpy().astype(np.int64)}
