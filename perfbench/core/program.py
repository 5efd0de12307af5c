"""The system under test: the port's trainer for a configuration, built as
its entry points build it, its training loop, and the readings taken from
its state.

:func:`build` is ``cli.make_trainer(mod.build(args), args)`` over the
flags the configuration states (``deeprec_tpu_torch/modelzoo/<M>/train.py``
without its data reading). :func:`drive` trains through the CLI's own
device-index loop (``train/cli.py`` ``_device_index_loop``, the loop of
``cli.run``): its prefetch workers pack each batch into page-locked
tensors and copy them to the card while the main thread runs
``Trainer._train_step``. :func:`admit` fills the table through the
collection's own ``lookup_or_create``. :func:`checked_steps` runs the
cell's first steps through :func:`drive` and reads what
``core/compare.py`` compares; the benchmark reads the program's index,
rows, accumulators, frequencies and parameters only to judge them.
"""
from __future__ import annotations

import importlib
from typing import Callable, Dict, Iterable, List, Optional, Sequence

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
            "--seed", str(int(seed) & (2 ** 63 - 1)), "--device", device]
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


def linears(tr) -> List[torch.nn.Linear]:
    return [m for m in tr.model.modules() if isinstance(m, torch.nn.Linear)]


def load_weights(tr, layers: Sequence, weights: Dict[str, torch.Tensor]):
    """Copy the benchmark's weights into the program's dense layers, which
    must be the configuration's, in its order."""
    lins = linears(tr)
    shapes = [(m.in_features, m.out_features) for m in lins]
    if shapes != [(a, b) for _, a, b in layers]:
        raise RuntimeError(f"the program's dense layers {shapes} are not "
                           f"the configuration's {layers}")
    with torch.no_grad():
        for m, (name, _, _) in zip(lins, layers):
            m.weight.copy_(weights[f"{name}.weight"])
            m.bias.copy_(weights[f"{name}.bias"])


def admit(tr, state, mix: dict, pool_ids: np.ndarray, batch: int,
          passes: int):
    """Fill the table at step 0: every pool batch looked up ``passes``
    times (the pool's keys enter the index in the order a job first meets
    them), then every id of each column's range ``0..count-1`` looked up
    ``passes`` times, in chunks of distinct ids under the dedup's width.
    The table then holds the dataset's whole id space, every key admitted
    by CounterFilter(``passes``)."""
    coll = tr.collections[COLLECTION]
    bundle = state.tables[COLLECTION]
    ev = bundle.ev
    ids = torch.from_numpy(pool_ids).to(tr.device)
    for _ in range(passes):
        for s in range(0, ids.shape[1], batch):
            ev, _ = coll.lookup_or_create(
                ev, {name: ids[c, s:s + batch]
                     for c, name in enumerate(mix["columns"])}, 0)
    del ids
    ends = np.cumsum([0] + [int(v) for v in mix["column_counts"]])
    width = coll.config.max_unique - 1
    for _ in range(passes):
        for s in range(0, int(ends[-1]), width):
            e = min(s + width, int(ends[-1]))
            chunk = {}
            for c, name in enumerate(mix["columns"]):
                lo = min(max(s, ends[c]), ends[c + 1]) - ends[c]
                hi = max(min(e, ends[c + 1]), ends[c]) - ends[c]
                chunk[name] = torch.arange(int(lo), int(hi),
                                           dtype=torch.int64,
                                           device=tr.device)
            ev, _ = coll.lookup_or_create(ev, chunk, 0)
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


def checked_steps(tr, args, state, cfg: dict, layers: Sequence,
                  weights: Dict[str, torch.Tensor], batches: Sequence[dict],
                  keyset):
    """Run ``batches`` (the cell's first steps) through :func:`drive` and
    read them after each step. Returns ``(state, readings)``."""
    probe = Probe(tr, keyset)
    d, lr = probe.dim, float(cfg["learning_rate"])
    rows0, _, _ = probe.rows(state)
    v0 = rows0[:, :d].clone()
    lead = torch.from_numpy(keyset.member(batches[0], len(
        batches[0]["label"]))).to(tr.device)
    losses, grad = [], {}
    before = [float(state.metrics.loss_sum)]

    def read(state, done):
        after = float(state.metrics.loss_sum)
        losses.append((after - before[0]) / len(batches[done - 1]["label"]))
        before[0] = after
        if done == 1:
            for m, (name, _, _) in zip(linears(tr), layers):
                grad[f"{name}.weight"] = _norm(m.weight.grad)
                grad[f"{name}.bias"] = _norm(m.bias.grad)
            rows1, _, _ = probe.rows(state)
            # Adagrad's first step, v1 = v0 - lr * g * rsqrt(a1), solved
            # for the gradient it was given
            g = (v0 - rows1[:, :d]) * torch.sqrt(rows1[:, d:2 * d]) / lr
            grad["emb"] = _norm(g[lead])
        return state
    state, _ = drive(tr, args, state, list(batches), read)
    rows3, slots3, found3 = probe.rows(state)
    ev = state.tables[COLLECTION].ev
    change = {}
    with torch.no_grad():
        for m, (name, _, _) in zip(linears(tr), layers):
            change[f"{name}.weight"] = _norm(m.weight - weights[
                f"{name}.weight"])
            change[f"{name}.bias"] = _norm(m.bias - weights[f"{name}.bias"])
    change["emb"] = _norm(rows3[:, :d] - v0)
    misses = int((~found3 | (slots3 == ev.capacity)).sum())
    return state, {"loss": losses, "grad": grad, "change": change,
                   "index_misses": misses,
                   "freqs": ev.freqs[slots3].cpu().numpy().astype(np.int64)}
