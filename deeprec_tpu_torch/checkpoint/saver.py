"""Checkpoint save and restore: full + incremental, in the JAX package's
format.

Port of ``deeprec_tpu/checkpoint/saver.py``:
- :class:`CheckpointManager` (284-560): ``save``, ``save_incremental``,
  ``maybe_save``, ``_gc``, ``attach_aux`` and ``restore``, for a
  ``Trainer`` and for a ``parallel.ShardedTrainer``. Tables go through
  their collection's hooks
  (``ckpt_arrays``/``ckpt_restore``); a ``ckpt_restore`` that returns None
  (the device-index ``EmbeddingCollection``) hands its table to the
  generic EV flow: a fresh table at the capacity the saved rows need, the
  base and then each incremental scattered in, oldest first. Dense leaves are written in the order of
  the JAX tree ``(params, opt_state, step)``: the flax variables (a
  model's running statistics first, then its params), the optax state
  of the trainer's dense optimizer (``optim.dense``: Adagrad's
  accumulators, or Adam's count and moments), the step. So a save of the
  port restores into the JAX ``Trainer`` and a JAX save into the port's.
  A tiered table's host tier is saved too, as a ``__tier__<name>`` table
  of keys and payload rows (every row in a full save, the rows demoted
  since the last save in an incremental), and restored after the device
  rows. Under a ``ShardedTrainer`` every rank saves its own shard as one
  part file (``F.write_save`` with ``part``/``n_parts``/``barrier``, the
  JAX ``_mp`` writer), and rank 0 writes the dense leaves, the manifest
  and the aux parts and collects old saves; a restore at any rank count
  reads every part, routes the rows with :func:`route_to_shards` and keeps
  its own shard, at a capacity every rank computes alike from the saved
  row count (``needed_capacity`` of ``ceil(n / S) + 8``).

  Two faults of the JAX package are fixed here. The tier's since-save
  window is cleared only once ``F.write_save`` has returned (a save that
  fails leaves the next incremental carrying the same rows). And a key
  whose saved tier row is newer than its saved device row is left out of
  the restored device stores and the resolver, so it lives in one tier
  only and its next touch promotes the saved payload (the JAX restore
  keeps both, and training resumes from the stale device row).
- ``table_snapshot_host`` (56-150) for one shard, the table's own or
  this rank's: live rows compacted on the host, save-time eviction,
  version-delta incrementals (a table without version stamps falls back
  to all live rows, with the JAX package's warning), slot rows and scalar
  leaves, and the CBF sketch with ``cbf_shards`` (a rank's block as
  ``cbf__shard<k>``, as the JAX multi-process writer names it).
- ``_scatter_table`` (157-203) and ``needed_capacity`` (219-223). The
  serving path ignores the optimizer slot rows, scalars and CBF sketch
  of a saved table, since serving never reads them; the training
  restore (:func:`_scatter_train_table`) writes them too, the CBF only
  when its shape matches the table's. The row stores are written in
  place (a serving table is a few hundred MB at Criteo scale, so no
  second copy is made); callers swap tables under their own lock.
- ``last_wins_sel``, ``_cbf_for_shard`` and ``route_to_shards``
  (253-281). (``_keys64`` has no place here: the port's keys are int64
  tensors throughout.)
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import EmbeddingVariableConfig, L2WeightEvict
from ..models.ctr import flax_leaf_count, flax_leaves, load_flax_params
from ..sparse import embedding_var as ev
from ..sparse import hashtable as ht
from ..sparse import keys as K
from ..utils.tree import map_leaves
from . import format as F


def _rows(t: torch.Tensor, idx: np.ndarray):
    """Rows ``idx`` of a tensor (on any device; only those rows come to the
    host) as a save stores them: numpy, except bfloat16, which
    ``checkpoint.format`` writes from the tensor."""
    rows = t[torch.from_numpy(idx).to(t.device)].cpu()
    return rows if rows.dtype == torch.bfloat16 else rows.numpy()


def table_snapshot_host(config: EmbeddingVariableConfig, ev_state: ev.EVState,
                        slot_state, num_shards: int = 1,
                        since_step: Optional[int] = None, evict: bool = True,
                        global_step: Optional[int] = None, shard: int = 0
                        ) -> Dict[str, Any]:
    """Compact the live rows of a device-index table (with ``since_step``,
    those touched at or after it) into the save's arrays: keys, values,
    freqs, versions, create steps, ``slot__`` rows and ``scalar__`` leaves
    of the optimizer state, and the CBF sketch. ``evict`` applies the
    table's eviction policy at ``global_step`` (``ev.cold_mask_np``).
    With ``num_shards`` > 1, ``ev_state`` is shard ``shard`` of the table
    (one rank's part of the save)."""
    cap = config.capacity
    if since_step is not None and not config.version_tracked:
        # a light-layout table has no version stamps: a version-delta
        # selection would drop every row, so the section holds all of them
        warnings.warn(
            f"table {config.name!r} has no version tracking "
            "(track_version/evict unset): incremental save falls back to "
            "all live rows for it", stacklevel=2)
        since_step = None
    keys = ev_state.index.keys.cpu().numpy()
    versions = ev_state.versions[:cap].cpu().numpy()
    live = keys != K.EMPTY
    if evict and config.evict is not None and global_step is not None:
        values = (ev_state.values[:cap].float().cpu().numpy()
                  if isinstance(config.evict, L2WeightEvict)
                  else np.zeros((cap, 1), np.float32))
        live &= ~ev.cold_mask_np(config, values, versions, live, global_step)
    if since_step is not None:
        live &= versions >= since_step
    idx = np.nonzero(live)[0]
    out = {"keys": keys[idx], "values": _rows(ev_state.values, idx),
           "freqs": _rows(ev_state.freqs, idx), "versions": versions[idx],
           "create_steps": _rows(ev_state.create_steps, idx)}
    for name, leaf in F.slot_leaf_names(slot_state):
        if leaf.dim() >= 1 and leaf.shape[0] == cap + 1:
            out[f"slot__{name}"] = _rows(leaf, idx)
        else:
            out[f"scalar__{name}"] = leaf.cpu().numpy()
    if ev_state.cbf is not None:
        out["cbf_shards"] = np.asarray(num_shards, np.int32)
        key = "cbf" if num_shards == 1 else f"cbf__shard{shard:03d}"
        out[key] = ev_state.cbf.cpu().numpy()
    return out


def _insert_rows(state: ev.EVState, config: EmbeddingVariableConfig,
                 arrays: Dict[str, Any]):
    """Insert the saved keys into the state's index and write their rows
    and metadata planes, all in place. Returns the state and the written
    slots and the saved rows they came from."""
    dev = state.values.device
    cap = config.capacity
    keys = torch.as_tensor(arrays["keys"], dtype=torch.int64).to(dev)
    index, slots, _ = ht.lookup_or_insert_(state.index, keys,
                                           config.max_probes)
    live = torch.nonzero(~K.is_empty(keys) & (slots != cap)).squeeze(1)
    dest = slots[live]
    for name, store in (("values", state.values), ("freqs", state.freqs),
                        ("versions", state.versions),
                        ("create_steps", state.create_steps)):
        store[dest] = torch.as_tensor(arrays[name]).to(dev,
                                                       store.dtype)[live]
    return state._replace(index=index), dest, live


def _scatter_table(state: ev.EVState, config: EmbeddingVariableConfig,
                   arrays: Dict[str, Any]) -> ev.EVState:
    """Insert the saved rows ``arrays`` (keys, values, freqs, versions,
    create_steps) into ``state``: the serving restore. Shared by a fresh
    restore and by the replay of incremental saves: a key already present
    is overwritten."""
    return _insert_rows(state, config, arrays)[0]


def _scatter_train_table(state: ev.EVState, slot_state,
                         config: EmbeddingVariableConfig,
                         arrays: Dict[str, Any]):
    """:func:`_scatter_table` plus the optimizer state: ``slot__`` rows at
    the same slots, ``scalar__`` leaves replaced, and the CBF sketch when
    its shape matches the table's (a sketch of another shard count cannot
    be re-routed). Returns ``(state, slot_state)``."""
    state, dest, live = _insert_rows(state, config, arrays)

    def leaf_from(path, leaf):
        name = F.slot_leaf_name(path)
        rk, sk = f"slot__{name}", f"scalar__{name}"
        if rk in arrays:
            rows = torch.as_tensor(arrays[rk]).to(leaf.device, leaf.dtype)
            leaf[dest] = rows[live]
        elif sk in arrays:
            return torch.as_tensor(arrays[sk]).to(leaf.device, leaf.dtype)
        return leaf
    slot_state = map_leaves(leaf_from, slot_state)
    cbf = arrays.get("cbf")
    if state.cbf is not None and cbf is not None and \
            tuple(cbf.shape) == tuple(state.cbf.shape):
        state.cbf.copy_(torch.as_tensor(cbf).to(state.cbf))
    return state, slot_state


def last_wins_sel(keys: np.ndarray) -> np.ndarray:
    """Indices selecting the LAST occurrence of each key in ``keys``
    (ascending original order). Parts are ordered oldest first, so the
    newest row wins."""
    if keys.size == 0:
        return np.empty(0, np.int64)
    order = np.arange(keys.shape[0])
    srt = np.lexsort((order, keys))
    ks = keys[srt]
    last = np.r_[ks[1:] != ks[:-1], True]
    return np.sort(srt[last])


def needed_capacity(n_rows: int, current: int, load: float = 0.6) -> int:
    cap = current
    while n_rows > load * cap:
        cap *= 2
    return cap


def _cbf_for_shard(arrays: Dict[str, np.ndarray], s: int, num_shards: int
                   ) -> Optional[np.ndarray]:
    """The CBF sketch of shard ``s`` at restore: the saved block when the
    shard count is unchanged, else the elementwise sum of all saved blocks
    (count-min sketches over disjoint key sets sum to a sketch of the
    union)."""
    cbf_shards = int(arrays["cbf_shards"]) if "cbf_shards" in arrays else 0
    blocks = [arrays[k] for k in sorted(arrays)
              if k.startswith("cbf__shard")]
    if "cbf" in arrays:
        full = arrays["cbf"]
        if cbf_shards == num_shards:
            m = full.shape[0] // num_shards
            return full[s * m:(s + 1) * m]
        if cbf_shards > 1:
            m = full.shape[0] // cbf_shards
            return full.reshape(cbf_shards, m).sum(axis=0, dtype=full.dtype)
        return full
    if blocks:
        if cbf_shards == num_shards and len(blocks) == num_shards:
            return blocks[s]
        return np.sum(np.stack(blocks), axis=0, dtype=blocks[0].dtype)
    return None


def route_to_shards(arrays: Dict[str, Any], num_shards: int
                    ) -> List[Dict[str, Any]]:
    """Split a table's saved rows by the owner hash of training
    (``parallel.sharded.owner_of_np``), one dict per shard of a restore at
    ``num_shards``; each shard takes its CBF block (:func:`_cbf_for_shard`:
    the saved block at the same shard count, else the union of every
    block)."""
    from ..parallel.sharded import owner_of_np
    keys = np.asarray(arrays["keys"])
    own = owner_of_np(keys, num_shards)
    skip = {k for k in arrays if k.startswith("cbf")}
    rows = {k for k, v in arrays.items()
            if k not in skip and getattr(v, "ndim", 0) >= 1
            and v.shape[0] == keys.shape[0]}
    cbf_shards = int(arrays["cbf_shards"]) if "cbf_shards" in arrays else 0
    union = (_cbf_for_shard(arrays, 0, num_shards)
             if cbf_shards != num_shards else None)
    out = []
    for s in range(num_shards):
        sel = np.nonzero(own == s)[0]
        shard = {k: (_take(arrays[k], sel) if k in rows else arrays[k])
                 for k in arrays if k not in skip}
        cbf = union if union is not None else _cbf_for_shard(arrays, s,
                                                             num_shards)
        if cbf is not None:
            shard["cbf"] = cbf
        out.append(shard)
    return out


def _take(rows, idx: np.ndarray):
    """Rows ``idx`` of a saved array (numpy, or a bfloat16 tensor)."""
    if isinstance(rows, torch.Tensor):
        return rows[torch.from_numpy(idx)]
    return rows[idx]


def _dense_leaves(trainer, state) -> list:
    """``(params, opt_state, step)`` as the JAX tree flattens them; the
    trainer's dense optimizer converts its state to the optax leaves."""
    return (flax_leaves(trainer.model)
            + trainer.dense_optimizer.flax_state_leaves(trainer.model,
                                                        state.opt_state)
            + [np.asarray(state.step, np.int32)])


_ROW_ARRAYS = ("keys", "values", "freqs", "versions", "create_steps")


def _tier_imports(coll, saves, name, parts):
    """The tier rows a restore imports, as ``[(keys, rows)]`` in save
    order (the JAX package's rule): a tier row is imported unless the
    device parts hold its key at an equal or newer version. Returns them
    and the keys imported."""
    vcol = coll.config.embedding_dim + coll.config.fused_slot_columns + 1
    parts = [p for p in parts if "keys" in p and len(p["keys"])]
    if parts:
        dk = np.concatenate([p["keys"] for p in parts])
        dv = np.concatenate([p["versions"] for p in parts])
        o = np.argsort(dk, kind="stable")
        ks, vs = dk[o], dv[o]
        starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
        kuniq, vmax = ks[starts], np.maximum.reduceat(vs, starts)
    else:
        kuniq = np.zeros((0,), np.int64)
    out = []
    for m in saves:
        try:
            tp = F.read_table(m["path"], f"__tier__{name}")
        except FileNotFoundError:
            continue
        tk = tp["keys"]
        mask = np.ones((len(tk),), bool)
        if len(kuniq):
            tver = tp["rows"][:, vcol].copy().view(np.int32)
            idx = np.searchsorted(kuniq, tk)
            safe = np.minimum(idx, len(kuniq) - 1)
            on_dev = (idx < len(kuniq)) & (kuniq[safe] == tk)
            dev_ver = np.where(on_dev, vmax[safe], np.int32(-2**31))
            mask = ~on_dev | (tver > dev_ver)
        if mask.any():
            out.append((tk[mask], tp["rows"][mask]))
    won = (np.unique(np.concatenate([k for k, _ in out])) if out
           else np.zeros((0,), np.int64))
    return out, won


def _without_keys(part, keys):
    """A saved table part without the rows of ``keys``."""
    if "keys" not in part or not len(keys):
        return part
    keep = ~np.isin(part["keys"], keys)
    if keep.all():
        return part
    keep_t = torch.from_numpy(keep)  # bfloat16 rows are read as tensors
    return {k: (v[keep_t if isinstance(v, torch.Tensor) else keep]
                if k in _ROW_ARRAYS or k.startswith("slot__") else v)
            for k, v in part.items()}


def _restore_ev_table(trainer, name: str, template, parts):
    """The generic EV restore of one device-index table: grow the
    collection to the capacity the saved rows need (load 0.6; under a
    ``ShardedTrainer`` of ``S`` ranks, ``ceil(n / S) + 8`` rows a shard),
    then scatter the base and each incremental, oldest first, into a fresh
    table and optimizer state on the template's device. A rank keeps the
    rows :func:`route_to_shards` gives its shard."""
    coll = trainer.collections[name]
    S, rank = getattr(trainer, "S", 1), getattr(trainer, "rank", 0)
    n_max = sum(p["keys"].shape[0] for p in parts if "keys" in p)
    cap = needed_capacity(int(np.ceil(n_max / S)) + 8, coll.config.capacity)
    if cap != coll.config.capacity:
        coll.config = dataclasses.replace(coll.config, capacity=cap)
        trainer.rejit()
    opt = trainer.sparse_optimizers[name]
    st = ev.create(coll.config, template.ev.values.device)
    slot = opt.init(st.values)
    for p in parts:
        if "keys" not in p:
            continue
        p = route_to_shards(p, S)[rank]
        st, slot = _scatter_train_table(st, slot, coll.config, p)
    return template._replace(ev=st, slot=slot)


class CheckpointManager:
    """Full + incremental checkpointing for a :class:`~deeprec_tpu_torch.
    train.trainer.Trainer` or a :class:`~deeprec_tpu_torch.parallel.
    ShardedTrainer`: full saves every ``full_secs`` and incremental saves
    every ``incr_secs`` through :meth:`maybe_save`, the ``keep`` newest full
    saves kept. Save only at a fence, with any ``HostStepPipeline``
    drained. Under a ``ShardedTrainer`` every rank calls every method, with
    one directory that all ranks share (:meth:`maybe_save` decides on rank
    0's clock, broadcast)."""

    def __init__(self, directory: str, full_secs: Optional[float] = None,
                 incr_secs: Optional[float] = None, keep: int = 3):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self.full_secs = full_secs
        self.incr_secs = incr_secs
        self.keep = keep
        self._last_full_time = time.time()
        self._last_incr_time = time.time()
        self._aux = {}  # name -> (snapshot_fn, restore_fn)
        saves = F.list_saves(directory)
        self._last_save_step = saves[-1]["step"] if saves else None

    # -- auxiliary run state (WorkQueue position etc.) -----------------------
    def attach_aux(self, name: str, snapshot_fn, restore_fn) -> None:
        """Save a JSON-able side state with every checkpoint
        (``snapshot_fn()`` at each save) and hand the newest applied save's
        copy to ``restore_fn`` after a restore (None: the caller applies
        it itself)."""
        self._aux[name] = (snapshot_fn, restore_fn)

    def _write_aux(self, path: str, trainer) -> None:
        if getattr(trainer, "rank", 0) != 0:
            return
        for name, (snap, _) in self._aux.items():
            tmp = os.path.join(path, f"aux_{name}.json.tmp")
            with open(tmp, "w") as f:
                json.dump(snap(), f)
            os.replace(tmp, os.path.join(path, f"aux_{name}.json"))

    def _restore_aux(self, newest_path: str) -> None:
        for name, (_, restore_fn) in self._aux.items():
            p = os.path.join(newest_path, f"aux_{name}.json")
            if restore_fn is not None and os.path.exists(p):
                with open(p) as f:
                    restore_fn(json.load(f))

    # -- save --------------------------------------------------------------
    def _collect(self, trainer, state, since: Optional[int], evict: bool):
        gs = int(state.step)
        S = getattr(trainer, "S", 1)
        shard = {"shard": trainer.rank} if S > 1 else {}
        tables = {}
        for name, coll in trainer.collections.items():
            tables[name] = coll.ckpt_arrays(state.tables[name], S, since,
                                            evict, gs, **shard)
        # a tier's rows are training state too: a restart must not lose them
        export_tiers = getattr(trainer, "export_tiers", None)
        if export_tiers is not None:
            for name, (keys, rows) in export_tiers(state, since=since).items():
                tables[f"__tier__{name}"] = {"keys": keys, "rows": rows}
        return tables, _dense_leaves(trainer, state)

    def _write(self, kind: str, trainer, state, since, evict) -> str:
        step = int(state.step)
        tables, dense = self._collect(trainer, state, since, evict)
        path = os.path.join(self.directory, F.step_dirname(kind, step))
        counts = {n: int(t["keys"].shape[0]) if "keys" in t else -1
                  for n, t in tables.items()}
        if getattr(trainer, "S", 1) > 1:  # the rows of every rank's part
            from ..parallel.multihost import _host_group_tensor
            # every rank has these (a tier table only where it is not empty)
            names = [n for n in sorted(trainer.collections) if counts[n] >= 0]
            total = trainer.axis.psum(_host_group_tensor(
                trainer.axis, np.asarray([counts[n] for n in names],
                                         np.int64))).tolist()
            counts.update(zip(names, total))
        manifest = {"kind": kind, "step": step, "tables": counts}
        if since is not None:
            manifest["since"] = since
        parts = {}
        if getattr(trainer, "S", 1) > 1:  # one part file per rank
            parts = dict(part=trainer.rank, n_parts=trainer.S,
                         barrier=trainer.axis.barrier)
        F.write_save(path, manifest, dense, tables, **parts)
        for coll in trainer.collections.values():  # the save is durable
            if hasattr(coll, "tier_saved"):
                coll.tier_saved()
        self._write_aux(path, trainer)
        self._last_save_step = step
        return path

    def save(self, trainer, state, evict: bool = True) -> str:
        path = self._write("full", trainer, state, None, evict)
        self._last_full_time = time.time()
        if getattr(trainer, "rank", 0) == 0:
            self._gc()
        return path

    def save_incremental(self, trainer, state) -> str:
        since = self._last_save_step
        if since is None:
            return self.save(trainer, state)
        path = self._write("incr", trainer, state, since, False)
        self._last_incr_time = time.time()
        return path

    def maybe_save(self, trainer, state) -> Optional[str]:
        now = time.time()
        full = self.full_secs is not None and \
            now - self._last_full_time >= self.full_secs
        incr = self.incr_secs is not None and \
            now - self._last_incr_time >= self.incr_secs
        if getattr(trainer, "S", 1) > 1:  # rank 0's clocks decide
            flags = torch.tensor([full, incr], dtype=torch.uint8,
                                 device=trainer.device)
            trainer.axis.broadcast_([flags])
            full, incr = bool(flags[0]), bool(flags[1])
        if full:
            return self.save(trainer, state)
        if incr:
            return self.save_incremental(trainer, state)
        return None

    def _gc(self):
        saves = F.list_saves(self.directory)
        fulls = [m for m in saves if m["kind"] == "full"]
        if self.keep and len(fulls) > self.keep:
            cutoff = fulls[-self.keep]["step"]  # oldest retained full
            for m in fulls[:-self.keep]:
                shutil.rmtree(m["path"], ignore_errors=True)
            # incrementals at or below the oldest retained full are
            # unreachable by any restore plan over the kept fulls
            for m in saves:
                if m["kind"] == "incr" and m["step"] <= cutoff:
                    shutil.rmtree(m["path"], ignore_errors=True)
        # superseded same-step copies, once the base directory exists (a
        # lone .old copy is the save: list_saves recovers it)
        names = set(os.listdir(self.directory))
        for name in names:
            if ".old." in name and name.split(".old.")[0] in names:
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)

    # -- restore -------------------------------------------------------------
    def restore(self, trainer, state) -> Tuple[Any, bool]:
        """Restore the latest full save and the newer incrementals into
        ``state`` (a fresh ``Trainer.init`` state: the template) and the
        trainer's model. Returns ``(state, restored?)``. Tables grow when
        the restored rows need it. Under a ``ShardedTrainer`` every rank
        restores the saves that rank 0 lists (a save landing meanwhile
        must reach all ranks or none)."""
        base, incrs = F.restore_plan(self.directory)
        if getattr(trainer, "S", 1) > 1:
            from ..parallel.multihost import broadcast_object
            base, incrs = broadcast_object((base, incrs), trainer.axis)
        if base is None:
            return state, False
        saves = [base] + incrs
        tables = {}
        tiers = getattr(trainer, "tiers", {})
        for name, coll in trainer.collections.items():
            parts = [F.read_table(m["path"], name) for m in saves]
            imports = []
            if name in tiers:
                imports, won = _tier_imports(coll, saves, name, parts)
                parts = [_without_keys(p, won) for p in parts]
            tables[name] = coll.ckpt_restore(trainer, state.tables[name],
                                             parts, 1)
            if tables[name] is None:
                tables[name] = _restore_ev_table(trainer, name,
                                                 state.tables[name], parts)
            for keys, rows in imports:  # oldest first: the newest row wins
                trainer.import_tier(name, keys, rows)

        # dense: the newest save wins (every save carries all of it)
        leaves = F.read_dense(saves[-1]["path"])
        opt = trainer.dense_optimizer
        n = flax_leaf_count(trainer.model)
        k = opt.state_leaf_count(n)
        if len(leaves) != n + k + 1:
            raise ValueError(
                f"{len(leaves)} dense leaves; the model takes {n}, its "
                f"{type(opt).__name__} state {k} and the step 1")
        load_flax_params(trainer.model, leaves[:n])
        opt_state = opt.load_flax_state(trainer.model, leaves[n:n + k])
        step = int(np.asarray(leaves[-1]))
        self._last_save_step = step
        self._restore_aux(saves[-1]["path"])
        if getattr(trainer, "S", 1) > 1:  # no rank starts before all read
            trainer.axis.barrier()
        return state._replace(opt_state=opt_state, tables=tables,
                              step=step), True
