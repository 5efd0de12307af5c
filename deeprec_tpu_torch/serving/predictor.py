"""Serving: a read-only predictor over a checkpoint directory, with live
incremental refresh.

Port of ``deeprec_tpu/serving/predictor.py`` ``Predictor`` and
``TieredPredictor``. A :class:`Predictor` restores every collection's
saved rows into a hash index and row store on ``device`` (a tiered save's
``__tier__`` rows first, its device rows second), carries the
flax-trained dense weights into the caller's torch module
(:func:`~deeprec_tpu_torch.models.ctr.load_flax_params`), and answers
``predict(batch)`` with click probabilities. Lookups are read-only:
unknown keys read their deterministic init row (the EV default-value
semantics). :meth:`Predictor.refresh` applies newer saves (a new full save
reloads; incrementals replay in order) without rebuilding the model.

:class:`TieredPredictor` serves a table larger than the device's row
budget: the hottest ``device_row_budget`` rows (by freq, then version) go
to the device table and the rest to a host ``HostKV``. A request's keys
that the device table lacks are looked up in the host store; their rows
replace the unique rows (one per unique key) before pooling, so kernel K2
still pools through ``inverse`` and the ``[n, dim]`` expanded rows are
never made.

:class:`ShardedPredictor` serves a table row-sharded over the ranks of a
``torch.distributed`` group (``parallel.make_mesh``): each rank restores
its own shard of a save written at any shard count (the owner-hash
routing of training, ``checkpoint.saver.route_to_shards``), and every
rank calls ``predict`` with the same request, serves its slice through
the read-only owner exchange (kernels K1 and K2) and returns the whole
batch's probabilities. It serves EV tables (a device-index or
host-index training job's saves), as the JAX ``ShardedPredictor`` does;
the variant tables serve through the one-device ``Predictor``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np
import torch

from ..checkpoint import format as F
from ..checkpoint.saver import (_scatter_table, last_wins_sel,
                                needed_capacity, route_to_shards)
from ..feature_column import (EmbeddingCollection, NumericColumn, pack_dense,
                              normalize_dense)
from ..models.ctr import load_flax_params
from ..sparse import embedding_var as ev
from ..sparse import keys as K
from ..train.trainer import _readonly_lookup, default_forward
from ..utils.native import HostKV


def _adopt_row_layout(coll, arrays) -> None:
    """Adopt the checkpoint's row width: training may have fused optimizer
    slot columns into the value rows (``fused_slot_columns``), so the
    stored width is ``embedding_dim + fused``. Serving reads it from the
    checkpoint instead of the training flags and fetches the first
    ``embedding_dim`` columns either way."""
    cfg = coll.config
    extra = arrays["values"].shape[1] - cfg.embedding_dim
    if extra >= 0 and extra != cfg.fused_slot_columns:
        coll.config = dataclasses.replace(cfg, fused_slot_columns=extra)


class Predictor:
    """Read-only model server over a checkpoint directory.

    Args:
      model: the torch module to serve (e.g. ``models.ctr.DLRM``); its
        weights are loaded from the checkpoint.
      numeric_columns / collections: the feature config of training.
      ckpt_dir: a directory of saves (JAX ``CheckpointManager`` format).
      device: where tables and model live: the card (``"cuda"``, the
        default; raises when torch sees none) or ``"cpu"``.
      forward: optional custom forward, ``default_forward``'s signature.
    """

    def __init__(self, model: torch.nn.Module,
                 numeric_columns: Sequence[NumericColumn],
                 collections: Dict[str, EmbeddingCollection], ckpt_dir: str,
                 *, device="cuda", forward=None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Predictor(device='cuda') but torch sees no "
                               "CUDA device")
        self.model = model.to(self.device).eval()
        self.numeric_columns = list(numeric_columns)
        # a host-index training collection carries a resolver that serving
        # must not share or mutate: serve its device-index view
        self.collections = {n: (c.device_view()
                                if hasattr(c, "device_view") else c)
                            for n, c in collections.items()}
        self.ckpt_dir = ckpt_dir
        self.forward = forward or default_forward
        self.step = None
        self.tables: Dict[str, ev.EVState] = {}
        self._applied_steps: set = set()
        base, incrs = self._restore_plan()
        if base is None:
            raise FileNotFoundError(f"no full checkpoint in {ckpt_dir}")
        self._load_base(base)
        for m in incrs:
            self._apply_save(m)

    # -- loading -----------------------------------------------------------
    def _restore_plan(self):
        """(the full save to load, the incrementals after it), as
        ``checkpoint.format.restore_plan`` lists the directory."""
        return F.restore_plan(self.ckpt_dir)

    @staticmethod
    def _tier_arrays(coll, manifest, name):
        """A save's demoted rows in the device table's array format (values
        and the bit-cast metadata; the optimizer slot rows, which serving
        never reads, dropped), or None when the save has none."""
        try:
            tp = F.read_table(manifest["path"], f"__tier__{name}")
        except FileNotFoundError:
            return None
        dim = coll.config.embedding_dim + coll.config.fused_slot_columns
        rows = tp["rows"]
        return {
            "keys": tp["keys"],
            "values": rows[:, :dim],
            "freqs": rows[:, dim].copy().view(np.int32),
            "versions": rows[:, dim + 1].copy().view(np.int32),
            "create_steps": rows[:, dim + 2].copy().view(np.int32),
        }

    def _load_base(self, manifest):
        for name, coll in self.collections.items():
            arrays = F.read_table(manifest["path"], name)
            _adopt_row_layout(coll, arrays)
            tier = self._tier_arrays(coll, manifest, name)
            n_rows = arrays["keys"].shape[0] + \
                (tier["keys"].shape[0] if tier else 0)
            cap = needed_capacity(n_rows + 8, coll.config.capacity)
            if cap != coll.config.capacity:
                coll.config = dataclasses.replace(coll.config, capacity=cap)
            st = ev.create(coll.config, self.device)
            # tier rows first, device rows second: a key in both was
            # promoted and trained after its demotion, so its device row
            # is the newer one
            if tier is not None:
                st = _scatter_table(st, coll.config, tier)
            self.tables[name] = _scatter_table(st, coll.config, arrays)
        self._load_dense(manifest)
        self._applied_steps.add(manifest["step"])

    def _load_dense(self, manifest):
        leaves = F.read_dense(manifest["path"])
        load_flax_params(self.model, leaves)
        self.step = int(np.asarray(leaves[-1]))

    def _apply_save(self, manifest):
        if manifest["step"] in self._applied_steps:
            return
        for name, coll in self.collections.items():
            arrays = F.read_table(manifest["path"], name)
            tier = self._tier_arrays(coll, manifest, name)
            st = self.tables[name]
            size = int(st.index.size.sum())
            n_new = arrays["keys"].shape[0] + \
                (tier["keys"].shape[0] if tier else 0)
            cap = needed_capacity(size + n_new, coll.config.capacity)
            if cap != coll.config.capacity:
                st, _ = ev.grow(st, coll.config, cap)
                coll.config = dataclasses.replace(coll.config, capacity=cap)
            if tier is not None:  # tier first, device second (_load_base)
                st = _scatter_table(st, coll.config, tier)
            self.tables[name] = _scatter_table(st, coll.config, arrays)
        self._load_dense(manifest)
        self._applied_steps.add(manifest["step"])

    # -- refresh -----------------------------------------------------------
    def refresh(self) -> bool:
        """Apply any new saves in the directory. A newer FULL save reloads
        the base; newer incrementals replay in order. Returns True if the
        serving state changed."""
        base, incrs = self._restore_plan()
        changed = False
        if base and base["step"] not in self._applied_steps:
            self.tables.clear()
            self._applied_steps.clear()
            self._load_base(base)
            changed = True
        for m in incrs:
            if m["step"] not in self._applied_steps:
                self._apply_save(m)
                changed = True
        return changed

    # -- inference ---------------------------------------------------------
    def _prepare(self, batch):
        dense = None
        if self.numeric_columns:
            dense = torch.from_numpy(
                pack_dense(self.numeric_columns, batch)).to(self.device)
        cats = {name: coll.pack_ids(batch, self.device)
                for name, coll in self.collections.items()}
        return dense, cats

    def _rows(self, name, coll, cats, batch):
        """``(aux, unique rows)`` of one collection for a request."""
        return _readonly_lookup(coll, self.tables[name], cats[name])

    def predict(self, batch) -> np.ndarray:
        """[B] click probabilities for a raw feature batch
        (column name -> numpy array)."""
        dense, cats = self._prepare(batch)
        with torch.inference_mode():
            if dense is not None:
                dense = normalize_dense(self.numeric_columns, dense)
            outputs = {}
            for name, coll in self.collections.items():
                aux, urows = self._rows(name, coll, cats, batch)
                outputs[name] = coll.embeddings_readonly(urows, aux)
            out = self.forward(self.model, dense, outputs, False)
            logits = out[0] if isinstance(out, tuple) else out
            return torch.sigmoid(logits).cpu().numpy()


class TieredPredictor(Predictor):
    """Serving for tables larger than the device's row budget: only the
    hottest ``device_row_budget`` rows of each table live in its device
    table; the cold tail stays in a host ``HostKV`` and is read per
    request. Keys in neither store read their init row, as in
    :class:`Predictor`. :meth:`refresh` updates device-resident keys in
    place and upserts every other row into the host store (no promotion
    at refresh: the hot set is ranked again at the next full load).
    """

    def __init__(self, model: torch.nn.Module,
                 numeric_columns: Sequence[NumericColumn],
                 collections: Dict[str, EmbeddingCollection], ckpt_dir: str,
                 device_row_budget: int, *, device="cuda", forward=None):
        self.device_row_budget = int(device_row_budget)
        self.host_store: Dict[str, HostKV] = {}
        self._device_keys: Dict[str, np.ndarray] = {}  # sorted int64
        super().__init__(model, numeric_columns, collections, ckpt_dir,
                         device=device, forward=forward)

    # -- loading ----------------------------------------------------------
    @staticmethod
    def _merge_by_key(parts):
        """Concatenate row dicts; on duplicate keys the LAST occurrence
        wins (parts are ordered oldest-first, and within one save tier
        rows precede device rows)."""
        keys = np.concatenate([p["keys"] for p in parts])
        vals = np.concatenate([_np_rows(p["values"]) for p in parts])
        freqs = np.concatenate([p["freqs"] for p in parts])
        vers = np.concatenate([p["versions"] for p in parts])
        sel = last_wins_sel(keys)
        return keys[sel], vals[sel], freqs[sel], vers[sel]

    def _split_hot(self, keys, freqs, vers):
        """Hot set = top rows by (freq, version) under the budget."""
        n = len(keys)
        b = self.device_row_budget
        if n <= b:
            return np.ones(n, bool)
        rank = np.lexsort((vers, freqs))  # ascending coldness last
        hot = np.zeros(n, bool)
        hot[rank[n - b:]] = True
        return hot

    def _parts(self, coll, manifest, name, adopt=False):
        """A save's tier rows (if any) and device rows, in merge order."""
        arrays = F.read_table(manifest["path"], name)
        if adopt:
            _adopt_row_layout(coll, arrays)
        tier = self._tier_arrays(coll, manifest, name)
        return ([tier] if tier else []) + [arrays]

    def _device_rows(self, st, coll, keys, vals, freqs, vers):
        return _scatter_table(st, coll.config, {
            "keys": keys, "values": vals, "freqs": freqs, "versions": vers,
            "create_steps": vers})

    def _load_base(self, manifest):
        for name, coll in self.collections.items():
            parts = self._parts(coll, manifest, name, adopt=True)
            keys, vals, freqs, vers = self._merge_by_key(parts)
            hot = self._split_hot(keys, freqs, vers)
            cap = needed_capacity(int(hot.sum()) + 8,
                                  min(coll.config.capacity, 256))
            if cap != coll.config.capacity:
                coll.config = dataclasses.replace(coll.config, capacity=cap)
            self.tables[name] = self._device_rows(
                ev.create(coll.config, self.device), coll, keys[hot],
                vals[hot], freqs[hot], vers[hot])
            self._device_keys[name] = np.sort(keys[hot])
            kv = HostKV(vals.shape[1])
            if (~hot).any():
                kv.upsert(keys[~hot], vals[~hot].astype(np.float32))
            self.host_store[name] = kv
        self._load_dense(manifest)
        self._applied_steps.add(manifest["step"])

    def _on_device(self, name, keys):
        dk = self._device_keys[name]
        pos = np.searchsorted(dk, keys)
        pos_safe = np.minimum(pos, max(len(dk) - 1, 0))
        return (len(dk) > 0) & (pos < len(dk)) & (dk[pos_safe] == keys)

    def _apply_save(self, manifest):
        if manifest["step"] in self._applied_steps:
            return
        for name, coll in self.collections.items():
            parts = self._parts(coll, manifest, name)
            keys, vals, freqs, vers = self._merge_by_key(parts)
            on_dev = self._on_device(name, keys)
            if on_dev.any():
                self.tables[name] = self._device_rows(
                    self.tables[name], coll, keys[on_dev], vals[on_dev],
                    freqs[on_dev], vers[on_dev])
            if (~on_dev).any():
                self.host_store[name].upsert(
                    keys[~on_dev], vals[~on_dev].astype(np.float32))
        self._load_dense(manifest)
        self._applied_steps.add(manifest["step"])

    # -- inference --------------------------------------------------------
    def _rows(self, name, coll, cats, batch):
        """The device table's unique rows, with the host store's rows in
        place of those of the keys the device table lacks."""
        aux, urows = super()._rows(name, coll, cats, batch)
        uniq = np.unique(coll.pack_ids_np(batch))
        need = uniq[(uniq != -1) & ~self._on_device(name, uniq)]
        if not need.size:
            return aux, urows
        rows, found = self.host_store[name].lookup(need)
        if not found.any():
            return aux, urows
        skeys = torch.from_numpy(need[found]).to(urows.device)  # ascending
        srows = torch.from_numpy(
            rows[found, :coll.config.embedding_dim]).to(urows)
        ukeys = aux.ev_aux.uniq.ukeys
        pos = torch.searchsorted(skeys, ukeys).clamp_(max=skeys.shape[0] - 1)
        hit = skeys[pos] == ukeys
        return aux, torch.where(hit[:, None], srows[pos], urows)

    def host_rows(self, name: str) -> int:
        kv = self.host_store.get(name)
        return len(kv) if kv else 0


class ShardedPredictor(Predictor):
    """Serving for tables larger than one card: the checkpoint is restored
    row-sharded over the ranks of ``mesh`` (a ``parallel.multihost.Axis``;
    the default group when None) and each request runs the read-only
    all-to-all exchange, the serving counterpart of training's.

    Every rank constructs it, and calls :meth:`predict` and
    :meth:`refresh`, together. ``predict(batch)`` takes the same full
    batch on every rank, pads it to a multiple of the rank count, serves
    this rank's slice and returns the ``[B]`` probabilities of the whole
    batch (an ``all_gather``). A request whose ids overflow an owner's
    bucket widens ``bucket_slack`` on every rank and is served again.
    """

    def __init__(self, model: torch.nn.Module,
                 numeric_columns: Sequence[NumericColumn],
                 collections: Dict[str, EmbeddingCollection], ckpt_dir: str,
                 mesh=None, *, device=None, forward=None,
                 bucket_slack: float = 2.0):
        from ..parallel.multihost import make_mesh
        self.mesh = self.axis = mesh or make_mesh()
        self.S, self.rank = self.axis.size, self.axis.rank
        self.bucket_slack = bucket_slack
        for name, coll in collections.items():
            if type(getattr(coll, "device_view", lambda: coll)()) \
                    is not EmbeddingCollection:
                raise ValueError(
                    f"table {name!r}: ShardedPredictor serves EV tables, as "
                    "the JAX package's does; serve a variant table "
                    f"({type(coll).__name__}) with the one-device "
                    "Predictor")
        super().__init__(model, numeric_columns, collections, ckpt_dir,
                         device=device or self.axis.device, forward=forward)

    # -- loading: every rank keeps its own shard ----------------------------
    def _restore_plan(self):
        """Rank 0's listing of the directory, on every rank. A save that
        lands while the ranks list it could reach some ranks and not
        others; loading and replaying run collectives, so every rank
        applies exactly the saves rank 0 saw (their manifests carry the
        paths to read)."""
        from ..parallel.multihost import broadcast_object
        return broadcast_object(
            F.restore_plan(self.ckpt_dir) if self.rank == 0 else None,
            self.axis)

    def _my_rows(self, arrays):
        return None if arrays is None else \
            route_to_shards(arrays, self.S)[self.rank]

    def _load_base(self, manifest):
        for name, coll in self.collections.items():
            arrays = F.read_table(manifest["path"], name)
            _adopt_row_layout(coll, arrays)
            tier = self._tier_arrays(coll, manifest, name)
            n_rows = arrays["keys"].shape[0] + \
                (tier["keys"].shape[0] if tier else 0)
            cap = needed_capacity(int(np.ceil(n_rows / self.S)) + 8,
                                  coll.config.capacity)
            if cap != coll.config.capacity:
                coll.config = dataclasses.replace(coll.config, capacity=cap)
            st = ev.create(coll.config, self.device)
            if tier is not None:  # tier first, device second (Predictor)
                st = _scatter_table(st, coll.config, self._my_rows(tier))
            self.tables[name] = _scatter_table(st, coll.config,
                                               self._my_rows(arrays))
        self._load_dense(manifest)
        self._applied_steps.add(manifest["step"])

    def _apply_save(self, manifest):
        from ..parallel.multihost import all_max
        if manifest["step"] in self._applied_steps:
            return
        for name, coll in self.collections.items():
            arrays = F.read_table(manifest["path"], name)
            tier = self._tier_arrays(coll, manifest, name)
            st = self.tables[name]
            # the fullest shard sizes every shard: one capacity on all ranks
            size = all_max(int(st.index.size.sum()), self.axis)
            n_new = arrays["keys"].shape[0] + \
                (tier["keys"].shape[0] if tier else 0)
            cap = needed_capacity(size + n_new, coll.config.capacity)
            if cap != coll.config.capacity:
                st, _ = ev.grow(st, coll.config, cap)
                coll.config = dataclasses.replace(coll.config, capacity=cap)
            if tier is not None:
                st = _scatter_table(st, coll.config, self._my_rows(tier))
            self.tables[name] = _scatter_table(st, coll.config,
                                               self._my_rows(arrays))
        self._load_dense(manifest)
        self._applied_steps.add(manifest["step"])

    # -- inference -----------------------------------------------------------
    def _bucket_cap(self, n_flat: int) -> int:
        """The JAX ShardedPredictor's bucket width: ``slack * n / S`` (at
        least 8), rounded up to a power of two."""
        cap = max(int(self.bucket_slack * n_flat) // max(self.S, 1), 8)
        return 1 << (cap - 1).bit_length()

    def predict(self, batch) -> np.ndarray:
        """``[B]`` click probabilities of the whole ``batch`` (the same on
        every rank)."""
        from ..parallel import sharded
        first = next(iter(batch.values()))
        B = np.asarray(first).shape[0]
        b = -(-B // self.S)  # the batch padded to S * b examples
        sl = slice(self.rank * b, (self.rank + 1) * b)

        def pad(x, fill, axis=0):
            width = [(0, 0)] * x.ndim
            width[axis] = (0, b * self.S - B)
            return np.pad(x, width, constant_values=fill)
        dense = None
        if self.numeric_columns:
            dense = torch.from_numpy(np.ascontiguousarray(
                pad(pack_dense(self.numeric_columns, batch), 0)[sl]))
            dense = dense.to(self.device)
        ids = {name: torch.from_numpy(np.ascontiguousarray(
                   pad(coll.pack_ids_np(batch), -1, 1)[:, sl])).to(
                       self.device)
               for name, coll in self.collections.items()}
        with torch.inference_mode():
            if dense is not None:
                dense = normalize_dense(self.numeric_columns, dense)
            outputs, dropped = {}, 0
            for name, coll in self.collections.items():
                flat = ids[name].reshape(-1)
                row_u, inv, valid = sharded.exchange_lookup_readonly(
                    coll, self.tables[name], flat, self.axis,
                    self._bucket_cap(flat.shape[0]))
                # unrouted real ids were dropped by a full owner bucket
                dropped = dropped + (~valid & ~K.is_empty(flat)).sum()
                outputs[name] = (
                    coll.embeddings_from_rows(row_u, inv, valid),
                    coll.sequence_embeddings_from_rows(row_u, inv, valid))
            out = self.forward(self.model, dense, outputs, False)
            logits = out[0] if isinstance(out, tuple) else out
            probs = self.axis.all_gather(torch.sigmoid(logits))
            dropped = int(self.axis.psum(torch.as_tensor(
                dropped, device=self.device).reshape(1)).item())
        if dropped > 0:
            import warnings
            self.bucket_slack *= 2.0
            warnings.warn(
                f"ShardedPredictor: {dropped} ids overflowed owner buckets; "
                f"bucket_slack raised to {self.bucket_slack} and the request "
                "served again")
            return self.predict(batch)
        return probs[:B].cpu().numpy()


def _np_rows(values) -> np.ndarray:
    """Saved rows as float32 numpy (``checkpoint.format`` reads a bfloat16
    table back as a tensor)."""
    if isinstance(values, torch.Tensor):
        return values.float().numpy()
    return np.asarray(values, np.float32)
