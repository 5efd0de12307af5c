"""Multi-device training: a data-parallel dense stack over row-sharded
tables.

Port of ``deeprec_tpu/parallel/trainer.py``: :func:`make_mesh` (from
``multihost``) and :class:`ShardedTrainer`, the mesh counterpart of
``train.trainer.Trainer`` with the same surface. One process per rank on
``torch.distributed`` replaces the JAX engine's ``shard_map``:

* every rank is handed the same global batch and keeps the examples
  ``[rank*B/S, (rank+1)*B/S)`` (the JAX ``P(axis)`` split);
* every table is row-sharded by key hash; a step's lookups and updates
  ride the owner exchange of ``parallel/sharded.py`` (two or three
  ``all_to_all``s forward, one backward);
* the model's parameters start equal on every rank (broadcast from rank
  0), their gradients and the models' running statistics are averaged
  over the ranks (``pmean``) and every rank steps the same dense
  optimizer (synchronous data parallelism); the metrics add every rank's
  delta (``psum``);
* the owner applies each sparse gradient scaled by ``1/S``, so the update
  follows the mean loss over the global batch.

Decisions that must agree across ranks are global: ``maybe_grow`` grows
every shard of a table when its fullest shard passes the load threshold or
any shard overflowed, and ``table_health`` (which the CLI's watchdog reads
before it widens the buckets or the dedup cap) sums or maxes every rank's
counters. Every rank must call every public method, in the same order.

The device-index ``EmbeddingCollection``, the variant collections
(``feature_column_variants``) and the host-sharded
``parallel.host_sharded.HostShardedCollection`` run here; tiered tables
run under ``parallel.tiered.TieredShardedTrainer``. A host-sharded
collection resolves its whole exchange on the host: :meth:`pack_np` cuts
this rank's slice (numpy only), :meth:`resolve_packed` resolves it in step
order (the host bucket exchange included) at the bucket width the trainer
gives it, as the JAX trainer's ``prepare_batch`` passes it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..config import StorageType
from ..feature_column import (EmbeddingCollection, NumericColumn,
                              normalize_dense, pack_dense)
from ..optim.sparse import SparseOptimizer
from ..train import metrics as metrics_lib
from ..train.pipeline import to_device
from ..train.trainer import (Trainer, TrainState, _mb_split, bce_loss,
                             default_forward)
from .multihost import Axis, all_max, make_mesh, psum_all


class ShardedTrainer:
    """``Trainer``'s API over the ranks of ``mesh`` (an
    :class:`~.multihost.Axis`; the default group when None), on
    ``mesh.device``."""

    _PARAMS_INIT_CAP = 4096  # throwaway-table capacity of the params init
    _tiers_ok = False        # TieredShardedTrainer takes tiered tables

    def __init__(self, model: torch.nn.Module,
                 numeric_columns: Sequence[NumericColumn],
                 collections: Dict[str, EmbeddingCollection],
                 sparse_optimizers: Dict[str, SparseOptimizer],
                 dense_optimizer, mesh: Optional[Axis] = None,
                 forward: Optional[Callable] = None,
                 bucket_slack: float = 2.0, aux_loss_weight: float = 1.0,
                 microbatches: int = 1):
        self.mesh = self.axis = mesh or make_mesh()
        self.S, self.rank = self.axis.size, self.axis.rank
        self.device = self.axis.device
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ShardedTrainer on cuda but torch sees no "
                               "CUDA device")
        for name, coll in collections.items():
            if hasattr(coll, "pack_ids_host") and \
                    not hasattr(coll, "sharded_resolve"):
                raise ValueError(
                    f"table {name!r}: a one-card host-index collection on a "
                    "mesh; use parallel.host_sharded.HostShardedCollection")
            if coll.config.storage.storage_type is not StorageType.HBM \
                    and not self._tiers_ok:
                raise ValueError(
                    f"table {name!r}: tiered storage on the mesh runs under "
                    "parallel.tiered.TieredShardedTrainer")
        self.model = model.to(self.device)
        self.numeric_columns = list(numeric_columns)
        self.collections = collections
        self.sparse_optimizers = sparse_optimizers
        self.dense_optimizer = dense_optimizer
        self.forward = forward or default_forward
        self.bucket_slack = bucket_slack
        self.aux_loss_weight = aux_loss_weight
        if microbatches > 1 and any(hasattr(c, "sharded_resolve")
                                    for c in collections.values()):
            raise ValueError(
                "microbatches > 1 on a host-sharded table: its resolved "
                "wire cannot be split (the JAX CLI takes the device-index "
                "engine here)")
        self.microbatches = microbatches
        for coll in collections.values():
            if hasattr(coll, "bind_mesh"):  # the host-sharded engine forms
                coll.bind_mesh(self.axis)

    def rejit(self) -> None:
        """Nothing to rebuild: an eager step reads new shapes itself."""

    # -- init ------------------------------------------------------------
    def init(self, sample_batch) -> TrainState:
        """The model's parameters and buffers come from rank 0 (a one-device
        ``Trainer.init`` over throwaway tables of at most
        ``_PARAMS_INIT_CAP`` rows checks that the model takes the
        collections' outputs), the dense optimizer's state from them, and
        each rank creates its own full-capacity shard of every table."""
        saved = {n: c.config for n, c in self.collections.items()}
        try:
            for c in self.collections.values():
                if c.config.capacity > self._PARAMS_INIT_CAP:
                    c.config = dataclasses.replace(
                        c.config, capacity=self._PARAMS_INIT_CAP)
            Trainer(self.model, self.numeric_columns, self.collections,
                    self.sparse_optimizers, self.dense_optimizer,
                    forward=self.forward,
                    aux_loss_weight=self.aux_loss_weight,
                    device=self.device).init(sample_batch)
        finally:
            for n, c in self.collections.items():
                c.config = saved[n]
        self.axis.broadcast_(list(self.model.parameters())
                             + list(self.model.buffers()))
        params = list(self.model.parameters())
        tables = {name: coll.sharded_init_local(self.sparse_optimizers[name],
                                                self.device)
                  for name, coll in self.collections.items()}
        return TrainState(opt_state=self.dense_optimizer.init(params),
                          tables=tables,
                          metrics=metrics_lib.create(device=self.device),
                          step=0)

    # -- batch plumbing ----------------------------------------------------
    def _local_slice(self, batch) -> slice:
        if "label" in batch:
            n = len(np.asarray(batch["label"]).reshape(-1))
        else:
            first = next(iter(self.collections.values())).columns[0]
            n = np.asarray(batch[first.categorical.name]).shape[0]
        if n % self.S:
            raise ValueError(f"a global batch of {n} does not split over "
                             f"{self.S} ranks")
        b = n // self.S
        return slice(self.rank * b, (self.rank + 1) * b)

    def pack_np(self, batch: Dict[str, np.ndarray]):
        """This rank's slice of the global ``batch`` as numpy, safe in any
        thread (no resolve): dense ``[B/S, D]``, each collection's
        ``[W, B/S]`` ids, labels."""
        sl = self._local_slice(batch)
        dense = (pack_dense(self.numeric_columns, batch)[sl]
                 if self.numeric_columns else None)
        ids = {name: coll.sharded_pack(batch, self.S, self.rank)
               for name, coll in self.collections.items()}
        labels = (np.asarray(batch["label"], np.float32)[sl]
                  if "label" in batch else None)
        return dense, ids, labels

    def resolve_packed(self, packed, train: bool = True, pin: bool = False):
        """:meth:`pack_np`'s output as host tensors (page-locked when
        ``pin``). A host-sharded collection resolves its exchange here at
        the trainer's bucket width: every rank in step order."""
        def host(x):
            if x is None:
                return None
            t = torch.from_numpy(np.ascontiguousarray(x))
            return t.pin_memory() if pin else t
        dense, ids, labels = packed
        cats = {}
        for name, coll in self.collections.items():
            if hasattr(coll, "sharded_resolve"):
                cats[name] = coll.sharded_resolve(
                    ids[name], self._bucket_cap(coll, ids[name].size),
                    train=train, pin=pin)
            else:
                cats[name] = host(ids[name])
        return host(dense), cats, host(labels)

    def prepare_host(self, batch: Dict[str, np.ndarray], train: bool = True,
                     pin: bool = False):
        """This rank's slice of the global ``batch`` as host tensors:
        :meth:`pack_np`, then :meth:`resolve_packed`."""
        return self.resolve_packed(self.pack_np(batch), train, pin)

    def prepare_batch(self, batch: Dict[str, np.ndarray], train: bool = True):
        return to_device(self.prepare_host(batch, train), self.device)

    def _bucket_cap(self, coll, n_flat_local: int) -> int:
        """Per-destination bucket width, from the dedup width (the uniques
        a rank can send): ``slack * U / S`` rounded up to a multiple of 8,
        at least 8."""
        u = n_flat_local
        if coll.config.max_unique is not None:
            u = min(u, coll.config.max_unique + 1)
        c = int(np.ceil(u * self.bucket_slack / self.S / 8.0) * 8)
        return max(c, 8)

    def _cap_of(self, coll, cats) -> int:
        """The bucket width of one collection's step inputs: a resolved
        wire carries its own."""
        cap = getattr(cats, "bucket_cap", None)
        return cap if cap is not None else self._bucket_cap(coll,
                                                            cats.numel())

    # -- the step ------------------------------------------------------------
    def _sparse_forward(self, tables, cats, step):
        auxs, caps = {}, {}
        for name, coll in self.collections.items():
            ids2d = cats[name]
            caps[name] = self._cap_of(coll, ids2d)
            b = tables[name]
            ev_state, auxs[name] = coll.sharded_lookup_or_create(
                b.ev, ids2d, step, self.axis, caps[name])
            tables[name] = b._replace(
                ev=ev_state, health=coll.sharded_health(b.health, auxs[name]))
        return tables, auxs, caps

    def _microstep(self, tables, dense, cats, labels, step):
        """One (micro)batch through the exchange: lookup, forward, backward
        (the reverse row exchange runs inside it) and the owner-side sparse
        apply. The parameters' local gradients are left in ``.grad``."""
        tables, auxs, caps = self._sparse_forward(tables, cats, step)
        with torch.no_grad():
            urows = {name: coll.sharded_rows(tables[name].ev, auxs[name])
                     for name, coll in self.collections.items()}
        outputs = {}
        for name, coll in self.collections.items():
            urows[name].requires_grad_(True)
            row_u, inv, valid = coll.sharded_rows_back(
                urows[name], auxs[name], self.axis, caps[name])
            outputs[name] = (coll.embeddings_from_rows(row_u, inv, valid),
                             coll.sequence_embeddings_from_rows(row_u, inv,
                                                                valid))
        self.model.zero_grad(set_to_none=True)
        out = self.forward(self.model, dense, outputs, True)
        logits, aux_loss = out if isinstance(out, tuple) else (out, 0.0)
        loss = bce_loss(logits, labels) + self.aux_loss_weight * aux_loss
        loss.backward()
        # the owner applies the cotangent of the global batch mean
        inv_s = 1.0 / self.S
        for name, coll in self.collections.items():
            b = tables[name]
            g = urows[name].grad
            if g is None:
                g = torch.zeros_like(urows[name])
            ev_state, slot = coll.sharded_apply_gradients(
                b.ev, self.sparse_optimizers[name], b.slot, auxs[name],
                g * inv_s, step, self.axis, self.S)
            tables[name] = b._replace(ev=ev_state, slot=slot)
        return tables, loss.detach(), logits.detach()

    def _microbatched(self, tables, params, dense, cats, labels, step):
        """``Trainer._microbatched`` over the exchange: each slice starts
        from the step's buffers and applies its own sparse update; the
        parameters' gradients are averaged over the slices."""
        k = self.microbatches
        buffers = [(b, b.clone()) for b in self.model.buffers()]
        grads = [None] * len(params)
        losses, logits = [], []
        mb_cats = {n: c.chunk(k, -1) for n, c in cats.items()}
        for i, (d, l) in enumerate(zip(_mb_split(dense, k),
                                       _mb_split(labels, k))):
            with torch.no_grad():
                for b, saved in buffers:
                    b.copy_(saved)
            tables, loss, lg = self._microstep(
                tables, d, {n: c[i].contiguous() for n, c in mb_cats.items()},
                l, step)
            for j, p in enumerate(params):
                if p.grad is not None:
                    grads[j] = p.grad if grads[j] is None \
                        else grads[j] + p.grad
            losses.append(loss)
            logits.append(lg)
        for p, g in zip(params, grads):
            p.grad = None if g is None else g / k
        return tables, torch.stack(losses).mean(), torch.cat(logits)

    def _train_step(self, state: TrainState, dense, cats, labels
                    ) -> TrainState:
        step = state.step
        if dense is not None:
            dense = normalize_dense(self.numeric_columns, dense)
        params = list(self.model.parameters())
        if self.microbatches == 1:
            tables, loss, logits = self._microstep(dict(state.tables), dense,
                                                   cats, labels, step)
        else:
            tables, loss, logits = self._microbatched(
                dict(state.tables), params, dense, cats, labels, step)
        # synchronous data parallelism: one pmean of every gradient
        grads = psum_all([p.grad if p.grad is not None
                          else torch.zeros_like(p) for p in params],
                         self.axis)
        for p, g in zip(params, grads):
            p.grad = g / self.S
        self.dense_optimizer.step(params, state.opt_state)
        # running statistics came from each rank's slice: average them so
        # every rank (and a save) holds the same ones
        stats = [b for b in self.model.buffers() if b.is_floating_point()]
        if stats:
            with torch.no_grad():
                for b, m in zip(stats, psum_all(stats, self.axis)):
                    b.copy_(m / self.S)
        return TrainState(opt_state=state.opt_state, tables=tables,
                          metrics=self._add_metrics(state.metrics, logits,
                                                    labels, loss),
                          step=step + 1)

    def _add_metrics(self, mstate, logits, labels, loss):
        """``mstate`` plus every rank's delta of this batch (one psum)."""
        delta = metrics_lib.update(
            metrics_lib.create(mstate.pos_hist.shape[0], self.device),
            logits, labels.reshape(logits.shape), loss)
        delta = psum_all(list(delta), self.axis)
        return metrics_lib.MetricState(*[a + d for a, d
                                         in zip(mstate, delta)])

    @torch.no_grad()
    def _eval_logits(self, state: TrainState, dense, cats):
        """This rank's logits through the read-only exchange: unknown keys
        read their init row, nothing is written."""
        if dense is not None:
            dense = normalize_dense(self.numeric_columns, dense)
        outputs = {}
        for name, coll in self.collections.items():
            ids2d = cats[name]
            row_u, inv, valid = coll.sharded_readonly(
                state.tables[name].ev, ids2d, self.axis,
                self._cap_of(coll, ids2d))
            outputs[name] = (coll.embeddings_from_rows(row_u, inv, valid),
                             coll.sequence_embeddings_from_rows(row_u, inv,
                                                                valid))
        out = self.forward(self.model, dense, outputs, False)
        return out[0] if isinstance(out, tuple) else out

    def _eval_step(self, state: TrainState, mstate, dense, cats, labels):
        logits = self._eval_logits(state, dense, cats)
        return self._add_metrics(mstate, logits, labels,
                                 bce_loss(logits, labels))

    # -- public API --------------------------------------------------------
    def train_step(self, state: TrainState, batch) -> TrainState:
        return self._train_step(state, *self.prepare_batch(batch))

    def eval_step(self, state: TrainState, mstate, batch):
        return self._eval_step(state, mstate,
                               *self.prepare_batch(batch, train=False))

    def predict(self, state: TrainState, batch) -> np.ndarray:
        """The global ``batch``'s ``[B]`` probabilities on every rank: each
        serves its slice, then one ``all_gather``."""
        dense, cats, _ = self.prepare_batch(batch, train=False)
        probs = torch.sigmoid(self._eval_logits(state, dense, cats))
        return self.axis.all_gather(probs.reshape(-1)).cpu().numpy()

    def reset_metrics(self, state: TrainState) -> TrainState:
        return state._replace(metrics=metrics_lib.create(device=self.device))

    # -- fence work: collectives, every rank calls them together -------------
    def _global_counters(self, coll, bundle):
        """``(sizes summed, overflow summed, drops summed, largest shard,
        saturated steps max, unique high-water max)`` over the ranks."""
        ix = coll.index_view(bundle.ev).index
        h = (bundle.health.long() if bundle.health is not None else
             torch.zeros((3,), dtype=torch.long, device=self.device))
        summed = self.axis.psum(torch.stack(
            [ix.size.sum().long(), ix.overflow.sum().long(), h[0]]))
        maxed = self.axis.pmax(torch.stack([ix.size.sum().long(), h[1],
                                            h[2]]))
        return summed.tolist() + maxed.tolist()

    def table_health(self, state: TrainState) -> Dict[str, dict]:
        """The JAX package's health schema over every shard: total size,
        the fullest shard's load, overflow and exchange drops summed, the
        saturated steps and unique high-water mark of the worst rank."""
        out = {}
        for name, coll in self.collections.items():
            if hasattr(coll, "sharded_host_health"):
                out[name] = coll.sharded_host_health(self.axis)
                continue
            if coll.index_view(state.tables[name].ev) is None:
                continue  # no dynamic index (multi-hash)
            size, over, drops, top, sat, nu = self._global_counters(
                coll, state.tables[name])
            cap = coll.config.capacity
            out[name] = {
                "size": int(size), "capacity": cap, "shards": self.S,
                "load_factor": top / cap, "overflow": int(over),
                "dropped": int(drops), "unique_saturated_steps": int(sat),
                "max_n_unique": int(nu),
                "max_unique": coll.config.max_unique,
            }
        return out

    def maybe_grow(self, state: TrainState, threshold: float = 0.7
                   ) -> TrainState:
        """Double every table whose fullest shard passed ``threshold`` load
        or that overflowed on any shard: every rank rebuilds its shard at
        the same new capacity, optimizer slot rows carried along."""
        tables = dict(state.tables)
        changed = False
        for name, coll in self.collections.items():
            cfg = coll.config
            if hasattr(coll, "sharded_needs_growth"):
                # host resolvers: near full (0.9) on any rank, or keys
                # waiting for a row
                if not all_max(int(coll.sharded_needs_growth()), self.axis):
                    continue
            elif coll.index_view(tables[name].ev) is None:
                continue  # no index: nothing grows
            else:
                _, over, _, top, _, _ = self._global_counters(coll,
                                                              tables[name])
                if top / cfg.capacity < threshold and over == 0:
                    continue
            new_cap = cfg.capacity * 2
            tables[name] = coll.sharded_grow_local(
                tables[name], new_cap, self.sparse_optimizers[name].fills)
            coll.config = dataclasses.replace(cfg, capacity=new_cap)
            if hasattr(coll, "note_grown"):
                coll.note_grown()
            changed = True
        return state._replace(tables=tables) if changed else state

    def raise_bucket_slack(self, factor: float = 1.5) -> float:
        """Widen the exchange buckets after observed drops; returns the new
        slack. Call it on every rank (the CLI does, from the global
        :meth:`table_health`)."""
        self.bucket_slack *= factor
        return self.bucket_slack
