"""Training core: one step over dynamic tables and the dense model.

Port of ``deeprec_tpu/train/trainer.py``: ``TableBundle`` (with the
health counters of a device-index table), ``TrainState``, ``bce_loss``,
``_bump_health``, ``_mb_split``, the :class:`Trainer` over either engine
(device-index ``EmbeddingCollection``s and host-index ones; with
``microbatches``, the fence work ``maybe_grow``, ``maybe_demote``,
``table_health``, ``reset_metrics`` and a no-op ``rejit``, and the tier
surface ``tiers``, ``export_tiers``, ``import_tier`` and
``host_tier_rows`` that the checkpoint saver drives), and the forward
conventions ``default_forward`` and ``_readonly_lookup`` that serving uses
too. ``prewarm_grow`` compiles XLA ahead of a growth; an eager step has
nothing to compile, so it has no counterpart. ``prepare_batch`` is split
into a host half (``prepare_host``) and the copies (``pipeline.to_device``),
the two stages of ``train.pipeline.HostStepPipeline``.

A train step, as in the JAX package: the promotion of tier rows that rode
the resolve wire (tiered host-index tables), sparse lookup-or-create (no
gradient) -> the unique rows become the differentiable leaf -> pooling and
sequence expansion, model (its ``Dice`` running statistics move in the
forward) and BCE loss -> one ``backward()`` gives the unique rows'
gradient and the parameters' -> per-table sparse apply -> the dense
optimizer -> metrics. PyTorch runs it eagerly; tables, optimizer state
and parameters are updated in place (the JAX package donates them to a
jitted step).
The model's parameters live in the module, so :class:`TrainState` holds
no params.

With ``microbatches=k`` (the JAX package's ``lax.scan`` over AutoMicroBatch
slices) the batch splits into ``k`` contiguous slices. Each runs the
sparse lookup, the forward and backward and its own sparse apply, all at
the same step; the parameters' gradients and the loss are averaged over
the ``k`` and the dense optimizer steps once. Every slice starts from the
model's buffers as they were before the step (the JAX package applies
``state.params`` to each) and the last slice's buffer update is kept.
Host-index wires cannot be split: that engine takes ``microbatches=1``
(the JAX package crashes there, ROADMAP C6).
"""
from __future__ import annotations

from typing import (Any, Callable, Dict, NamedTuple, Optional, Sequence,
                    Union)

import numpy as np
import torch
import torch.nn.functional as F

from ..feature_column import (EmbeddingCollection, NumericColumn,
                              normalize_dense, pack_dense)
from ..optim.dense import SGD, Adagrad, Adam
from ..optim.sparse import SparseOptimizer
from ..sparse import embedding_var as ev
from ..utils import spans
from . import metrics as metrics_lib
from .pipeline import to_device


class TableBundle(NamedTuple):
    ev: Any     # the collection's state (EVState, host_index.HostEVState)
    slot: Any   # the sparse optimizer's slot state
    # int32 [3] health counters of an EVState table (None for others):
    # [0] exchange-bucket drops (multi-device runs; 0 here), [1] steps
    # whose dedup saturated max_unique, [2] high-water unique demand
    health: Any = None


class TrainState(NamedTuple):
    opt_state: Any                  # the dense optimizer's state
    tables: Dict[str, TableBundle]
    metrics: metrics_lib.MetricState
    step: int


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean sigmoid binary cross-entropy, written as
    ``optax.sigmoid_binary_cross_entropy`` writes it."""
    labels = labels.float()
    return torch.mean(-labels * F.logsigmoid(logits)
                      - (1.0 - labels) * F.logsigmoid(-logits))


def _bump_health(health, aux):
    """Accumulate ``TableBundle.health`` from one lookup's aux, on the
    device: saturation is a step whose dedup overflowed ``max_unique``
    (distinct valid keys routed to the null group), demand ``n_unique +
    n_overflow``."""
    if health is None:
        return None
    uniq = aux.ev_aux.uniq
    nu = (uniq.n_unique + uniq.n_overflow).to(torch.int32)
    return torch.stack([health[0],
                        health[1] + (uniq.n_overflow > 0).to(torch.int32),
                        torch.maximum(health[2], nu)])


def _count_lookup(aux) -> None:
    """The recorder's counters of one lookup: its key lanes (a shape) and
    its dedup's ``n_unique`` and ``n_overflow`` (0-dim tensors the step
    already holds; summed when the recorder stops)."""
    uniq = getattr(getattr(aux, "ev_aux", None), "uniq", None)
    if uniq is None:
        return
    spans.count("lookup.lanes", uniq.inverse.numel())
    spans.count("lookup.unique", uniq.n_unique)
    spans.count("lookup.overflow", uniq.n_overflow)


def _mb_split(x: Optional[torch.Tensor], k: int):
    """``k`` contiguous slices of ``x``'s batch axis (None stays None)."""
    return [None] * k if x is None else list(x.chunk(k))


class Trainer:
    """Bundles model, feature columns and optimizers into train and eval
    steps on ``device`` (the card by default).

    ``forward(model, dense, outputs, train)`` consumes
    ``outputs[collection_name] = (emb_dict, seq_dict)`` and returns logits
    or ``(logits, aux_loss)`` (``models.sequence.dien_forward``; the loss
    adds ``aux_loss_weight * aux_loss``): ``default_forward`` routes
    collection ``"emb"`` to the model's ``emb`` and its sequences to
    ``seq=``, ``"wide"`` to its ``wide=``, and passes ``dense=None`` when
    there are no numeric columns (DSSM, DIN, DIEN). Each
    collection has its own sparse optimizer (WDL and DeepFM: Adagrad on
    ``"emb"``, FTRL on ``"wide"``). ``dense_optimizer`` is an
    ``optim.dense.SGD``, ``Adagrad`` or ``Adam`` (the counterparts of
    ``optax.sgd``, with or without momentum, ``optax.adagrad`` and
    ``optax.adam``). ``microbatches``: see the module docstring.
    """

    def __init__(self, model: torch.nn.Module,
                 numeric_columns: Sequence[NumericColumn],
                 collections: Dict[str, EmbeddingCollection],
                 sparse_optimizers: Dict[str, SparseOptimizer],
                 dense_optimizer: Union[SGD, Adagrad, Adam],
                 forward: Optional[Callable] = None,
                 aux_loss_weight: float = 1.0, microbatches: int = 1,
                 device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer(device='cuda') but torch sees no "
                               "CUDA device")
        self.model = model.to(self.device)
        self.numeric_columns = list(numeric_columns)
        self.collections = collections
        self.sparse_optimizers = sparse_optimizers
        self.dense_optimizer = dense_optimizer
        self.forward = forward or default_forward
        self.aux_loss_weight = aux_loss_weight
        if microbatches > 1 and any(hasattr(c, "pack_ids_host")
                                    for c in collections.values()):
            raise NotImplementedError(
                "microbatches > 1 on a host-index table: its resolved wire "
                "cannot be split (the JAX package crashes here, ROADMAP C6)")
        self.microbatches = microbatches

    # -- init ------------------------------------------------------------
    def init(self, sample_batch) -> TrainState:
        """Fresh tables, optimizer state and metrics. As in the JAX
        package, a throwaway lookup of ``sample_batch`` runs the model once
        (here it checks that the model takes the collections' outputs),
        then ``coll.init`` resets the tables and the host index. That
        forward runs in training mode, as ``model.init`` does, and leaves
        the model's buffers (``Dice``'s running statistics) as they were,
        as ``model.init`` leaves its ``batch_stats``."""
        dense, cats, _ = self.prepare_batch(sample_batch)
        if dense is not None:
            dense = normalize_dense(self.numeric_columns, dense)
        tables, outputs = {}, {}
        with torch.no_grad():
            for name, coll in self.collections.items():
                st = coll.init(self.device)
                st, aux = coll.lookup_or_create(st, cats[name], 0)
                urows = coll.rows_for_training(st, aux)
                outputs[name] = (coll.embeddings(urows, aux),
                                 coll.sequence_embeddings(urows, aux))
                slot = coll.init_slot(self.sparse_optimizers[name], st)
                health = (torch.zeros((3,), dtype=torch.int32,
                                      device=self.device)
                          if isinstance(st, ev.EVState) else None)
                tables[name] = TableBundle(ev=coll.init(self.device),
                                           slot=slot, health=health)
            buffers = [(b, b.clone()) for b in self.model.buffers()]
            self.forward(self.model, dense, outputs, True)
            for b, saved in buffers:
                b.copy_(saved)
        params = list(self.model.parameters())
        return TrainState(opt_state=self.dense_optimizer.init(params),
                          tables=tables,
                          metrics=metrics_lib.create(device=self.device),
                          step=0)

    # -- batch plumbing ----------------------------------------------------
    def pack_np(self, batch: Dict[str, np.ndarray]):
        """The numpy half of a step's inputs, safe in any thread: dense
        columns, each collection's flat ids and labels (the CLI's prefetch
        workers run it; no resolve)."""
        dense = (pack_dense(self.numeric_columns, batch)
                 if self.numeric_columns else None)
        ids = {name: coll.pack_ids_np(batch)
               for name, coll in self.collections.items()}
        labels = (np.asarray(batch["label"], np.float32)
                  if "label" in batch else None)
        return dense, ids, labels

    def resolve_packed(self, packed, train: bool = True, pin: bool = False):
        """:meth:`pack_np`'s output as a step's host inputs, touching no
        device: a host-index collection resolves its ids here (in step
        order for training; with ``train=False`` through its read-only
        resolve); CPU tensors, page-locked when ``pin``."""
        def host(x):
            if x is None:
                return None
            t = torch.from_numpy(x)
            return t.pin_memory() if pin else t
        dense, ids, labels = packed
        cats = {}
        for name, coll in self.collections.items():
            if not hasattr(coll, "pack_ids_host"):
                cats[name] = host(ids[name])
            elif train:
                cats[name] = coll.pack_ids_host(ids[name], pin=pin)
            else:
                cats[name] = coll.pack_ids_eval(ids[name], None)
        return host(dense), cats, host(labels)

    def prepare_host(self, batch: Dict[str, np.ndarray], train: bool = True,
                     pin: bool = False):
        """The host half of a step's inputs, touching no device
        (:meth:`pack_np`, then :meth:`resolve_packed`). The resolve stage
        of ``train.pipeline.HostStepPipeline`` runs it."""
        with spans.span("pack.np"):
            packed = self.pack_np(batch)
        with spans.span("pack.pin"):
            return self.resolve_packed(packed, train, pin)

    def prepare_batch(self, batch: Dict[str, np.ndarray], train: bool = True):
        """Host packing and the copies to the device, inline:
        :meth:`prepare_host`, then its tensors copied to the device."""
        return to_device(self.prepare_host(batch, train), self.device)

    # -- the step ----------------------------------------------------------
    def _sparse_forward(self, tables, cats, step):
        auxs = {}
        for name, coll in self.collections.items():
            b = tables[name]
            promo = getattr(coll, "apply_promo", None)
            if promo is not None:
                # tier rows found at resolve time go back into the stores
                # before the batch's metadata writes
                ev_state, slot = promo(b.ev, b.slot, cats[name])
                b = b._replace(ev=ev_state, slot=slot)
            ev_state, auxs[name] = coll.lookup_or_create(b.ev, cats[name],
                                                         step)
            if spans.recording():
                _count_lookup(auxs[name])
            tables[name] = b._replace(
                ev=ev_state, health=_bump_health(b.health, auxs[name]))
        return tables, auxs

    def _loss_and_grads(self, tables, auxs, dense, labels):
        """Loss, logits, the unique rows and their gradients; the
        parameters' gradients are left in their ``.grad``."""
        urows = {}
        with torch.no_grad():
            for name, coll in self.collections.items():
                urows[name] = coll.rows_for_training(tables[name].ev,
                                                     auxs[name])
        for r in urows.values():
            r.requires_grad_(True)
        outputs = {name: (coll.embeddings(urows[name], auxs[name]),
                          coll.sequence_embeddings(urows[name], auxs[name]))
                   for name, coll in self.collections.items()}
        self.model.zero_grad(set_to_none=True)
        out = self.forward(self.model, dense, outputs, True)
        if isinstance(out, tuple):
            logits, aux_loss = out
        else:
            logits, aux_loss = out, 0.0
        loss = bce_loss(logits, labels) + self.aux_loss_weight * aux_loss
        loss.backward()
        grads = {name: r.grad for name, r in urows.items()}
        urows = {name: r.detach() for name, r in urows.items()}
        return loss.detach(), logits.detach(), grads, urows

    def _apply_sparse(self, tables, auxs, urow_grads, step, urows):
        for name, coll in self.collections.items():
            b = tables[name]
            ev_state, slot = coll.apply_gradients(
                b.ev, self.sparse_optimizers[name], b.slot, auxs[name],
                urow_grads[name], step, urows=urows[name])
            tables[name] = b._replace(ev=ev_state, slot=slot)
        return tables

    def _train_step(self, state: TrainState, dense, cats, labels
                    ) -> TrainState:
        """One step, recorded as span ``step`` with the step number as its
        batch (``utils/spans.py``)."""
        step = state.step
        with spans.span("step", step):
            if dense is not None:
                dense = normalize_dense(self.numeric_columns, dense)
            params = list(self.model.parameters())
            if self.microbatches == 1:
                with spans.span("step.sparse_lookup"):
                    tables, auxs = self._sparse_forward(dict(state.tables),
                                                        cats, step)
                with spans.span("step.forward_backward"):
                    loss, logits, gu, urows = self._loss_and_grads(
                        tables, auxs, dense, labels)
                with spans.span("step.sparse_apply"):
                    tables = self._apply_sparse(tables, auxs, gu, step,
                                                urows)
            else:
                tables, loss, logits = self._microbatched(
                    dict(state.tables), params, dense, cats, labels, step)
            with spans.span("step.dense_apply"):
                self.dense_optimizer.step(params, state.opt_state)
            with spans.span("step.metrics"):
                m = metrics_lib.update(state.metrics, logits,
                                       labels.reshape(logits.shape), loss)
        return TrainState(opt_state=state.opt_state, tables=tables,
                          metrics=m, step=step + 1)

    def _microbatched(self, tables, params, dense, cats, labels, step):
        """The step over ``microbatches`` contiguous slices: sparse work
        per slice, the parameters' gradients left averaged in ``.grad``.
        Returns the tables, the mean loss and the logits in batch order."""
        k = self.microbatches
        buffers = [(b, b.clone()) for b in self.model.buffers()]
        grads = [None] * len(params)
        losses, logits = [], []
        mb_cats = {n: c.chunk(k, -1) for n, c in cats.items()}
        for i, (d, l) in enumerate(zip(_mb_split(dense, k),
                                       _mb_split(labels, k))):
            with torch.no_grad():  # each slice sees the step's statistics
                for b, saved in buffers:
                    b.copy_(saved)
            tables, auxs = self._sparse_forward(
                tables, {n: c[i] for n, c in mb_cats.items()}, step)
            loss, lg, gu, urows = self._loss_and_grads(tables, auxs, d, l)
            tables = self._apply_sparse(tables, auxs, gu, step, urows)
            for j, p in enumerate(params):
                if p.grad is not None:
                    grads[j] = p.grad if grads[j] is None \
                        else grads[j] + p.grad
            losses.append(loss)
            logits.append(lg)
        for p, g in zip(params, grads):
            p.grad = None if g is None else g / k
        return tables, torch.stack(losses).mean(), torch.cat(logits)

    @torch.no_grad()
    def _eval_step(self, state: TrainState, mstate, dense, cats, labels):
        """Read-only: missing keys read their deterministic init row."""
        if dense is not None:
            dense = normalize_dense(self.numeric_columns, dense)
        outputs = {}
        for name, coll in self.collections.items():
            aux, rows = _readonly_lookup(coll, state.tables[name].ev,
                                         cats[name])
            outputs[name] = coll.embeddings_readonly(rows, aux)
        out = self.forward(self.model, dense, outputs, False)
        logits = out[0] if isinstance(out, tuple) else out
        return metrics_lib.update(mstate, logits, labels,
                                  bce_loss(logits, labels))

    # -- public API --------------------------------------------------------
    def train_step(self, state: TrainState, batch) -> TrainState:
        dense, cats, labels = self.prepare_batch(batch)
        return self._train_step(state, dense, cats, labels)

    def eval_step(self, state: TrainState, mstate, batch):
        dense, cats, labels = self.prepare_batch(batch, train=False)
        return self._eval_step(state, mstate, dense, cats, labels)

    # -- fence work (run with any HostStepPipeline drained) ------------------
    def maybe_grow(self, state: TrainState) -> TrainState:
        """Double every table whose collection asks for it
        (``needs_growth(state)``: a device-index table at 0.7 load or after
        an index overflow, a host-index one at 0.9 or after a row
        overflow), optimizer slot rows carried along. Later resolves and
        steps read the new capacity."""
        tables = dict(state.tables)
        changed = False
        for name, coll in self.collections.items():
            b = tables[name]
            if coll.needs_growth(b.ev):
                new_ev, slot = coll.grow_state(
                    b.ev, b.slot, opt=self.sparse_optimizers.get(name))
                tables[name] = b._replace(ev=new_ev, slot=slot)
                changed = True
        return state._replace(tables=tables) if changed else state

    def maybe_demote(self, state: TrainState) -> TrainState:
        """Demote the cold rows of every tiered host-index table to its
        host tier (``demote_cold``). Fence work, as growth is: run it on a
        drained ``HostStepPipeline``, because demotion renumbers slots."""
        tables = dict(state.tables)
        changed = False
        for name, coll in self.collections.items():
            if not getattr(coll, "_tiered", False):
                continue
            b = tables[name]
            new_ev, slot, nd = coll.demote_cold(
                b.ev, b.slot, int(state.step),
                opt=self.sparse_optimizers.get(name))
            if nd:
                tables[name] = b._replace(ev=new_ev, slot=slot)
                changed = True
        return state._replace(tables=tables) if changed else state

    @property
    def tiers(self) -> Dict[str, Any]:
        """Each tiered collection's host tier store (None before its first
        demotion or restore)."""
        return {n: c.tier_store for n, c in self.collections.items()
                if getattr(c, "_tiered", False)}

    def export_tiers(self, state: TrainState, since=None) -> Dict[str, Any]:
        """``name -> (keys, payload rows)`` of the tiers with rows to save
        (``since``: only those demoted since the last save)."""
        out = {}
        for name, coll in self.collections.items():
            fn = getattr(coll, "export_tier", None)
            r = fn(since=since) if fn is not None else None
            if r is not None:
                out[name] = r
        return out

    def import_tier(self, name: str, keys, rows) -> None:
        fn = getattr(self.collections.get(name), "import_tier", None)
        if fn is not None:
            fn(keys, rows)

    def host_tier_rows(self, name: str) -> int:
        fn = getattr(self.collections.get(name), "host_tier_rows", None)
        return fn() if fn is not None else 0

    def rejit(self) -> None:
        """Nothing to rebuild: an eager step reads the new shapes itself
        (the JAX trainer re-traces its jitted steps here)."""

    def reset_metrics(self, state: TrainState) -> TrainState:
        return state._replace(metrics=metrics_lib.create(device=self.device))

    def table_health(self, state: TrainState) -> Dict[str, dict]:
        """Operational health per dynamic table, the JAX package's schema:
        size, load, index overflow, exchange drops (0 on one device), dedup
        saturation and the unique high-water mark. A device-index table
        reads its index and its health counters; a host-index one its
        resolver (``host_health``)."""
        out = {}
        for name, coll in self.collections.items():
            b = state.tables[name]
            view = coll.index_view(b.ev)
            if view is None:
                if hasattr(coll, "host_health"):
                    out[name] = coll.host_health()
                continue
            size = int(view.index.size.sum())
            cap = coll.config.capacity
            h = (b.health.tolist() if b.health is not None else [0, 0, 0])
            out[name] = {
                "size": size, "capacity": cap, "shards": 1,
                "load_factor": size / cap,
                "overflow": int(view.index.overflow.sum()),
                "dropped": int(h[0]),
                "unique_saturated_steps": int(h[1]),
                "max_n_unique": int(h[2]),
                "max_unique": coll.config.max_unique,
            }
        return out


def _readonly_lookup(coll: EmbeddingCollection, state, cats):
    """Lookup without mutation: unknown keys read their would-be init
    row."""
    return coll.readonly_rows(state, cats)


def default_forward(apply_fn, dense, outputs, train):
    """Convention: collection "emb" -> pooled dict + sequence dict;
    optional collection "wide" -> wide dict. ``apply_fn`` is the model."""
    emb, seq = outputs.get("emb", ({}, {}))
    kwargs = {}
    if "wide" in outputs:
        kwargs["wide"] = outputs["wide"][0]
    if seq:
        kwargs["seq"] = seq
    return apply_fn(dense, emb, train=train, **kwargs)
