"""Training core: one step over dynamic tables and the dense model.

Port of ``deeprec_tpu/train/trainer.py``: ``TableBundle``, ``TrainState``,
``bce_loss``, the :class:`Trainer` (``microbatches=1``), and the forward
conventions ``default_forward`` and ``_readonly_lookup`` that serving uses
too.

A train step, as in the JAX package: sparse lookup-or-create (no
gradient) -> the unique rows become the differentiable leaf -> pooling,
model and BCE loss -> one ``backward()`` gives the unique rows' gradient
and the parameters' -> per-table sparse apply -> the dense optimizer ->
metrics. PyTorch runs it eagerly; tables, optimizer state and parameters
are updated in place (the JAX package donates them to a jitted step).
The model's parameters live in the module, so :class:`TrainState` holds
no params.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..feature_column import (EmbeddingCollection, NumericColumn,
                              normalize_dense, pack_dense)
from ..optim.dense import Adagrad
from ..optim.sparse import SparseOptimizer
from . import metrics as metrics_lib


class TableBundle(NamedTuple):
    ev: Any     # the collection's state (host_index.HostEVState)
    slot: Any   # the sparse optimizer's slot state


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


class Trainer:
    """Bundles model, feature columns and optimizers into train and eval
    steps on ``device`` (the card by default).

    ``forward(model, dense, outputs, train)`` consumes
    ``outputs[collection_name] = (emb_dict, seq_dict)`` and returns logits
    or ``(logits, aux_loss)``. ``dense_optimizer`` is an
    ``optim.dense.Adagrad`` (the counterpart of ``optax.adagrad``).
    """

    def __init__(self, model: torch.nn.Module,
                 numeric_columns: Sequence[NumericColumn],
                 collections: Dict[str, EmbeddingCollection],
                 sparse_optimizers: Dict[str, SparseOptimizer],
                 dense_optimizer: Adagrad,
                 forward: Optional[Callable] = None,
                 aux_loss_weight: float = 1.0, device="cuda"):
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

    # -- init ------------------------------------------------------------
    def init(self, sample_batch) -> TrainState:
        """Fresh tables, optimizer state and metrics. As in the JAX
        package, a throwaway lookup of ``sample_batch`` runs the model once
        (here it checks that the model takes the collections' outputs),
        then ``coll.init`` resets the tables and the host index."""
        dense, cats, _ = self.prepare_batch(sample_batch)
        if dense is not None:
            dense = normalize_dense(self.numeric_columns, dense)
        tables, outputs = {}, {}
        with torch.no_grad():
            for name, coll in self.collections.items():
                st = coll.init(self.device)
                st, aux = coll.lookup_or_create(st, cats[name], 0)
                urows = coll.rows_for_training(st, aux)
                outputs[name] = (coll.embeddings(urows, aux), {})
                slot = coll.init_slot(self.sparse_optimizers[name], st)
                tables[name] = TableBundle(ev=coll.init(self.device),
                                           slot=slot)
            self.forward(self.model, dense, outputs, True)
        params = list(self.model.parameters())
        return TrainState(opt_state=self.dense_optimizer.init(params),
                          tables=tables,
                          metrics=metrics_lib.create(device=self.device),
                          step=0)

    # -- batch plumbing ----------------------------------------------------
    def prepare_batch(self, batch: Dict[str, np.ndarray], train: bool = True):
        """Host packing and the copies to the device: dense columns, each
        collection's ids (a host-index collection resolves here; with
        ``train=False`` through its read-only ``pack_ids_eval``) and
        labels."""
        dense = (torch.from_numpy(pack_dense(self.numeric_columns, batch))
                 .to(self.device) if self.numeric_columns else None)
        cats = {}
        for name, coll in self.collections.items():
            ro = None if train else getattr(coll, "pack_ids_eval", None)
            pack = coll.pack_ids if ro is None else ro
            cats[name] = pack(batch, self.device)
        labels = (torch.from_numpy(np.asarray(batch["label"], np.float32))
                  .to(self.device) if "label" in batch else None)
        return dense, cats, labels

    # -- the step ----------------------------------------------------------
    def _sparse_forward(self, tables, cats, step):
        auxs = {}
        for name, coll in self.collections.items():
            ev_state, auxs[name] = coll.lookup_or_create(tables[name].ev,
                                                         cats[name], step)
            tables[name] = tables[name]._replace(ev=ev_state)
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
        outputs = {name: (coll.embeddings(urows[name], auxs[name]), {})
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
        step = state.step
        if dense is not None:
            dense = normalize_dense(self.numeric_columns, dense)
        tables, auxs = self._sparse_forward(dict(state.tables), cats, step)
        loss, logits, gu, urows = self._loss_and_grads(tables, auxs, dense,
                                                       labels)
        tables = self._apply_sparse(tables, auxs, gu, step, urows)
        self.dense_optimizer.step(list(self.model.parameters()),
                                  state.opt_state)
        m = metrics_lib.update(state.metrics, logits,
                               labels.reshape(logits.shape), loss)
        return TrainState(opt_state=state.opt_state, tables=tables,
                          metrics=m, step=step + 1)

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
