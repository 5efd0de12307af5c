"""Serving: a read-only predictor over a checkpoint directory, with live
incremental refresh.

Port of ``deeprec_tpu/serving/predictor.py`` ``Predictor``. It restores
every collection's saved rows into a hash index and row store on
``device``, carries the flax-trained dense weights into the caller's torch
module (:func:`~deeprec_tpu_torch.models.ctr.load_flax_params`), and
answers ``predict(batch)`` with click probabilities. Lookups are
read-only: unknown keys read their deterministic init row (the EV
default-value semantics). :meth:`Predictor.refresh` applies newer saves
(a new full save reloads; incrementals replay in order) without
rebuilding the model. ``TieredPredictor`` and ``ShardedPredictor`` are not
ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np
import torch

from ..checkpoint import format as F
from ..checkpoint.saver import _reject_tiers, _scatter_table, needed_capacity
from ..feature_column import (EmbeddingCollection, NumericColumn, pack_dense,
                              normalize_dense)
from ..models.ctr import load_flax_params
from ..sparse import embedding_var as ev
from ..train.trainer import _readonly_lookup, default_forward


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
        base, incrs = F.restore_plan(ckpt_dir)
        if base is None:
            raise FileNotFoundError(f"no full checkpoint in {ckpt_dir}")
        self._load_base(base)
        for m in incrs:
            self._apply_save(m)

    # -- loading -----------------------------------------------------------
    def _load_base(self, manifest):
        for name, coll in self.collections.items():
            _reject_tiers(manifest["path"], name)
            arrays = F.read_table(manifest["path"], name)
            _adopt_row_layout(coll, arrays)
            cap = needed_capacity(arrays["keys"].shape[0] + 8,
                                  coll.config.capacity)
            if cap != coll.config.capacity:
                coll.config = dataclasses.replace(coll.config, capacity=cap)
            st = ev.create(coll.config, self.device)
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
            _reject_tiers(manifest["path"], name)
            arrays = F.read_table(manifest["path"], name)
            st = self.tables[name]
            size = int(st.index.size.sum())
            cap = needed_capacity(size + arrays["keys"].shape[0],
                                  coll.config.capacity)
            if cap != coll.config.capacity:
                st, _ = ev.grow(st, coll.config, cap)
                coll.config = dataclasses.replace(coll.config, capacity=cap)
            self.tables[name] = _scatter_table(st, coll.config, arrays)
        self._load_dense(manifest)
        self._applied_steps.add(manifest["step"])

    # -- refresh -----------------------------------------------------------
    def refresh(self) -> bool:
        """Apply any new saves in the directory. A newer FULL save reloads
        the base; newer incrementals replay in order. Returns True if the
        serving state changed."""
        base, incrs = F.restore_plan(self.ckpt_dir)
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

    def predict(self, batch) -> np.ndarray:
        """[B] click probabilities for a raw feature batch
        (column name -> numpy array)."""
        dense, cats = self._prepare(batch)
        with torch.inference_mode():
            if dense is not None:
                dense = normalize_dense(self.numeric_columns, dense)
            outputs = {}
            for name, coll in self.collections.items():
                aux, urows = _readonly_lookup(coll, self.tables[name],
                                              cats[name])
                outputs[name] = coll.embeddings_readonly(urows, aux)
            out = self.forward(self.model, dense, outputs, False)
            logits = out[0] if isinstance(out, tuple) else out
            return torch.sigmoid(logits).cpu().numpy()
