"""TieredTrainer: device-index tables with a host tier (HBM + DRAM[+SSD]).

Port of ``deeprec_tpu/train/tiered_trainer.py``: :class:`TierCheckpointMixin`
(the host tiers: promotion, demotion and the persistence hooks the
checkpoint saver drives; ``parallel.TieredShardedTrainer`` mixes it in
too) and :class:`TieredTrainer`, the device-index engine's tier manager.
Tables
whose ``StorageOption`` is ``HBM_DRAM`` or ``HBM_DRAM_SSD`` keep their hot
rows in the device stores and demote cold ones to a host store
(``utils.native.HostKV``, or a ``TierStack`` spilling to a file) with full
fidelity: values, the freq/version/create-step planes and the optimizer
slot rows travel as one ``sparse.tier_payload`` row and come back intact.

* **Promotion** before a step: the batch's ids probe the host tier (pure
  numpy, :meth:`~TierCheckpointMixin.prepare_probe`, safe in prefetch workers);
  the hits are inserted into the device table by
  ``tier_payload.scatter`` (:meth:`~TierCheckpointMixin.promote_packed`) and
  leave the tier only where the index placed them (``live``). The JAX
  package pads the hits to a power of two to bound its recompiles; an
  eager step has none, so nothing is padded.
* **Demotion** at fences (:meth:`~TierCheckpointMixin.maybe_demote`): the
  policy-cold rows (``ev.cold_mask_np``) and, past
  ``storage.hbm_capacity``, the least recently touched ones
  (``ev.budget_cold_np``) are gathered on the device and copied to the
  host once (``tier_payload.gather_np``), upserted into the tier, and
  dropped from the table by ``ev.shrink(keep_mask=)``, which renumbers the
  slots: call it with no step in flight.

Checkpoints: the saver writes each tier as a ``__tier__<name>`` table
(:meth:`TierCheckpointMixin.export_tiers`; an incremental save takes the
rows whose version stamp is at or after the previous save) and restores it
with :meth:`TierCheckpointMixin.import_tier`. A key whose saved tier row is
newer than its saved device row is restored into the tier only, as on the
host-index engine (``checkpoint/saver.py``).
"""
from __future__ import annotations

import itertools
import os
import tempfile
from typing import Dict, Optional

import numpy as np
import torch

from ..config import L2WeightEvict, StorageType
from ..optim.sparse import permute_slot_state
from ..sparse import embedding_var as ev
from ..sparse import tier_payload as TP
from ..utils.native import HostKV, TierStack
from .trainer import Trainer, TrainState

TIERED_STORAGE = (StorageType.HBM_DRAM, StorageType.HBM_DRAM_SSD)
_arena_ids = itertools.count()  # one SSD arena file per default-path tier


class TierCheckpointMixin:
    """The host tiers of a trainer's ``HBM_DRAM[_SSD]`` device-index
    tables (``self.tiers``: name -> host store, made at the first
    demotion or restore): promotion (:meth:`promote_packed`), demotion
    (:meth:`maybe_demote`, each table within :meth:`_tier_budget` rows)
    and the persistence hooks the checkpoint saver drives, since a restart
    must not lose demoted rows. ``TieredTrainer`` and
    ``parallel.TieredShardedTrainer`` (one tier per rank) mix it in."""

    def _init_tiers(self) -> None:
        self._tiers: Dict[str, object] = {
            name: None for name, coll in self.collections.items()
            if coll.config.storage.storage_type in TIERED_STORAGE}

    @property
    def tiers(self) -> Dict[str, object]:
        return self._tiers

    def _payload_spec(self, name, bundle) -> TP.PayloadSpec:
        cap1 = self.collections[name].config.capacity + 1
        return TP.spec(bundle.ev.values.shape[1], bundle.slot, cap1)

    def _tier_budget(self, name: str) -> int:
        """The rows the table may keep on the device (0: no budget)."""
        return self.collections[name].config.storage.hbm_capacity

    def _make_tier(self, name: str, width: int):
        """The host store of one table, as its ``StorageOption`` says: a
        DRAM KV, or the DRAM -> SSD cascade. An empty ``ssd_path`` takes a
        file of its own under the temp dir."""
        st = self.collections[name].config.storage
        if st.storage_type == StorageType.HBM_DRAM_SSD:
            path = st.ssd_path or os.path.join(
                tempfile.gettempdir(),
                f"deeprec_ssd_{name}_{os.getpid()}_{next(_arena_ids)}.arena")
            return TierStack(width, self._tier_version_col(name),
                             st.dram_row_budget, path)
        return HostKV(width, 1 << 16)

    def _tier_version_col(self, name: str) -> int:
        """The payload's version column: after the values block (embedding
        dim + fused slot columns) and the freq column."""
        cfg = self.collections[name].config
        return cfg.embedding_dim + cfg.fused_slot_columns + 1

    # -- promotion -------------------------------------------------------
    def train_step(self, state: TrainState, batch) -> TrainState:
        if self._tiers:
            state = self.promote_packed(state, self.prepare_probe(batch))
        return super().train_step(state, batch)

    def prepare_probe(self, batch) -> Dict[str, np.ndarray]:
        """The ids each tiered table probes its tier with (numpy only:
        safe in prefetch workers). Hand them to :meth:`promote_packed`
        before the step."""
        out = {}
        for name in self._tiers:
            ids = np.unique(self.collections[name].pack_ids_np(batch))
            out[name] = ids[ids != -1]
        return out

    def promote_packed(self, state: TrainState,
                       probe: Dict[str, np.ndarray]) -> TrainState:
        """Move the probed ids' tier rows back into their device tables
        (``tier_payload.scatter``); a row leaves the tier only once the
        index has placed it."""
        tables = dict(state.tables)
        changed = False
        for name, kv in self._tiers.items():
            ids = probe[name]
            if kv is None or len(kv) == 0 or not len(ids):
                continue
            payload, found = kv.lookup(ids)
            if not found.any():
                continue
            hit = ids[found]
            b = tables[name]
            dev = b.ev.values.device
            tables[name], live = TP.scatter(
                b, self.collections[name].config,
                self._payload_spec(name, b), torch.from_numpy(hit).to(dev),
                torch.from_numpy(payload[found]).to(dev))
            confirmed = live.cpu().numpy()
            if confirmed.any():
                kv.erase(hit[confirmed])
            changed = True
        return state._replace(tables=tables) if changed else state

    # -- demotion ----------------------------------------------------------
    def maybe_demote(self, state: TrainState) -> TrainState:
        """Export the cold rows (policy, then past :meth:`_tier_budget` the
        least recently touched) to the host tier and drop exactly those
        from the device table (``ev.shrink``, which renumbers the slots:
        call it with no step in flight). A table with no eviction policy
        and no budget never demotes."""
        tables = dict(state.tables)
        changed = False
        gs = int(state.step)
        for name in self._tiers:
            cfg = self.collections[name].config
            budget = self._tier_budget(name)
            if cfg.evict is None and budget <= 0:
                continue
            b = tables[name]
            st = b.ev
            keys = st.index.keys.cpu().numpy()
            occupied = keys != -1
            versions = st.versions.cpu().numpy()
            freqs = st.freqs.cpu().numpy()
            values_np = (st.values.float().cpu().numpy()
                         if isinstance(cfg.evict, L2WeightEvict)
                         else np.zeros((keys.shape[0], 1), np.float32))
            cold = ev.cold_mask_np(cfg, values_np, versions, occupied, gs)
            cold = ev.budget_cold_np(cfg, versions, freqs, occupied, cold,
                                     budget)
            if not cold.any():
                continue
            idx = np.nonzero(cold)[0]
            spec = self._payload_spec(name, b)
            if self._tiers[name] is None:
                self._tiers[name] = self._make_tier(name, spec.width)
            self._tiers[name].upsert(keys[idx], TP.gather_np(
                spec, st, b.slot, idx, freqs, versions))
            keep = torch.from_numpy(~cold).to(st.values.device)
            new_ev, perm = ev.shrink(st, cfg, gs, keep_mask=keep)
            slot = permute_slot_state(
                b.slot, perm, cfg.capacity,
                fills=self.sparse_optimizers[name].fills)
            tables[name] = b._replace(ev=new_ev, slot=slot)
            changed = True
        return state._replace(tables=tables) if changed else state

    def host_tier_rows(self, name: str) -> int:
        kv = self._tiers.get(name)
        return len(kv) if kv is not None else 0

    # -- persistence -------------------------------------------------------
    def export_tiers(self, state, since: Optional[int] = None):
        """``name -> (keys int64 [n], payload f32 [n, W])`` of every
        non-empty tier; ``since`` keeps the rows whose (bit-pattern)
        version stamp is at or after it, the incremental save's rows."""
        out = {}
        for name, kv in self.tiers.items():
            if kv is None or len(kv) == 0:
                continue
            keys, rows = kv.export()
            if since is not None:
                vers = rows[:, self._tier_version_col(name)].copy().view(
                    np.int32)
                keys, rows = keys[vers >= since], rows[vers >= since]
            if len(keys):
                out[name] = (keys, rows)
        return out

    def import_tier(self, name: str, keys: np.ndarray, rows: np.ndarray):
        """Upsert restored rows into a table's tier (made at the restored
        payload width); the saver imports in save order, so the newest
        row wins."""
        if name not in self.tiers:
            return
        if self.tiers[name] is None:
            self.tiers[name] = self._make_tier(name, rows.shape[1])
        self.tiers[name].upsert(keys, rows)


class TieredTrainer(TierCheckpointMixin, Trainer):
    """A :class:`Trainer` whose ``HBM_DRAM[_SSD]`` device-index tables
    spill to host tiers. :meth:`train_step` promotes before each step;
    call :meth:`maybe_demote` at fences."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._init_tiers()
