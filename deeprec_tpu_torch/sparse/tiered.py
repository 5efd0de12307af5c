"""Multi-tier embedding storage at library level: one device table plus a
host-DRAM tier.

Port of ``deeprec_tpu/sparse/tiered.py`` :class:`TieredTable`, the tier
manager paired with one :class:`~.embedding_var.EVState` (the trainer-level
one is ``train.tiered_trainer.TieredTrainer``). Between steps,
:meth:`TieredTable.demote` exports the policy-cold rows to a native host
KV (``utils.native.HostKV``) and shrinks the device table; after a lookup,
:meth:`TieredTable.promote_created` looks the keys created this step up
in the tier and writes the hits' saved rows over their fresh ones, clearing
their ``created`` flags (lazy init must not add an init to a restored
row). The stored row is the values row only (fused slot columns
included); the trainer's tier carries the full payload. (The JAX class's
``track_slots`` flag is read nowhere and is left out.)
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..config import EmbeddingVariableConfig
from ..utils.native import HostKV
from . import embedding_var as ev


class TieredTable:
    """Host-tier manager paired with one EVState."""

    def __init__(self, config: EmbeddingVariableConfig,
                 capacity_hint: int = 1 << 16):
        self.config = config
        self._capacity_hint = capacity_hint
        self.host: Optional[HostKV] = None  # sized at first use: the row
        #                                     width counts fused columns

    def _host(self, width: int) -> HostKV:
        if self.host is None:
            self.host = HostKV(width, self._capacity_hint)
        if self.host.dim != width:
            raise ValueError("row width changed under the tier")
        return self.host

    # -- promotion (after lookup) ------------------------------------------
    def promote_created(self, state: ev.EVState, aux: ev.LookupAux
                        ) -> Tuple[ev.EVState, ev.LookupAux]:
        """Overwrite the rows created this step with their tier rows, where
        the tier holds them; they leave the tier. Returns the state
        (values written in place) and an aux whose ``created`` flags are
        cleared for the promoted keys."""
        if self.host is None or len(self.host) == 0:
            return state, aux
        created = aux.created.cpu().numpy()
        if not created.any():
            return state, aux
        ukeys = aux.uniq.ukeys.cpu().numpy()
        slots = aux.slots.cpu().numpy()
        idx = np.nonzero(created)[0]
        rows, found = self.host.lookup(ukeys[idx])
        if not found.any():
            return state, aux
        hit = idx[found]
        dev = state.values.device
        state.values[torch.from_numpy(slots[hit]).to(dev)] = \
            torch.from_numpy(rows[found]).to(dev, state.values.dtype)
        self.host.erase(ukeys[hit])
        created = created.copy()
        created[hit] = False
        return state, aux._replace(
            created=torch.from_numpy(created).to(aux.created.device))

    # -- demotion (between steps, at checkpoint) ------------------------------
    def demote(self, state: ev.EVState, global_step,
               slot_state=None) -> Tuple[ev.EVState, torch.Tensor]:
        """Move the policy-cold rows to the host tier, then shrink the
        device table dropping exactly those. Returns ``(state,
        old_to_new)``; permute slot rows with it as after a plain
        shrink."""
        cfg = self.config
        gs = int(global_step)
        values_np = state.values.float().cpu().numpy()
        versions = state.versions.cpu().numpy()
        keys = state.index.keys.cpu().numpy()
        occupied = keys != -1
        cold = ev.cold_mask_np(cfg, values_np, versions, occupied, gs)
        if cold.any():
            idx = np.nonzero(cold)[0]
            self._host(values_np.shape[1]).upsert(keys[idx], values_np[idx])
        keep = torch.from_numpy(~cold).to(state.values.device)
        return ev.shrink(state, cfg, gs, keep_mask=keep)

    # -- lookup-or-create with promotion ---------------------------------------
    def lookup_or_create(self, state: ev.EVState, ids: torch.Tensor, step
                         ) -> Tuple[ev.EVState, ev.LookupAux]:
        state, aux = ev.lookup_or_create(state, self.config, ids, int(step))
        return self.promote_created(state, aux)

    # -- stats and persistence ----------------------------------------------------
    def host_rows(self) -> int:
        return len(self.host) if self.host is not None else 0

    def export_host(self):
        """``(keys int64 [n], rows f32 [n, width])`` of the tier."""
        if self.host is None:
            return (np.zeros((0,), np.int64),
                    np.zeros((0, self.config.embedding_dim
                              + self.config.fused_slot_columns), np.float32))
        return self.host.export()

    def import_host(self, keys: np.ndarray, rows: np.ndarray):
        self._host(rows.shape[1]).upsert(keys, rows)
