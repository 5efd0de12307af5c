"""TieredShardedTrainer: host tiers for the row-sharded device-index
tables.

Port of ``deeprec_tpu/parallel/tiered.py``: the mesh trainer of
``parallel/trainer.py`` with the host tiers of ``train/tiered_trainer.py``
(``TierCheckpointMixin``). One rank per process owns one table shard and
the host tier of that shard's keys; payloads carry the full row state
(values, bit-cast freq/version/create step, optimizer slot rows:
``sparse/tier_payload.py``), so a demoted row comes back intact.

* **Promotion** before a step: every rank is handed the same global batch,
  so its probe (:meth:`prepare_probe`, numpy only) is the batch's ids that
  the owner hash routes to this rank; their tier rows go back into this
  rank's shard (``tier_payload.scatter``) and leave the tier only where
  the index placed them. The JAX package allgathers per-process probes
  first; here each rank holds the whole batch already.
* **Demotion** at fences (:meth:`maybe_demote`): each rank exports its
  shard's policy-cold rows and, past ``storage.hbm_capacity // S`` rows
  (the table's budget split evenly over the shards), its least recently
  touched ones, and shrinks its shard (``ev.shrink``, the JAX
  ``_shrink_sharded``).
* **Saves**: each rank's part carries its tier (``__tier__<name>``); a
  restore at any rank count imports the rows the owner hash routes here
  (:meth:`import_tier`), and a key whose saved tier row wins lives in the
  tier only (the saver's rule on every engine of the port).

Nothing here is a collective: promotion, demotion and tier imports touch
only this rank's shard and tier. ``host_tier_rows`` counts this rank's
tier, as the JAX package counts a process's.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..train.tiered_trainer import TierCheckpointMixin
from .sharded import owner_of_np
from .trainer import ShardedTrainer


class TieredShardedTrainer(TierCheckpointMixin, ShardedTrainer):
    """:class:`ShardedTrainer` with host tiers for ``HBM_DRAM[_SSD]``
    device-index tables. :meth:`train_step` promotes before each step;
    call :meth:`maybe_demote` at fences, on every rank."""

    _tiers_ok = True

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._init_tiers()

    def _mine(self, keys: np.ndarray) -> np.ndarray:
        return owner_of_np(keys, self.S) == self.rank

    def _tier_budget(self, name: str) -> int:
        """This shard's share of the table's ``hbm_capacity``."""
        budget = super()._tier_budget(name)
        return max(1, budget // self.S) if budget > 0 else 0

    def prepare_probe(self, batch) -> Dict[str, np.ndarray]:
        """The ids of the global ``batch`` that this rank owns, per tiered
        table (numpy only: safe in prefetch workers)."""
        return {name: ids[self._mine(ids)]
                for name, ids in super().prepare_probe(batch).items()}

    def import_tier(self, name: str, keys: np.ndarray, rows: np.ndarray):
        """Keep the restored tier rows this rank owns (a save at another
        rank count holds every rank's)."""
        if name not in self._tiers or not len(keys):
            return
        mine = self._mine(keys)
        if mine.any():
            super().import_tier(name, keys[mine], rows[mine])
