"""Distributed runtime: row-sharded tables over the ranks of a
``torch.distributed`` group (``ShardedTrainer``, ``make_mesh``) and the
process-group utilities of ``multihost``. ``TieredShardedTrainer`` and
``DistributedHashTable`` are not ported yet (ROADMAP A8)."""
from .multihost import make_mesh
from .trainer import ShardedTrainer

__all__ = ["ShardedTrainer", "make_mesh"]
