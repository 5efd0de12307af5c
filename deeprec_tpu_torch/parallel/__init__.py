"""Distributed runtime over the ranks of a ``torch.distributed`` group:
row-sharded tables (``ShardedTrainer`` over device-index, variant and
host-sharded collections), their host tiers (``TieredShardedTrainer``),
the sharded second KV stack (``DistributedHashTable``), ``make_mesh`` and
the process-group utilities of ``multihost``."""
from .hash_table import DistributedHashTable
from .multihost import make_mesh
from .tiered import TieredShardedTrainer
from .trainer import ShardedTrainer

__all__ = ["DistributedHashTable", "ShardedTrainer", "TieredShardedTrainer",
           "make_mesh"]
