"""Checkpointing: full + incremental saves in the JAX package's format
(:mod:`.format`, :mod:`.saver`), and the import of DeepRec TensorBundle
checkpoints (:mod:`.bundle_reader`, :mod:`.migrate`, loaded on first
use)."""
from .format import list_saves, restore_plan
from .saver import CheckpointManager, table_snapshot_host

__all__ = ["CheckpointManager", "table_snapshot_host", "list_saves",
           "restore_plan", "BundleReader", "import_tables", "import_dense",
           "scan"]


def __getattr__(name):
    # lazy: the migration path is only needed to import reference
    # checkpoints
    if name == "BundleReader":
        from .bundle_reader import BundleReader
        return BundleReader
    if name in ("import_tables", "import_dense", "scan"):
        from . import migrate
        return getattr(migrate, name)
    raise AttributeError(name)
