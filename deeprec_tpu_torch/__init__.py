"""deeprec_tpu_torch: the PyTorch + CUDA (Hopper) port of ``deeprec_tpu``.

Imports ``torch`` and never ``jax``: the serving path (checkpoint ->
:class:`~deeprec_tpu_torch.serving.Predictor` -> DLRM -> HTTP), both
training engines (:class:`~deeprec_tpu_torch.train.trainer.Trainer` over
device-index ``EmbeddingCollection``s, the variant collections of
``feature_column_variants`` and
:class:`~deeprec_tpu_torch.host_index.HostIndexEmbeddingCollection`), the
multi-device engines of ``parallel`` (one rank per process on
``torch.distributed``: ``ShardedTrainer`` over device-index, variant and
:class:`HostShardedCollection` tables, ``TieredShardedTrainer``,
``DistributedHashTable``) and the migration of DeepRec checkpoints
(``checkpoint.migrate``) run on a machine without JAX. Every Pallas kernel of the JAX package is a
hand-written CUDA kernel in ``csrc/``, built with nvcc at first use: the
row gather (``ops/gather.py``, K1), the fused gather+pool and its backward
(``ops/fused_lookup.py``, K2) and the metadata scatters
(``ops/meta_scatter.py``, K3a/K3b). On CPU tensors they run their plain
PyTorch versions. Layout and names mirror ``deeprec_tpu``; the top level
re-exports what ``deeprec_tpu`` does.
"""

from . import config
from .config import (CBFFilter, CounterFilter, EmbeddingVariableConfig,
                     GlobalStepEvict, Initializer, L2WeightEvict,
                     StorageOption, StorageType)
from .sparse import embedding_var, hashtable, keys
from .host_index import HostIndexEmbeddingCollection
from .parallel.host_sharded import HostShardedCollection
from .api import (categorical_column_with_adaptive_embedding,
                  categorical_column_with_embedding,
                  categorical_column_with_hash_bucket, embedding_column,
                  get_dynamic_dimension_embedding_variable,
                  get_embedding_variable, get_hash_table,
                  get_multihash_variable, shared_embedding_columns)

__version__ = "0.1.0"
