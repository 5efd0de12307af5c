"""User-facing API with the reference's entry-point names.

Port of ``deeprec_tpu/api.py``: DeepRec's public surface
(``tf.get_embedding_variable``, ``get_multihash_variable``,
``get_dynamic_dimension_embedding_variable``, ``get_hash_table``,
``categorical_column_with_embedding``,
``categorical_column_with_adaptive_embedding``, ``embedding_column``,
``shared_embedding_columns``) mapped onto this package's configs, states
and columns, with the JAX package's names and arguments. They return
(config, state) pairs instead of registering graph resources. A function
that creates a state takes ``device`` (the card by default; ``"cpu"`` for
the plain versions).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

from .config import (CBFFilter, CounterFilter, EmbeddingVariableConfig,
                     GlobalStepEvict, Initializer, L2WeightEvict,
                     StorageOption, StorageType)
from .feature_column import (CategoricalColumn, EmbeddingColumn,
                             EmbeddingCollection, NumericColumn,
                             SequenceEmbeddingColumn)
from .sparse import adaptive, dynamicdim, embedding_var, hash_table_api
from .sparse import multihash as _mh


def get_embedding_variable(
    name: str,
    embedding_dim: int,
    key_dtype: str = "int64",
    initializer: Optional[Initializer] = None,
    ev_option=None,
    capacity: int = 1 << 16,
    device="cuda",
    **kwargs,
) -> Tuple[EmbeddingVariableConfig, "embedding_var.EVState"]:
    """tf.get_embedding_variable analog: returns (config, fresh state).

    Filters/eviction/storage come in as config kwargs (counter_filter=,
    cbf_filter=, evict=, storage=) instead of the EmbeddingVariableOption
    bundle; :mod:`deeprec_tpu_torch.config` holds the option classes.
    """
    cfg = EmbeddingVariableConfig(
        name=name, embedding_dim=embedding_dim, capacity=capacity,
        initializer=initializer or Initializer(), **kwargs)
    return cfg, embedding_var.create(cfg, device)


def get_multihash_variable(
    name: str,
    dims: Sequence[int],
    complementary_strategy: str = "Q-R",
    operation: str = "add",
    embedding_dim: Optional[int] = None,
    device="cuda",
    **kwargs,
) -> Tuple[_mh.MultiHashConfig, _mh.MultiHashState]:
    """get_multihash_variable analog: ``dims`` are the sub-table sizes
    (Q, R, ...); ``operation`` in add|mult|concat."""
    if complementary_strategy != "Q-R":
        raise ValueError("only the Q-R complementary strategy is supported")
    cfg = _mh.MultiHashConfig(
        name=name, embedding_dim=embedding_dim or kwargs.pop("dim", 16),
        table_sizes=tuple(dims), combiner=operation)
    return cfg, _mh.create(cfg, device=device)


def get_dynamic_dimension_embedding_variable(
    name: str,
    embedding_block_dimension: int,
    embedding_block_num: int,
    freq_thresholds: Optional[Sequence[int]] = None,
    device="cuda",
    **kwargs,
):
    """get_dynamic_dimension_embedding_variable analog: block_num blocks
    of block_dimension, widths gated by frequency. Returns ``((config,
    dynamic-dimension config), state)``."""
    thr = tuple(freq_thresholds) if freq_thresholds else tuple(
        0 if i == 0 else 10 ** i for i in range(embedding_block_num))
    dd = dynamicdim.DynamicDimConfig(
        block_num=embedding_block_num, block_dim=embedding_block_dimension,
        freq_thresholds=thr)
    cfg = dynamicdim.ev_config(name, dd, **kwargs)
    return (cfg, dd), embedding_var.create(cfg, device)


def get_hash_table(capacity: int, admit: Optional[CBFFilter] = None,
                   device="cuda"):
    """get_hash_table analog (the second KV stack)."""
    return hash_table_api.create(capacity, admit, device)


def categorical_column_with_embedding(key: str, dtype: str = "int64",
                                      **kwargs) -> CategoricalColumn:
    """categorical_column_with_embedding analog: raw 64-bit ids, dynamic
    table."""
    return CategoricalColumn(name=key, hash_bucket_size=None, **kwargs)


def categorical_column_with_hash_bucket(key: str, hash_bucket_size: int,
                                        **kwargs) -> CategoricalColumn:
    return CategoricalColumn(name=key, hash_bucket_size=hash_bucket_size,
                             **kwargs)


def categorical_column_with_adaptive_embedding(key: str, hash_bucket_size: int,
                                               **kwargs):
    """categorical_column_with_adaptive_embedding analog. The adaptive
    routing lives in ``sparse.adaptive`` (and ``feature_column_variants.
    AdaptiveCollection``); the column is a CategoricalColumn, returned with
    the static table's bucket count."""
    return CategoricalColumn(name=key, hash_bucket_size=None, **kwargs), \
        hash_bucket_size


def embedding_column(categorical: CategoricalColumn, dimension: int,
                     combiner: str = "mean", **kwargs) -> EmbeddingColumn:
    """embedding_column analog (collections always coalesce lookups)."""
    return EmbeddingColumn(categorical=categorical, dimension=dimension,
                           combiner=combiner)


def shared_embedding_columns(keys: Sequence[str], dimension: int,
                             shared_name: str, combiner: str = "mean",
                             max_lengths: Optional[Sequence[int]] = None
                             ) -> list:
    """shared_embedding_columns analog: same rows across several columns."""
    out = []
    for i, k in enumerate(keys):
        ml = max_lengths[i] if max_lengths else 1
        out.append(EmbeddingColumn(
            CategoricalColumn(name=k, shared_embedding=shared_name,
                              max_length=ml),
            dimension=dimension, combiner=combiner))
    return out
