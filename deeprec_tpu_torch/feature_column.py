"""Feature columns and the coalesced embedding collection.

Port of ``deeprec_tpu/feature_column.py``: the column dataclasses,
``pack_dense``/``normalize_dense``, and of :class:`EmbeddingCollection` the
serving half (``pack_ids_np``, ``readonly_rows``, ``embeddings_readonly``,
``embeddings_from_rows``) and the trainer hooks (``gather_unique``,
``rows_for_training``, ``embeddings``, ``apply_gradients``, ``init_slot``).
The device-index ``lookup_or_create`` is not ported: the trainable table
is ``host_index.HostIndexEmbeddingCollection``.

Layout: a collection packs its columns' ids into one feature-major
``[total_width, B]`` int64 block, each column's ids salted with its column
group so coalesced columns never share rows. ``readonly_rows`` dedups the
flat block, probes the hash index and fetches the unique rows with kernel
K1; ``embeddings_readonly`` and ``embeddings`` pool them per column with
kernel K2 straight through ``inverse``, so the ``[total_width*B, dim]``
expanded rows are never materialised. Pooling is differentiable with
respect to the unique rows (K2's backward kernel), which is how training
gets its sparse gradient.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .config import EmbeddingVariableConfig, Initializer
from .ops.fused_lookup import pooled_lookup
from .ops.gather import gather_rows
from .ops.unique import unique
from .sparse import embedding_var as ev
from .sparse import hashtable as ht
from .sparse import keys as K


@dataclasses.dataclass(frozen=True)
class NumericColumn:
    name: str
    shape: int = 1
    log_normalize: bool = False  # log(1+max(x,0)): the Criteo dense recipe


@dataclasses.dataclass(frozen=True)
class CategoricalColumn:
    """Id source. ``hash_bucket_size``: pre-mod ids into a fixed space;
    None = raw 64-bit ids. ``shared_embedding``: columns with the same
    group name share table rows."""

    name: str
    hash_bucket_size: Optional[int] = None
    max_length: int = 1  # ids per example (multivalent width, -1 padded)
    shared_embedding: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class EmbeddingColumn:
    categorical: CategoricalColumn
    dimension: int
    combiner: str = "mean"

    @property
    def name(self) -> str:
        return self.categorical.name


@dataclasses.dataclass(frozen=True)
class SequenceEmbeddingColumn:
    """Unpooled [B, L, dim] + mask. Not served by the port yet."""

    categorical: CategoricalColumn
    dimension: int

    @property
    def name(self) -> str:
        return self.categorical.name


class CollectionAux(NamedTuple):
    ev_aux: ev.LookupAux


class EmbeddingCollection:
    """One coalesced dynamic table serving many embedding columns."""

    def __init__(self, columns: Sequence[EmbeddingColumn], name: str = "emb",
                 capacity: int = 1 << 20,
                 initializer: Initializer = Initializer(), **ev_kwargs):
        if any(isinstance(c, SequenceEmbeddingColumn) for c in columns):
            raise NotImplementedError(
                "sequence columns are not ported to deeprec_tpu_torch yet")
        dims = {c.dimension for c in columns}
        if len(dims) != 1:
            raise ValueError("columns in one collection must share a "
                             "dimension; use several collections")
        self.columns = list(columns)
        self.dim = dims.pop()
        self.config = EmbeddingVariableConfig(
            name=name, embedding_dim=self.dim, capacity=capacity,
            initializer=initializer, **ev_kwargs)
        self._widths = [c.categorical.max_length for c in self.columns]
        self._offsets = np.cumsum([0] + self._widths).tolist()
        self.total_width = self._offsets[-1]
        # shared_embedding columns get one salt group
        groups: Dict[str, int] = {}
        self._salts = []
        for c in self.columns:
            g = c.categorical.shared_embedding or c.categorical.name
            self._salts.append(groups.setdefault(g, len(groups)))
        self._pool_groups = self._group_columns()

    def _group_columns(self) -> List[tuple]:
        """``(first row, width, combiner, [column names])`` per pooling
        launch: each run of adjacent width-1 columns is one launch over
        ``[n_columns*B, 1]`` bags (pooling one id is a copy whatever the
        combiner), each wider column one launch over ``[B, w]``."""
        out: List[tuple] = []
        for ci, col in enumerate(self.columns):
            o, w = self._offsets[ci], self._widths[ci]
            if w == 1 and out and out[-1][1] == 1:
                out[-1][3].append(col.name)
            else:
                out.append((o, w, "sum" if w == 1 else col.combiner,
                            [col.name]))
        return out

    def pack_ids_np(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        """int64 ``[total_width, B]`` with hash-bucket mod and salting
        applied, column by column (``deeprec_tpu`` ``pack_ids_np``)."""
        blocks = []
        for ci, col in enumerate(self.columns):
            cc = col.categorical
            raw = np.asarray(batch[cc.name], dtype=np.int64)
            if raw.ndim == 1:
                raw = raw[:, None]
            empty = raw == -1
            ids = raw
            if cc.hash_bucket_size:
                ids = np.where(empty, ids, ids % cc.hash_bucket_size)
            si = self._salts[ci]
            if si:
                c1 = np.int64((si * 0x9E3779B1) & 0x7FFFFFFF) << 32
                c2 = np.int64((si * 0x85EBCA77) & 0x7FFFFFFF)
                ids = np.where(empty, ids, ids ^ c1 ^ c2)
            blocks.append(ids.T)  # [w, B]
        return np.concatenate(blocks, axis=0)

    def pack_ids(self, batch: Dict[str, np.ndarray],
                 device="cuda") -> torch.Tensor:
        return torch.from_numpy(self.pack_ids_np(batch)).to(device)

    def readonly_rows(self, state: ev.EVState, cats: torch.Tensor):
        """``(aux, unique rows [U, dim])`` without mutation: the serving
        path. Unknown keys read their deterministic init row."""
        uniq = unique(cats.reshape(-1), self.config.max_unique)
        slots, found = ht.lookup(state.index, uniq.ukeys,
                                 self.config.max_probes)
        aux = CollectionAux(ev_aux=ev.LookupAux(
            uniq=uniq, slots=slots, admitted=found,
            created=torch.zeros_like(found)))
        rows = gather_rows(state.values, slots, self.config.embedding_dim)
        defaults = ev.init_rows(self.config, uniq.ukeys).to(rows.dtype)
        valid = ~K.is_empty(uniq.ukeys)
        rows = torch.where((found | ~valid)[:, None], rows, defaults)
        return aux, rows

    # -- trainer hooks (the Trainer never assumes a state type) ------------
    def gather_unique(self, values: torch.Tensor,
                      aux: CollectionAux) -> torch.Tensor:
        """``[U, dim]`` rows of the unique keys: the differentiable leaf."""
        return ev.gather(values, aux.ev_aux, self.config)

    def rows_for_training(self, state, aux: CollectionAux) -> torch.Tensor:
        return self.gather_unique(state.values, aux)

    def embeddings(self, urows: torch.Tensor,
                   aux: CollectionAux) -> Dict[str, torch.Tensor]:
        """Pooled per-column embeddings for training: ``name -> [B, dim]``.
        Validity comes from the slots (padding and overflow keys sit on the
        null row), so they add nothing and leave the mean denominators."""
        a = aux.ev_aux
        valid = (a.slots != self.config.capacity)[a.uniq.inverse]
        return self.embeddings_from_rows(urows, a.uniq.inverse, valid)

    def apply_gradients(self, state, opt, slot_state, aux: CollectionAux,
                        urow_grads: torch.Tensor, step: int,
                        urows: Optional[torch.Tensor] = None):
        """Sparse-apply the gradient of :meth:`gather_unique`'s output.
        ``urows`` are the effective current rows (required under lazy init:
        created rows update from their init, not from the store's zeros).
        Updates ``state.values`` in place; returns ``(state, slot_state)``."""
        a = aux.ev_aux
        if urows is None:
            urows = ev.gather(state.values, a, self.config)
        _, slot_state = opt.apply(state.values, slot_state, a.slots,
                                  urow_grads, a.admitted, step,
                                  cur_rows=urows, created=a.created)
        return state, slot_state

    def init_slot(self, opt, state):
        return opt.init(state.values)

    def embeddings_readonly(self, urows: torch.Tensor, aux: CollectionAux):
        """(pooled dict, sequence dict) for serving: every non-padding key
        pools, unknown ones with the default row ``readonly_rows`` gave
        them; EMPTY keys (padding, the ``max_unique`` overflow group) do
        not."""
        uniq = aux.ev_aux.uniq
        valid = (~K.is_empty(uniq.ukeys))[uniq.inverse]
        return self.embeddings_from_rows(urows, uniq.inverse, valid), {}

    def embeddings_from_rows(self, urows: torch.Tensor,
                             inverse: torch.Tensor,
                             valid: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Pool per column into ``name -> [B, dim]``: flat id ``i`` (layout
        ``[total_width, B]``) reads row ``urows[inverse[i]]`` when
        ``valid[i]``. One K2 launch per pooling group, differentiable with
        respect to ``urows``."""
        B = inverse.shape[0] // self.total_width
        inv = inverse.view(self.total_width, B)
        val = valid.view(self.total_width, B)
        out = {}
        for o, w, combiner, names in self._pool_groups:
            if w == 1:
                n = len(names)
                pooled = pooled_lookup(
                    urows, inv[o:o + n].reshape(n * B, 1),
                    val[o:o + n].reshape(n * B, 1), combiner)
                out.update(zip(names, pooled.view(n, B, -1)))
            else:
                out[names[0]] = pooled_lookup(
                    urows, inv[o:o + w].T, val[o:o + w].T, combiner)
        return out


def pack_dense(columns: Sequence[NumericColumn],
               batch: Dict[str, np.ndarray]) -> np.ndarray:
    """Raw numeric columns -> one float32 ``[B, D]`` numpy array
    (normalisation is :func:`normalize_dense`, on the device)."""
    parts = []
    for col in columns:
        x = np.asarray(batch[col.name], np.float32)
        if x.ndim == 1:
            x = x[:, None]
        parts.append(x)
    return np.concatenate(parts, axis=-1)


def normalize_dense(columns: Sequence[NumericColumn],
                    raw: torch.Tensor) -> torch.Tensor:
    """Per-column normalisation; column layout as :func:`pack_dense`."""
    mask = np.concatenate([np.full(col.shape, col.log_normalize, bool)
                           for col in columns])
    if not mask.any():
        return raw
    logged = torch.log1p(torch.clamp_min(raw, 0.0))
    return torch.where(torch.from_numpy(mask).to(raw.device)[None, :],
                       logged, raw)
