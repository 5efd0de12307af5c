"""Feature columns and the coalesced embedding collection.

Port of ``deeprec_tpu/feature_column.py``: the column dataclasses,
``pack_dense``/``normalize_dense``, and :class:`EmbeddingCollection`, the
device-index table: its state (``init``), the packing of raw batches
(``pack_ids_np``, ``pack_ids``, ``transform_raw_keys``, and
``_flatten_ids`` for a raw dict on the device), ``lookup_or_create``
(column-parallel dedup ``unique_cols`` exactly where the JAX package
takes it: a ``[W, B]`` block of width-1 columns with distinct salt
groups; the flat ``unique`` otherwise), the trainer hooks
(``gather_unique``, ``rows_for_training``, ``embeddings``,
``sequence_embeddings``, ``apply_gradients``, ``init_slot``), the serving
half (``readonly_rows``, ``embeddings_readonly``,
``embeddings_from_rows``, ``sequence_embeddings_from_rows``), the fence
hooks (``load_factor``, ``needs_growth``, ``grow_state``, ``index_view``)
and the checkpoint hooks (``ckpt_arrays`` through
``checkpoint.saver.table_snapshot_host``; ``ckpt_restore`` returns None,
which hands the restore to the saver's generic EV flow), and the
``sharded_*`` hooks that ``parallel.trainer.ShardedTrainer`` and
``serving.ShardedPredictor`` drive (``parallel/sharded.py``: the owner
exchange). The JAX package's ``sharded_*_spec`` and
``sharded_slot_example`` hooks are ``shard_map`` plumbing and have no
counterpart: each rank holds its own shard.

Layout: a collection packs its columns' ids into one feature-major
``[total_width, B]`` int64 block, each column's ids salted with its column
group so coalesced columns never share rows. ``readonly_rows`` dedups the
flat block, probes the hash index and fetches the unique rows with kernel
K1; ``embeddings_readonly`` and ``embeddings`` pool them per column with
kernel K2 straight through ``inverse``, so the ``[total_width*B, dim]``
expanded rows are never materialised. Pooling is differentiable with
respect to the unique rows (K2's backward kernel), which is how training
gets its sparse gradient.

Sequence columns (DIN's and DIEN's behaviour histories) are expanded, not
pooled: ``name -> ([B, L, dim], mask [B, L])``. The JAX package gathers
``urows[inverse]`` there; the port sends each run of adjacent sequence
columns through K2 as one launch over ``[n_columns*B*L, 1]`` one-id bags
(``sum``: pooling one id is a copy, and a padded id gives zeros), so the
histories take K2 and K2's backward in both directions. The JAX package
reads the null row at a padded position, which no training write reaches,
so it is zeros there too.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .config import EmbeddingVariableConfig, Initializer
from .ops.fused_lookup import pooled_lookup
from .ops.gather import gather_rows
from .ops.unique import unique, unique_cols
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
    """Unpooled: emits [B, L, dim] and a validity mask."""

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
        # column-parallel dedup needs every key confined to one row of the
        # [W, B] layout: width-1 columns with pairwise-distinct salt groups
        self._column_dedup_ok = (
            all(w == 1 for w in self._widths)
            and len(set(self._salts)) == len(self._salts))
        self._pool_groups = self._group_columns(False)
        self._seq_groups = self._group_columns(True)

    # -- state ---------------------------------------------------------
    def init(self, device="cuda") -> ev.EVState:
        return ev.create(self.config, device)

    def _group_columns(self, sequence: bool) -> List[tuple]:
        """``(first row, width, combiner, [column names])`` per K2 launch.
        Pooled columns: each run of adjacent width-1 columns is one launch
        over ``[n_columns*B, 1]`` bags (pooling one id is a copy whatever
        the combiner), each wider column one launch over ``[B, w]``.
        Sequence columns: each run of adjacent ones of one width is one
        launch of one-id ``sum`` bags."""
        out: List[tuple] = []
        for ci, col in enumerate(self.columns):
            if isinstance(col, SequenceEmbeddingColumn) != sequence:
                continue
            o, w = self._offsets[ci], self._widths[ci]
            prev = out[-1] if out else None
            if prev is not None and (w == 1 or sequence) and prev[1] == w \
                    and prev[0] + w * len(prev[3]) == o:
                prev[3].append(col.name)
            else:
                out.append((o, w, "sum" if w == 1 or sequence
                            else col.combiner, [col.name]))
        return out

    def transform_raw_keys(self, column_name: str,
                           raw: np.ndarray) -> np.ndarray:
        """One column's raw ids in this table's key space (hash-bucket mod
        and the column group's salt), as :meth:`pack_ids_np` maps a batch.
        Checkpoint migration keys a per-column reference table this way."""
        for ci, col in enumerate(self.columns):
            if col.categorical.name == column_name:
                return self._keys_np(ci, np.asarray(raw, np.int64))
        raise KeyError(f"no column {column_name!r} in collection "
                       f"{self.config.name!r}")

    def _keys_np(self, ci: int, ids: np.ndarray) -> np.ndarray:
        cc = self.columns[ci].categorical
        empty = ids == -1
        if cc.hash_bucket_size:
            ids = np.where(empty, ids, ids % cc.hash_bucket_size)
        si = self._salts[ci]
        if si:
            ids = np.where(empty, ids, ids ^ _salt_mask(si))
        return ids

    def pack_ids_np(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        """int64 ``[total_width, B]`` with hash-bucket mod and salting
        applied, column by column (``deeprec_tpu`` ``pack_ids_np``)."""
        blocks = []
        for ci, col in enumerate(self.columns):
            raw = np.asarray(batch[col.categorical.name], dtype=np.int64)
            if raw.ndim == 1:
                raw = raw[:, None]
            blocks.append(self._keys_np(ci, raw).T)  # [w, B]
        return np.concatenate(blocks, axis=0)

    def _flatten_ids(self, batch, device) -> torch.Tensor:
        """The flat feature-major int64 keys of ``batch`` on ``device``: a
        packed tensor flattened, or a raw per-column dict (numpy arrays or
        tensors) mapped as :meth:`pack_ids_np` maps it, in torch."""
        if isinstance(batch, torch.Tensor):
            return batch.to(device).reshape(-1)
        parts = []
        for ci, col in enumerate(self.columns):
            cc = col.categorical
            ids = torch.as_tensor(batch[cc.name]).to(device, torch.int64)
            if ids.dim() == 1:
                ids = ids[:, None]
            empty = K.is_empty(ids)
            if cc.hash_bucket_size:
                ids = torch.where(empty, ids,
                                  torch.remainder(ids, cc.hash_bucket_size))
            ids = _salt(ids, self._salts[ci])
            parts.append(ids.T.reshape(-1))  # [w, B], feature-major
        return torch.cat(parts)

    def lookup_or_create(self, state: ev.EVState, batch, step: int):
        """Find or create the batch's keys. ``batch``: a packed ``[W, B]``
        tensor (:meth:`pack_ids`), a flat one, or a raw per-column dict.
        A ``[W, B]`` block of width-1 columns with distinct salt groups
        dedups column by column (``unique_cols``), anything else through
        the flat ``unique``; both give the JAX package's order. Returns
        ``(state, aux)``, the stores updated in place."""
        dev = state.values.device
        if isinstance(batch, torch.Tensor) and batch.dim() == 2 \
                and self._column_dedup_ok:
            uniq = unique_cols(batch.to(dev), self.config.max_unique)
            state, aux = ev.lookup_or_create_unique(state, self.config,
                                                    uniq, step)
        else:
            state, aux = ev.lookup_or_create(
                state, self.config, self._flatten_ids(batch, dev), step)
        return state, CollectionAux(ev_aux=aux)

    def pack_ids(self, batch: Dict[str, np.ndarray],
                 device="cuda") -> torch.Tensor:
        return torch.from_numpy(self.pack_ids_np(batch)).to(device)

    def readonly_rows(self, state: ev.EVState, cats):
        """``(aux, unique rows [U, dim])`` without mutation: the eval and
        serving path (``cats``: packed ids or a raw per-column dict).
        Unknown keys read their deterministic init row."""
        uniq = unique(self._flatten_ids(cats, state.values.device),
                      self.config.max_unique)
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

    def _train_valid(self, aux: CollectionAux) -> torch.Tensor:
        """Validity of each flat id in training: padding and overflow keys
        sit on the null row."""
        a = aux.ev_aux
        return (a.slots != self.config.capacity)[a.uniq.inverse]

    def embeddings(self, urows: torch.Tensor,
                   aux: CollectionAux) -> Dict[str, torch.Tensor]:
        """Pooled per-column embeddings for training: ``name -> [B, dim]``.
        Invalid ids (:meth:`_train_valid`) add nothing and leave the mean
        denominators."""
        return self.embeddings_from_rows(urows, aux.ev_aux.uniq.inverse,
                                         self._train_valid(aux))

    def sequence_embeddings(self, urows: torch.Tensor, aux: CollectionAux):
        """``name -> ([B, L, dim], mask [B, L])`` for training, the mask
        ``slots != capacity``. A collection without sequence columns
        launches nothing here."""
        if not self._seq_groups:
            return {}
        return self.sequence_embeddings_from_rows(
            urows, aux.ev_aux.uniq.inverse, self._train_valid(aux))

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

    # -- fence hooks (growth, health) ----------------------------------
    def load_factor(self, state) -> float:
        return float(ev.load_factor(state)) if hasattr(state, "index") \
            else 0.0

    def needs_growth(self, state) -> bool:
        """At 0.7 load, or once an insert has failed (index overflow)."""
        return (self.load_factor(state) >= 0.7
                or int(state.index.overflow.sum()) > 0)

    def grow_state(self, state, slot_state, opt=None):
        """Double the capacity: every live key is rebuilt into the new
        index and the stores and optimizer slot rows follow it (vacated
        slot rows take the optimizer's ``fills``). Returns ``(state,
        slot_state)`` and moves ``self.config`` to the new capacity."""
        from .optim.sparse import permute_slot_state
        new_cap = self.config.capacity * 2
        new_state, perm = ev.grow(state, self.config, new_cap)
        slot_state = permute_slot_state(slot_state, perm, new_cap,
                                        fills=opt.fills if opt else None)
        self.config = dataclasses.replace(self.config, capacity=new_cap)
        return new_state, slot_state

    def index_view(self, state):
        """The EVState that growth and health watch, or None for a table
        without a device index."""
        return state if isinstance(state, ev.EVState) else None

    # -- checkpoint hooks (checkpoint.saver.CheckpointManager) -----------
    def ckpt_arrays(self, bundle, num_shards: int, since: Optional[int],
                    evict: bool, global_step: Optional[int], shard: int = 0):
        """The 4-array compacted format and the slot rows
        (``checkpoint.saver.table_snapshot_host``) of the table, or of this
        rank's ``shard`` of ``num_shards``."""
        from .checkpoint.saver import table_snapshot_host
        return table_snapshot_host(self.config, bundle.ev, bundle.slot,
                                   num_shards=num_shards, since_step=since,
                                   evict=evict, global_step=global_step,
                                   shard=shard)

    def ckpt_restore(self, trainer, template, parts, num_shards: int):
        """None: the saver's generic EV flow restores this table."""
        return None

    # -- sharded hooks (parallel.trainer.ShardedTrainer) -----------------
    # Each rank holds one row shard of the table; a step runs the owner
    # exchange of parallel/sharded.py. Variant collections override the
    # subset that differs.

    def sharded_pack(self, batch: Dict[str, np.ndarray], num_shards: int,
                     rank: int) -> np.ndarray:
        """This rank's ``[W, B/S]`` slice of the packed global batch: the
        examples ``[rank*B/S, (rank+1)*B/S)``, the JAX ``P(None, axis)``
        split."""
        ids = self.pack_ids_np(batch)
        b = ids.shape[1] // num_shards
        return np.ascontiguousarray(ids[:, rank * b:(rank + 1) * b])

    def sharded_init_local(self, opt, device="cuda"):
        """This rank's fresh shard at the full capacity, its optimizer
        state and its health counters."""
        from .train.trainer import TableBundle
        st = ev.create(self.config, device)
        return TableBundle(ev=st, slot=self.init_slot(opt, st),
                           health=torch.zeros((3,), dtype=torch.int32,
                                              device=device))

    def sharded_lookup_or_create(self, state, ids2d, step, axis, bucket_cap):
        """Lookup-or-create of this rank's ``[W, B_local]`` ids over the
        mesh; ``state`` is this rank's shard. Returns ``(state, aux)``."""
        from .parallel import sharded
        return sharded.exchange_lookup_or_create(self, state, ids2d, step,
                                                 axis, bucket_cap)

    def table_index(self, state):
        """The hash index the owner's read-only lookup probes."""
        return state.index

    def sharded_owner_lookup(self, state, uniq, step, freq_counts):
        """Owner-side lookup-or-create of the received (deduped) keys."""
        return ev.lookup_or_create_unique(state, self.config, uniq, step,
                                          freq_counts=freq_counts)

    def owner_readonly_rows(self, state, slots, found, keys):
        """Owner-side eval rows of received keys through K1; unknown keys
        read their deterministic init row."""
        rows = gather_rows(state.values, slots, self.config.embedding_dim)
        defaults = ev.init_rows(self.config, keys).to(rows.dtype)
        valid = ~K.is_empty(keys)
        return torch.where((found | ~valid)[:, None], rows, defaults)

    def sharded_rows(self, state, aux):
        """The differentiable leaf of the sharded lookup: the owner's rows
        per received lane, ``[S*C, dim]``."""
        from .parallel import sharded
        return sharded.gather_owner_rows(state.values, aux, self.config)

    def sharded_rows_back(self, urows, aux, axis, bucket_cap):
        """``(row_u [U, dim], inverse [N_local], valid_flat [N_local])`` for
        :meth:`embeddings_from_rows`; differentiable in ``urows`` (the
        reverse exchange in ``config.exchange_dtype``)."""
        from .parallel import sharded
        row_u, valid_u = sharded.rows_back(
            urows, aux, axis, bucket_cap,
            wire_dtype=self.config.exchange_dtype)
        inv = aux.local_uniq.inverse
        return row_u, inv, valid_u[inv]

    def sharded_apply_gradients(self, state, opt, slot_state, aux, d_urows,
                                step, axis, num_shards):
        """Owner-side sparse apply of :meth:`sharded_rows`' cotangent."""
        from .parallel import sharded
        return sharded.apply_gradients_sharded(self, state, opt, slot_state,
                                               aux, d_urows, step)

    def sharded_readonly(self, state, ids2d, axis, bucket_cap):
        """The eval exchange: ``(row_u, inverse, valid_flat)``, nothing
        mutated."""
        from .parallel import sharded
        return sharded.exchange_lookup_readonly(
            self, state, ids2d, axis, bucket_cap,
            wire_dtype=self.config.exchange_dtype)

    def sharded_health(self, health, aux):
        """This rank's health counters after one exchange: bucket drops,
        steps whose local or owner dedup saturated, the unique high-water
        mark of either."""
        if health is None:
            return None
        ov_l, ov_r = aux.local_uniq.n_overflow, aux.recv_uniq.n_overflow
        nu = torch.maximum(aux.local_uniq.n_unique + ov_l,
                           aux.recv_uniq.n_unique + ov_r).to(torch.int32)
        sat = ((ov_l > 0) | (ov_r > 0)).to(torch.int32)
        return torch.stack([health[0] + aux.n_dropped, health[1] + sat,
                            torch.maximum(health[2], nu)])

    def sharded_grow_local(self, bundle, new_cap, fills):
        """This rank's shard rebuilt at ``new_cap`` slots, the optimizer's
        slot rows permuted along (vacated rows take ``fills``)."""
        from .optim.sparse import permute_slot_state
        new_ev, perm = ev.grow(bundle.ev, self.config, new_cap)
        slot = permute_slot_state(bundle.slot, perm, new_cap, fills=fills)
        return bundle._replace(ev=new_ev, slot=slot)

    def embeddings_readonly(self, urows: torch.Tensor, aux: CollectionAux):
        """(pooled dict, sequence dict) for serving: every non-padding key
        counts, unknown ones with the default row ``readonly_rows`` gave
        them; EMPTY keys (padding, the ``max_unique`` overflow group) do
        not, and are masked out of the sequences."""
        uniq = aux.ev_aux.uniq
        valid = (~K.is_empty(uniq.ukeys))[uniq.inverse]
        return (self.embeddings_from_rows(urows, uniq.inverse, valid),
                self.sequence_embeddings_from_rows(urows, uniq.inverse,
                                                   valid))

    def embeddings_from_rows(self, urows: torch.Tensor,
                             inverse: torch.Tensor,
                             valid: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Pool per column into ``name -> [B, dim]``: flat id ``i`` (layout
        ``[total_width, B]``) reads row ``urows[inverse[i]]`` when
        ``valid[i]``. One K2 launch per pooling group, differentiable with
        respect to ``urows``. Sequence columns are left to
        :meth:`sequence_embeddings_from_rows`."""
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

    def sequence_embeddings_from_rows(self, urows: torch.Tensor,
                                      inverse: torch.Tensor,
                                      valid: torch.Tensor):
        """Expand per sequence column into ``name -> ([B, L, dim], mask
        [B, L])``: position ``l`` of example ``b`` reads row
        ``urows[inverse[i]]`` (``i`` its flat id) where ``valid[i]``, and
        zeros elsewhere. One K2 launch of one-id bags per group of
        adjacent columns, the ids ordered ``[column, B, L]`` so each
        column's rows come out contiguous; differentiable with respect to
        ``urows``."""
        B = inverse.shape[0] // self.total_width
        inv = inverse.view(self.total_width, B)
        val = valid.view(self.total_width, B)
        out = {}
        for o, w, _, names in self._seq_groups:
            n = len(names)
            ids = inv[o:o + n * w].view(n, w, B).transpose(1, 2)
            mask = val[o:o + n * w].view(n, w, B).transpose(1, 2)
            mask = mask.contiguous()
            rows = pooled_lookup(urows, ids.reshape(-1, 1),
                                 mask.view(-1, 1), "sum")
            out.update(zip(names, zip(rows.view(n, B, w, -1), mask)))
        return out


def _salt_mask(column_group: int) -> int:
    """The XOR mask of a salt group: ``c1`` on the high word, ``c2`` on
    the low (the JAX package's ``_salt`` on its two planes)."""
    c1 = (column_group * 0x9E3779B1) & 0x7FFFFFFF
    c2 = (column_group * 0x85EBCA77) & 0x7FFFFFFF
    return (c1 << 32) | c2


def _salt(ids: torch.Tensor, column_group: int) -> torch.Tensor:
    """Mix the column group into the keys so coalesced columns never
    share rows; EMPTY stays EMPTY."""
    if column_group == 0:
        return ids
    return torch.where(K.is_empty(ids), ids, ids ^ _salt_mask(column_group))


def dense_features(columns: Sequence[NumericColumn], batch: Dict[str, Any],
                   device="cuda") -> torch.Tensor:
    """Concatenate numeric columns -> ``[B, sum(shape)]`` float32 on
    ``device``, ``log1p(max(x, 0))`` where a column has ``log_normalize``
    (the training paths split this into :func:`pack_dense` on the host and
    :func:`normalize_dense` on the device)."""
    parts = []
    for col in columns:
        x = torch.as_tensor(batch[col.name], dtype=torch.float32,
                            device=device)
        if x.dim() == 1:
            x = x[:, None]
        if col.log_normalize:
            x = torch.log1p(torch.clamp_min(x, 0.0))
        parts.append(x)
    return torch.cat(parts, dim=-1)


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
    """Per-column normalisation; column layout as :func:`pack_dense`. The
    ``log_normalize`` mask is built once per column list and device and
    kept there, so a call copies nothing to the device."""
    mask = _log_mask(tuple(columns), raw.device)
    if mask is None:
        return raw
    logged = torch.log1p(torch.clamp_min(raw, 0.0))
    return torch.where(mask, logged, raw)


@functools.lru_cache(maxsize=64)
def _log_mask(columns: tuple, device: torch.device):
    """``[1, D]`` bool of the ``log_normalize`` columns on ``device``, or
    None when no column takes the log."""
    mask = np.concatenate([np.full(col.shape, col.log_normalize, bool)
                           for col in columns])
    if not mask.any():
        return None
    return torch.from_numpy(mask).to(device)[None, :]
