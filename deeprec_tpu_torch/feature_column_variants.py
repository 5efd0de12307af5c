"""Variant embedding collections: multi-hash, adaptive, hash-table and
dynamic-dimension.

Port of ``deeprec_tpu/feature_column_variants.py``:
each class subclasses :class:`~.feature_column.EmbeddingCollection` and
overrides the trainer hooks (``init``, ``init_slot``, ``lookup_or_create``,
``rows_for_training``, ``embeddings``, ``sequence_embeddings``,
``apply_gradients``, ``readonly_rows``), the fence hooks (``needs_growth``,
``grow_state``, ``load_factor``, ``index_view``/``table_index``) and the
checkpoint hooks (``ckpt_arrays``/``ckpt_restore``), so the port's
``Trainer`` and ``CheckpointManager`` run them unchanged, and the
``sharded_*`` hooks of ``parallel.ShardedTrainer``:

* multi-hash: the sub-tables are replicated on every rank; the lookup is
  local and the update all-gathers every rank's ids and cotangents and
  applies the one global update on each (replicas stay bit-identical);
* adaptive: the EV half rides the owner exchange (the owner seeds a key's
  row from its static bucket when it crosses the admission threshold);
  the static table is replicated, its gradient summed over the ranks;
* hash table: the owner exchange, ids allocated in each rank's own id
  space; whether the owner admitted a key returns beside its row;
* dynamic dimension: the owner exchange, the block mask applied where the
  frequencies live (the owner).

Their saves are the JAX package's, both ways, at any shard count (a
multi-rank save writes one part per rank; a restore routes the rows by
the owner hash):

* multi-hash: ``__dense__`` and ``leaf__NNNN`` arrays, the sub-tables
  ``[size_i, sub_dim]`` and then the optimizer's slot leaves, in the JAX
  flatten order; the last save wins;
* adaptive: the EV half in the 4-array format, the static table and its
  slot leaves as ``static__table`` / ``static__slotNNNN``;
* hash table: ``__ht__``, the live keys, their rows and ``slot__`` rows and
  the CBF; ids re-allocate at restore;
* dynamic dimension: a plain EV table.

Pooling goes through kernel K2 (``embeddings_from_rows``) straight from
the rows each hook returns, through ``inverse`` (adaptive, hash table) or
``arange(n)`` (multi-hash, whose rows are per flat id already), so no
``[n, dim]`` expansion is built; the rows come through K1.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .config import CBFFilter
from .feature_column import CollectionAux, EmbeddingCollection
from .ops.gather import gather_rows
from .ops.unique import unique
from .sparse import adaptive as ad
from .sparse import dynamicdim as dd_mod
from .sparse import embedding_var as ev
from .sparse import hash_table_api as hta
from .sparse import hashtable as ht_mod
from .sparse import keys as K
from .sparse import multihash as mh
from .utils.tree import leaves_with_paths, map_leaves


class FlatAux(NamedTuple):
    """Aux for table types without a hash index: the flat id batch."""

    flat: torch.Tensor
    valid: torch.Tensor


def _from_leaves(template, leaves):
    """``template``'s tree with its leaves replaced, in flatten order, by
    ``leaves`` (numpy or tensors), each on its template leaf's device and
    in its dtype."""
    it = iter(leaves)
    return map_leaves(lambda _, leaf: torch.as_tensor(next(it)).to(
        leaf.device, leaf.dtype), template)


class _DenseCkptMixin:
    """Checkpoint hooks for a collection whose state is a fixed-size dense
    tree (no per-key hash index): the whole tree is saved each time as
    ``leaf__NNNN`` arrays in the JAX flatten order, and the last save wins
    at restore. The collection gives the state's leaves in their JAX
    shapes (:meth:`dense_state_leaves`) and rebuilds a state from them
    (:meth:`dense_state_from`). On a mesh the state is replicated, so the
    save is the same at every shard count."""

    def ckpt_arrays(self, bundle, num_shards, since, evict, global_step,
                    shard: int = 0):
        leaves = self.dense_state_leaves(bundle.ev) + [
            leaf for _, leaf in leaves_with_paths(bundle.slot)]
        arrays = {"__dense__": np.asarray(1, np.int32)}
        for i, leaf in enumerate(leaves):
            arrays[f"leaf__{i:04d}"] = leaf.detach().cpu().numpy()
        return arrays

    def ckpt_restore(self, trainer, template, parts, num_shards):
        last = parts[-1]  # replicated: every rank's part is the same
        n_state = len(self.dense_state_leaves(template.ev))
        n = n_state + len(leaves_with_paths(template.slot))
        leaves = [last[f"leaf__{i:04d}"] for i in range(n)]
        return template._replace(
            ev=self.dense_state_from(template.ev, leaves[:n_state]),
            slot=_from_leaves(template.slot, leaves[n_state:]))


class MultiHashCollection(_DenseCkptMixin, EmbeddingCollection):
    """Coalesced columns over a compositional Q-R multi-hash table: O(Q+R)
    rows serve the whole id space; no dynamic index, no growth."""

    def __init__(self, columns, name: str = "mh",
                 table_sizes: Tuple[int, ...] = (1 << 16, 1 << 12),
                 combiner_op: str = "add", initializer_scale: float = 0.05,
                 **kwargs):
        super().__init__(columns, name=name, **kwargs)
        self.mh_config = mh.MultiHashConfig(
            name=name, embedding_dim=self.dim, table_sizes=table_sizes,
            combiner=combiner_op, initializer_scale=initializer_scale)

    # -- trainer hooks -----------------------------------------------------
    def init(self, device="cuda"):
        return mh.create(self.mh_config, device=device)

    def init_slot(self, opt, state):
        return mh.init_slots(state, opt)

    def lookup_or_create(self, state, batch, step):
        flat = self._flatten_ids(batch, state.tables[0].device)
        return state, CollectionAux(ev_aux=FlatAux(
            flat=flat, valid=~K.is_empty(flat)))

    def rows_for_training(self, state, aux):
        return mh.lookup(state, self.mh_config, aux.ev_aux.flat)

    def _flat_inverse(self, aux):
        flat = aux.ev_aux.flat
        return torch.arange(flat.shape[0], device=flat.device)

    def embeddings(self, urows, aux):
        return self.embeddings_from_rows(urows, self._flat_inverse(aux),
                                         aux.ev_aux.valid)

    def sequence_embeddings(self, urows, aux):
        if not self._seq_groups:
            return {}
        return self.sequence_embeddings_from_rows(
            urows, self._flat_inverse(aux), aux.ev_aux.valid)

    def embeddings_readonly(self, urows, aux):
        return (self.embeddings(urows, aux),
                self.sequence_embeddings(urows, aux))

    def apply_gradients(self, state, opt, slot_state, aux, urow_grads,
                        step, urows=None):
        return mh.apply_gradients(state, self.mh_config, opt, slot_state,
                                  aux.ev_aux.flat, urow_grads, step)

    def readonly_rows(self, state, cats):
        _, aux = self.lookup_or_create(state, cats, 0)
        return aux, self.rows_for_training(state, aux)

    def needs_growth(self, state):
        return False

    def load_factor(self, state):
        return 0.0

    # -- sharded hooks: replicated sub-tables, all-gathered update ----------
    def sharded_init_local(self, opt, device="cuda"):
        from .train.trainer import TableBundle
        st = self.init(device)  # drawn from the config's seed: replicas agree
        return TableBundle(ev=st, slot=self.init_slot(opt, st), health=None)

    def sharded_lookup_or_create(self, state, ids2d, step, axis, bucket_cap):
        return self.lookup_or_create(state, ids2d, step)

    def sharded_health(self, health, aux):
        return health

    def sharded_rows(self, state, aux):
        return self.rows_for_training(state, aux)

    def sharded_rows_back(self, urows, aux, axis, bucket_cap):
        return urows, self._flat_inverse(aux), aux.ev_aux.valid

    def sharded_apply_gradients(self, state, opt, slot_state, aux, d_urows,
                                step, axis, num_shards):
        """Every rank's ids and cotangents, all-gathered, and the one
        global-batch update applied on each rank."""
        return mh.apply_gradients(state, self.mh_config, opt, slot_state,
                                  axis.all_gather(aux.ev_aux.flat),
                                  axis.all_gather(d_urows), step)

    def sharded_readonly(self, state, ids2d, axis, bucket_cap):
        aux, rows = self.readonly_rows(state, ids2d)
        return rows, self._flat_inverse(aux), aux.ev_aux.valid

    # -- checkpoint: the sub-tables in their JAX shapes ---------------------
    def dense_state_leaves(self, state):
        return [t[:-1] for t in state.tables]

    def dense_state_from(self, template, leaves):
        tables = []
        for t, leaf in zip(template.tables, leaves):
            new = torch.zeros_like(t)
            new[:-1] = torch.as_tensor(leaf).to(t.device, t.dtype)
            tables.append(new)
        return template._replace(tables=tuple(tables))


class AdaptiveCollection(EmbeddingCollection):
    """Adaptive embedding: a shared static hash-bucket table serves the
    cold tail, exact EV rows serve admitted (hot) keys, with warm row
    migration at admission. Requires a CounterFilter on the config."""

    def __init__(self, columns, name: str = "adaptive",
                 buckets: int = 1 << 14, **kwargs):
        super().__init__(columns, name=name, **kwargs)
        if self.config.counter_filter is None:
            raise ValueError("AdaptiveCollection requires counter_filter=")
        self.buckets = buckets

    def init(self, device="cuda"):
        return ad.create(self.config, self.buckets, device=device)

    def init_slot(self, opt, state):
        return {"ev": opt.init(state.ev.values),
                "static": opt.init(state.static)}

    def lookup_or_create(self, state, batch, step):
        flat = self._flatten_ids(batch, state.static.device)
        state, aux = ad.lookup_or_create(state, self.config, flat, step)
        return state, CollectionAux(ev_aux=aux)

    def rows_for_training(self, state, aux):
        return ad.gather_from(state.ev.values, state.static, self.config,
                              aux.ev_aux)

    def _valid_flat(self, aux):
        # tail keys are valid too: they read their static bucket
        uniq = aux.ev_aux.uniq
        return (~K.is_empty(uniq.ukeys))[uniq.inverse]

    def embeddings(self, urows, aux):
        return self.embeddings_from_rows(urows, aux.ev_aux.uniq.inverse,
                                         self._valid_flat(aux))

    def sequence_embeddings(self, urows, aux):
        if not self._seq_groups:
            return {}
        return self.sequence_embeddings_from_rows(
            urows, aux.ev_aux.uniq.inverse, self._valid_flat(aux))

    def apply_gradients(self, state, opt, slot_state, aux, urow_grads,
                        step, urows=None):
        state, ev_slot, st_slot = ad.apply_gradients(
            state, self.config, opt, slot_state["ev"], opt,
            slot_state["static"], aux.ev_aux, urow_grads, step)
        return state, {"ev": ev_slot, "static": st_slot}

    def readonly_rows(self, state, cats):
        uniq = unique(self._flatten_ids(cats, state.static.device),
                      self.config.max_unique)
        slots, found = ht_mod.lookup(state.ev.index, uniq.ukeys,
                                     self.config.max_probes)
        admitted = found & (state.ev.freqs[slots] >=
                            self.config.counter_filter.filter_freq)
        aux = ev.LookupAux(uniq=uniq, slots=slots, admitted=admitted,
                           created=torch.zeros_like(found))
        rows = ad.gather_from(state.ev.values, state.static, self.config, aux)
        return CollectionAux(ev_aux=aux), rows

    def needs_growth(self, state):
        return (float(ev.load_factor(state.ev)) >= 0.7
                or int(state.ev.index.overflow.sum()) > 0)

    def load_factor(self, state):
        return float(ev.load_factor(state.ev))

    def grow_state(self, state, slot_state, opt=None):
        from .optim.sparse import permute_slot_state
        new_cap = self.config.capacity * 2
        new_ev, perm = ev.grow(state.ev, self.config, new_cap)
        ev_slot = permute_slot_state(slot_state["ev"], perm, new_cap,
                                     fills=opt.fills if opt else None)
        self.config = dataclasses.replace(self.config, capacity=new_cap)
        return state._replace(ev=new_ev), {"ev": ev_slot,
                                           "static": slot_state["static"]}

    def index_view(self, state):
        return state.ev

    def table_index(self, state):
        return state.ev.index

    # -- sharded hooks: the EV half rides the owner exchange; the static
    #    table is replicated, its dense gradient summed over the ranks
    def sharded_init_local(self, opt, device="cuda"):
        from .train.trainer import TableBundle
        st = self.init(device)  # the static table's draw is seeded
        return TableBundle(ev=st, slot=self.init_slot(opt, st),
                           health=torch.zeros((3,), dtype=torch.int32,
                                              device=device))

    def sharded_owner_lookup(self, state, uniq, step, freq_counts):
        """The owner's EV lookup, and the warm seeding of a key that
        crosses the admission threshold (counted over every requester)
        from its static bucket."""
        from .optim.sparse import _scatter_set
        ev_state, aux = ev.lookup_or_create_unique(
            state.ev, self.config, uniq, step, freq_counts=freq_counts)
        b = ad.bucket_of(uniq.ukeys, state.static.shape[0] - 1)
        if self.config.counter_filter is not None:
            prev = ev_state.freqs[aux.slots] - freq_counts
            newly = aux.admitted & (
                prev < self.config.counter_filter.filter_freq)
        else:
            newly = aux.created
        dest = torch.where(newly, aux.slots, self.config.capacity + 1)
        _scatter_set(ev_state.values, dest,
                     state.static[b].to(ev_state.values.dtype))
        return state._replace(ev=ev_state), aux

    def sharded_rows(self, state, aux):
        return ad.gather_from(state.ev.values, state.static, self.config,
                              aux.recv_aux)[aux.recv_uniq.inverse]

    def owner_readonly_rows(self, state, slots, found, keys):
        thr = (self.config.counter_filter.filter_freq
               if self.config.counter_filter is not None else 0)
        admitted = found & (state.ev.freqs[slots] >= thr)
        b = ad.bucket_of(keys, state.static.shape[0] - 1)
        ev_rows = gather_rows(state.ev.values, slots, self.config.embedding_dim)
        return torch.where(admitted[:, None], ev_rows,
                           state.static[b].to(ev_rows.dtype))

    def sharded_apply_gradients(self, state, opt, slot_state, aux, d_urows,
                                step, axis, num_shards):
        """Admitted keys: the owner's EV apply. Tail keys: their summed
        bucket gradients, dense over the static table, summed over the
        ranks, and the same apply on every rank."""
        from .ops.segment import segment_sum
        from .ops.unique import unique_int32
        a = aux.recv_aux
        gu = segment_sum(d_urows, aux.recv_uniq.inverse,
                         aux.recv_uniq.ukeys.shape[0])
        cur = ev.gather(state.ev.values, a, self.config)
        _, ev_slot = opt.apply(state.ev.values, slot_state["ev"], a.slots,
                               gu, a.admitted, step, cur_rows=cur,
                               created=a.created)
        buckets = state.static.shape[0] - 1
        tail = ~a.admitted & ~K.is_empty(a.uniq.ukeys)
        b = torch.where(tail, ad.bucket_of(a.uniq.ukeys, buckets), buckets)
        ub, inv, _ = unique_int32(b)
        gb = segment_sum(torch.where(tail[:, None], gu, 0.0), inv,
                         ub.shape[0])
        dest = torch.where(ub < buckets, ub, buckets + 1).long()
        dense = torch.zeros((buckets + 2,) + tuple(state.static.shape[1:]),
                            dtype=state.static.dtype,
                            device=state.static.device)
        dense.index_add_(0, dest, gb.to(dense.dtype))
        touched = torch.zeros((buckets + 2,), dtype=torch.int32,
                              device=dense.device)
        touched[dest] = 1
        dense = axis.psum(dense[:buckets + 1])
        touched = axis.psum(touched[:buckets + 1]) > 0
        _, st_slot = opt.apply(state.static, slot_state["static"],
                               torch.arange(buckets + 1,
                                            device=dense.device),
                               dense, touched, step)
        return state, {"ev": ev_slot, "static": st_slot}

    def sharded_grow_local(self, bundle, new_cap, fills):
        from .optim.sparse import permute_slot_state
        new_ev, perm = ev.grow(bundle.ev.ev, self.config, new_cap)
        ev_slot = permute_slot_state(bundle.slot["ev"], perm, new_cap,
                                     fills=fills)
        return bundle._replace(ev=bundle.ev._replace(ev=new_ev),
                               slot={"ev": ev_slot,
                                     "static": bundle.slot["static"]})

    # -- checkpoint: the EV half in the 4-array format; the static half as
    #    dense leaves, last save wins
    def ckpt_arrays(self, bundle, num_shards, since, evict, global_step,
                    shard: int = 0):
        from .checkpoint.saver import table_snapshot_host
        out = table_snapshot_host(self.config, bundle.ev.ev,
                                  bundle.slot["ev"], num_shards=num_shards,
                                  since_step=since, evict=evict,
                                  global_step=global_step, shard=shard)
        out["static__table"] = bundle.ev.static.cpu().numpy()
        for i, (_, leaf) in enumerate(leaves_with_paths(
                bundle.slot["static"])):
            out[f"static__slot{i:04d}"] = leaf.cpu().numpy()
        return out

    def ckpt_restore(self, trainer, template, parts, num_shards):
        """The EV half routed to this shard (every shard of a trainer with
        ``S`` ranks takes ``ceil(n / S) + 8`` rows' capacity), the static
        half from the newest save."""
        from .checkpoint import saver as SV
        S, rank = getattr(trainer, "S", 1), getattr(trainer, "rank", 0)
        name = next(n for n, c in trainer.collections.items() if c is self)
        opt = trainer.sparse_optimizers[name]
        ev_parts = [{k: v for k, v in p.items()
                     if not k.startswith("static__")} for p in parts]
        n_max = sum(p["keys"].shape[0] for p in ev_parts)
        cap = SV.needed_capacity(int(np.ceil(n_max / S)) + 8,
                                 self.config.capacity)
        if cap != self.config.capacity:
            self.config = dataclasses.replace(self.config, capacity=cap)
            trainer.rejit()
        st = ev.create(self.config, template.ev.static.device)
        slot = opt.init(st.values)
        for p in ev_parts:
            st, slot = SV._scatter_train_table(
                st, slot, self.config, SV.route_to_shards(p, S)[rank])
        last = parts[-1]
        static = torch.as_tensor(last["static__table"]).to(
            template.ev.static.device, template.ev.static.dtype)
        n_st = len(leaves_with_paths(template.slot["static"]))
        st_slot = _from_leaves(template.slot["static"],
                               [last[f"static__slot{i:04d}"]
                                for i in range(n_st)])
        return template._replace(ev=ad.AdaptiveState(ev=st, static=static),
                                 slot={"ev": slot, "static": st_slot})


class HTState(NamedTuple):
    """Hash-table collection state: id allocator + row store."""

    alloc: hta.HashTableState
    table: hta.Tensible


class HTAux(NamedTuple):
    uniq: object                # UniqueResult over the flat keys
    uids: torch.Tensor          # [U] dense id per unique key (-1 invalid)
    created: torch.Tensor       # [U] allocated this step


class HashTableCollection(EmbeddingCollection):
    """``hash_table_column``: embedding lookup backed by the second KV
    stack (a dense-id-allocating HashTable and a TensibleVariable row
    store) instead of an EmbeddingVariable. Ids are allocated densely in
    admission order; slot variables are Tensibles over the same id space;
    admission is a counting-Bloom gate on id allocation (``admit``)."""

    def __init__(self, columns, name: str = "ht",
                 admit: Optional[CBFFilter] = None, **kwargs):
        super().__init__(columns, name=name, **kwargs)
        self.admit = admit
        if admit is not None and self.config.track_freq is None:
            self.config = dataclasses.replace(self.config, track_freq=True)

    # -- trainer hooks -----------------------------------------------------
    def init(self, device="cuda"):
        cap = self.config.capacity
        return HTState(alloc=hta.create(cap, self.admit, device),
                       table=hta.tensible(cap, (self.dim,), device=device))

    def init_slot(self, opt, state):
        return opt.init(state.table.rows)

    def lookup_or_create(self, state, batch, step):
        uniq = unique(self._flatten_ids(batch, state.table.rows.device),
                      self.config.max_unique)
        alloc, uids, created = hta.gen_ids_unique(
            state.alloc, uniq.ukeys, uniq.counts, self.admit,
            self.config.max_probes)
        # freshly allocated ids take their key's deterministic init row
        init_ids = torch.where(created & (uids >= 0), uids, -1)
        table = hta.scatter(state.table, init_ids,
                            ev.init_rows(self.config, uniq.ukeys))
        return (HTState(alloc=alloc, table=table),
                CollectionAux(ev_aux=HTAux(uniq=uniq, uids=uids,
                                           created=created)))

    def rows_for_training(self, state, aux):
        return hta.gather(state.table, aux.ev_aux.uids)

    def _valid_flat(self, aux):
        a = aux.ev_aux
        return (a.uids >= 0)[a.uniq.inverse]

    def embeddings(self, urows, aux):
        return self.embeddings_from_rows(urows, aux.ev_aux.uniq.inverse,
                                         self._valid_flat(aux))

    def sequence_embeddings(self, urows, aux):
        if not self._seq_groups:
            return {}
        return self.sequence_embeddings_from_rows(
            urows, aux.ev_aux.uniq.inverse, self._valid_flat(aux))

    def apply_gradients(self, state, opt, slot_state, aux, urow_grads,
                        step, urows=None):
        table, slot_state = hta.apply_sparse(
            state.table, opt, slot_state, aux.ev_aux.uids, urow_grads, step)
        return state._replace(table=table), slot_state

    def readonly_rows(self, state, cats):
        uniq = unique(self._flatten_ids(cats, state.table.rows.device),
                      self.config.max_unique)
        uids = hta.lookup(state.alloc, uniq.ukeys, self.config.max_probes)
        aux = CollectionAux(ev_aux=HTAux(
            uniq=uniq, uids=uids, created=torch.zeros_like(uids,
                                                           dtype=torch.bool)))
        rows = hta.gather(state.table, uids)
        # unknown keys read their deterministic would-be init (EV parity)
        init = ev.init_rows(self.config, uniq.ukeys).to(rows.dtype)
        return aux, torch.where((uids >= 0)[:, None], rows, init)

    # -- growth (ids are stable: a copy and an index rebuild); these read
    #    the allocator on the host, so call them at fences only
    def needs_growth(self, state):
        return (int(state.alloc.next_id) >= 0.7 * self.config.capacity
                or int(state.alloc.index.overflow.sum()) > 0)

    def grow_state(self, state, slot_state, opt=None):
        new_cap = self.config.capacity * 2
        state, slot_state = self._grown(state, slot_state, new_cap,
                                        opt.fills if opt else None)
        self.config = dataclasses.replace(self.config, capacity=new_cap)
        return state, slot_state

    def _grown(self, state, slot_state, new_cap: int, fills):
        """``(state, slot_state)`` at ``new_cap`` rows: the live keys
        re-inserted into a fresh index with their ids, the row stores and
        slot rows extended (vacated slot rows take ``fills``)."""
        cap = self.config.capacity
        fresh = hta.create(new_cap, None, state.table.rows.device)
        index, slots, _ = ht_mod.lookup_or_insert_(
            fresh.index, state.alloc.index.keys, self.config.max_probes)
        ids_plane = hta._set_ids(fresh.ids, slots, slots < new_cap,
                                 state.alloc.ids)
        alloc = hta.HashTableState(index=index, ids=ids_plane,
                                   next_id=state.alloc.next_id,
                                   cbf=state.alloc.cbf)
        table = hta.grow(state.table, new_cap)
        fill_vals = ([leaf for _, leaf in leaves_with_paths(fills)]
                     if fills is not None else None)
        leaf_no = itertools.count()

        def grow_leaf(_, leaf):
            fill = fill_vals[next(leaf_no)] if fill_vals is not None else 0.0
            if leaf.dim() >= 1 and leaf.shape[0] == cap + 1:
                rows = torch.full((new_cap + 1,) + tuple(leaf.shape[1:]),
                                  fill, dtype=leaf.dtype, device=leaf.device)
                rows[:cap] = leaf[:-1]
                return rows
            return leaf
        return (HTState(alloc=alloc, table=table),
                map_leaves(grow_leaf, slot_state))

    def load_factor(self, state):
        return int(state.alloc.next_id) / self.config.capacity

    def index_view(self, state):
        return state.alloc  # has .index with its size/overflow counters

    def table_index(self, state):
        return state.alloc.index

    # -- sharded hooks: the owner exchange, ids in each rank's own space
    #    (the reference's DistributedHashTable partitions); only rows and
    #    the owner's admission verdict travel back
    def sharded_init_local(self, opt, device="cuda"):
        from .train.trainer import TableBundle
        st = self.init(device)
        return TableBundle(ev=st, slot=self.init_slot(opt, st),
                           health=torch.zeros((3,), dtype=torch.int32,
                                              device=device))

    def sharded_owner_lookup(self, state, uniq, step, freq_counts):
        alloc, uids, created = hta.gen_ids_unique(
            state.alloc, uniq.ukeys, freq_counts, self.admit,
            self.config.max_probes)
        table = hta.scatter(state.table,
                            torch.where(created & (uids >= 0), uids, -1),
                            ev.init_rows(self.config, uniq.ukeys))
        return (HTState(alloc=alloc, table=table),
                HTAux(uniq=uniq, uids=uids, created=created))

    def sharded_rows(self, state, aux):
        return hta.gather(state.table,
                          aux.recv_aux.uids)[aux.recv_uniq.inverse]

    def sharded_rows_back(self, urows, aux, axis, bucket_cap):
        """The rows back as usual; a key's validity also takes the owner's
        admission verdict (id -1), returned over one more int plane: the
        one-device ``uids >= 0`` mask."""
        row_u, inv, valid = super().sharded_rows_back(urows, aux, axis,
                                                      bucket_cap)
        vflag = (aux.recv_aux.uids >= 0).to(
            torch.int32)[aux.recv_uniq.inverse]
        back = axis.all_to_all(vflag.view(axis.size, bucket_cap)).view(-1)
        u_idx = torch.where(aux.routed, aux.owner * bucket_cap + aux.pos, 0)
        v_u = (back[u_idx] > 0) & aux.routed
        return row_u, inv, valid & v_u[inv]

    def sharded_apply_gradients(self, state, opt, slot_state, aux, d_urows,
                                step, axis, num_shards):
        from .ops.segment import segment_sum
        grads_u = segment_sum(d_urows, aux.recv_uniq.inverse,
                              aux.recv_uniq.ukeys.shape[0])
        table, slot_state = hta.apply_sparse(state.table, opt, slot_state,
                                             aux.recv_aux.uids, grads_u,
                                             step)
        return state._replace(table=table), slot_state

    def owner_readonly_rows(self, state, slots, found, keys):
        cap = self.config.capacity
        uids = torch.where(found, state.alloc.ids[slots.clamp(max=cap - 1)],
                           -1)
        rows = hta.gather(state.table, uids)
        init = ev.init_rows(self.config, keys).to(rows.dtype)
        return torch.where((uids >= 0)[:, None], rows, init)

    def sharded_grow_local(self, bundle, new_cap, fills):
        st, slot = self._grown(bundle.ev, bundle.slot, new_cap, fills)
        return bundle._replace(ev=st, slot=slot)

    # -- checkpoint: per-key {key, row, slot rows}; ids are internal and are
    #    re-allocated at restore
    def ckpt_arrays(self, bundle, num_shards, since, evict, global_step,
                    shard: int = 0):
        """This shard's live keys, rows and slot rows, and its CBF (one
        block ``cbf__shardNNN`` of ``num_shards`` on a mesh)."""
        from .checkpoint.saver import _rows
        from .checkpoint import format as F
        cap1 = self.config.capacity + 1
        st = bundle.ev
        keys = st.alloc.index.keys.cpu().numpy()
        ids = st.alloc.ids.cpu().numpy()
        uid = ids[(keys != K.EMPTY) & (ids >= 0)].astype(np.int64)
        out = {"__ht__": np.asarray(1, np.int32),
               "keys": keys[(keys != K.EMPTY) & (ids >= 0)],
               "values": _rows(st.table.rows, uid)}
        for nm, leaf in F.slot_leaf_names(bundle.slot):
            if leaf.dim() >= 1 and leaf.shape[0] == cap1:
                out[f"slot__{nm}"] = _rows(leaf, uid)
        if st.alloc.cbf is not None:
            out["cbf_shards"] = np.asarray(num_shards, np.int32)
            key = "cbf" if num_shards == 1 else f"cbf__shard{shard:03d}"
            out[key] = st.alloc.cbf.cpu().numpy()
        return out

    def _restore_one_shard(self, arrays, opt, device):
        """A fresh state and slot state from compacted rows: keys
        re-insert, dense ids re-allocate in scan order."""
        from .checkpoint import format as F
        from .optim.sparse import _scatter_set
        cap = self.config.capacity
        st = self.init(device)
        slot = opt.init(st.table.rows)
        keys = torch.as_tensor(arrays["keys"], dtype=torch.int64).to(device)
        index, ids_plane, next_id, live, new_ids = hta.reinsert(
            st.alloc, keys, self.config.max_probes)
        cbf = st.alloc.cbf
        if cbf is not None and "cbf" in arrays \
                and tuple(arrays["cbf"].shape) == tuple(cbf.shape):
            cbf = torch.as_tensor(arrays["cbf"]).to(cbf)
        alloc = hta.HashTableState(index=index, ids=ids_plane,
                                   next_id=next_id, cbf=cbf)
        row_dest = torch.where(live, new_ids, cap + 1)
        _scatter_set(st.table.rows, row_dest,
                     torch.as_tensor(arrays["values"]).to(device))
        for nm, leaf in F.slot_leaf_names(slot):
            rk = f"slot__{nm}"
            if rk in arrays:
                _scatter_set(leaf, row_dest,
                             torch.as_tensor(arrays[rk]).to(device))
        return HTState(alloc=alloc, table=st.table), slot

    def ckpt_restore(self, trainer, template, parts, num_shards):
        """The merged parts (the newest row of a key wins) routed to this
        shard of the trainer's ``S``; ids re-allocate."""
        from .checkpoint import saver as SV
        S, rank = getattr(trainer, "S", 1), getattr(trainer, "rank", 0)
        name = next(n for n, c in trainer.collections.items() if c is self)
        opt = trainer.sparse_optimizers[name]
        # merge the parts, the newest occurrence of a key winning; the CBF
        # sketch rides whole from the newest part
        sel = SV.last_wins_sel(np.concatenate([p["keys"] for p in parts]))
        merged = {k: np.concatenate([p[k] for p in parts])[sel]
                  for k in parts[0]
                  if k != "__ht__" and not k.startswith("cbf")}
        merged.update({k: v for k, v in parts[-1].items()
                       if k.startswith("cbf")})
        cap = SV.needed_capacity(
            int(np.ceil(merged["keys"].shape[0] / S)) + 8,
            self.config.capacity)
        if cap != self.config.capacity:
            self.config = dataclasses.replace(self.config, capacity=cap)
            trainer.rejit()
        st, slot = self._restore_one_shard(SV.route_to_shards(merged, S)[rank],
                                           opt, template.ev.table.rows.device)
        return template._replace(ev=st, slot=slot)


class DynamicDimCollection(EmbeddingCollection):
    """Frequency-adaptive row width: columns see ``block_num*block_dim``
    wide embeddings with inactive blocks zeroed (and not trained). The
    state is a plain EV table, so growth, health and checkpoints are the
    base collection's."""

    def __init__(self, columns, name: str = "dyndim",
                 dynamic_dim: dd_mod.DynamicDimConfig = None, **kwargs):
        super().__init__(columns, name=name, **kwargs)
        if dynamic_dim is None or dynamic_dim.full_dim != self.dim:
            raise ValueError("dynamic_dim.full_dim must equal the column dim")
        self.dd = dynamic_dim
        if self.config.track_freq is None:
            # block widths gate on freq: the light layout must not drop it
            self.config = dataclasses.replace(self.config, track_freq=True)

    def rows_for_training(self, state, aux):
        return dd_mod.gather(state, self.dd, aux.ev_aux, self.config)

    def apply_gradients(self, state, opt, slot_state, aux, urow_grads,
                        step, urows=None):
        # re-mask: inactive blocks take no update even though the model
        # gave cotangents for the zeroed inputs; the update starts from the
        # unmasked effective rows, which the base recomputes (urows=None)
        mask = dd_mod.block_mask(self.dd, state.freqs[aux.ev_aux.slots])
        return super().apply_gradients(state, opt, slot_state, aux,
                                       urow_grads * mask, step, urows=None)

    def readonly_rows(self, state, cats):
        aux, rows = super().readonly_rows(state, cats)
        return aux, rows * dd_mod.block_mask(
            self.dd, state.freqs[aux.ev_aux.slots])

    # -- sharded hooks: the owner exchange; the block mask applies on the
    #    owner, where the frequencies are counted over every requester
    def sharded_rows(self, state, aux):
        a = aux.recv_aux
        rows = ev.gather(state.values, a, self.config)
        rows = rows * dd_mod.block_mask(self.dd, state.freqs[a.slots])
        return rows[aux.recv_uniq.inverse]

    def sharded_apply_gradients(self, state, opt, slot_state, aux, d_urows,
                                step, axis, num_shards):
        # the masked rows already zero the inactive blocks' cotangents;
        # re-mask as the JAX engine does
        a = aux.recv_aux
        mask = dd_mod.block_mask(self.dd, state.freqs[a.slots])
        return super().sharded_apply_gradients(
            state, opt, slot_state, aux, d_urows * mask[aux.recv_uniq.inverse],
            step, axis, num_shards)

    def owner_readonly_rows(self, state, slots, found, keys):
        rows = super().owner_readonly_rows(state, slots, found, keys)
        return rows * dd_mod.block_mask(self.dd, state.freqs[slots])
