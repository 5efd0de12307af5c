"""DistributedHashTable: the second KV stack, row-sharded over the ranks.

Port of ``deeprec_tpu/parallel/hash_table.py`` (the reference's
``DistributedHashTable``, python/ops/hash_table/hash_table.py:388): each
rank holds one partition, a ``HashTable`` id allocator and its
``Tensible`` rows (``sparse/hash_table_api.py``), and a key goes to the
rank ``hash32(key, OWNER_SEED) % S``, the owner routing of the EV engine
(``parallel/sharded.py``). ``gen_ids`` sends each rank's deduplicated keys
with their multiplicities to their owners in one ``all_to_all`` (the
owner's admission counts occurrences over the global batch), allocates on
the owner and sends the ids back; the lookups also bring the owner's rows
back (kernel K1 reads them), and the gradient exchange is the rows-back
autograd function's reverse ``all_to_all``.

Id spaces are per rank, as the reference's per-partition spaces: a global
id is ``local_id * S + rank``, stable under growth. Every rank calls
every method together, each with its own keys; ``size``, ``health``,
``maybe_grow`` and ``snapshot`` are global (collectives). The JAX
package's ``_jit_cache`` bounded its compiled programs; an eager step has
none.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import CBFFilter, EmbeddingVariableConfig, Initializer
from ..ops.segment import segment_sum
from ..ops.unique import unique
from ..optim.sparse import _scatter_set
from ..sparse import embedding_var as ev
from ..sparse import hash_table_api as hta
from ..sparse import hashtable as ht
from ..sparse import keys as K
from . import multihost as mh
from .sharded import _route, _RowsBack, _send


class DHTState(NamedTuple):
    alloc: hta.HashTableState   # this rank's id allocator
    table: hta.Tensible         # this rank's rows [cap+1, dim]


class _Exchange(NamedTuple):
    """One lookup's routing: the requester side and the owner's dedup."""

    uniq: object           # dedup of the local keys
    owner: torch.Tensor    # [U] owner rank per local unique key
    pos: torch.Tensor      # [U] position in the owner's bucket
    routed: torch.Tensor   # [U] made it into a bucket
    ruq: object            # the owner's dedup of its received keys
    uids: torch.Tensor     # [R] the owner's local id per received key


class DistributedHashTable:
    """Row-sharded ``HashTable`` + ``TensibleVariable`` over the ranks of
    ``mesh`` (a ``multihost.Axis``), this rank's partition on
    ``mesh.device``. ``bucket_cap`` keys a rank sends each owner a lookup
    (the rest are dropped and read -1)."""

    def __init__(self, mesh, capacity_per_shard: int, dim: int,
                 initializer: Optional[Initializer] = None,
                 admit: Optional[CBFFilter] = None, max_probes: int = 32,
                 bucket_cap: int = 1024, max_unique: Optional[int] = None):
        self.mesh = self.axis = mesh
        self.S, self.rank = mesh.size, mesh.rank
        self.device = mesh.device
        self.cap = capacity_per_shard
        self.dim = dim
        self.initializer = initializer or Initializer("normal", scale=0.05)
        self.admit = admit
        self.max_probes = max_probes
        self.bucket_cap = bucket_cap
        self.max_unique = max_unique
        # the EV config view that derives a key's deterministic init row
        self._init_cfg = EmbeddingVariableConfig(
            name="dht", embedding_dim=dim, capacity=capacity_per_shard,
            initializer=self.initializer)

    # -- construction ----------------------------------------------------
    def init(self) -> DHTState:
        return DHTState(alloc=hta.create(self.cap, self.admit, self.device),
                        table=hta.tensible(self.cap, (self.dim,),
                                           device=self.device))

    def init_slot(self, opt, state: DHTState):
        """Slot Tensibles over the same id space (reference
        ``create_slot``, hash_table.py:524)."""
        return opt.init(state.table.rows)

    # -- the exchange ---------------------------------------------------------
    def _exchange(self, state: DHTState, keys: torch.Tensor):
        """Dedup the local keys, send them and their multiplicities to
        their owners, and allocate the received ones on this rank (fresh
        ids take their key's init row). Returns ``(state, exchange)``."""
        S, C = self.S, self.bucket_cap
        keys = keys.to(self.device).reshape(-1)
        uniq = unique(keys, self.max_unique)
        owner, pos, routed, dest = _route(uniq, S, C)
        recv = self.axis.all_to_all(
            _send(uniq.ukeys, dest, S * C, K.EMPTY).view(S, C)).view(-1)
        rcounts = self.axis.all_to_all(
            _send(uniq.counts.to(torch.int32), dest, S * C, 0).view(S, C)
        ).view(-1)
        ruq = unique(recv, self.max_unique)
        counts_u = segment_sum(rcounts, ruq.inverse, ruq.ukeys.shape[0])
        alloc, uids, created = hta.gen_ids_unique(
            state.alloc, ruq.ukeys, counts_u, self.admit, self.max_probes)
        table = hta.scatter(state.table,
                            torch.where(created & (uids >= 0), uids, -1),
                            ev.init_rows(self._init_cfg, ruq.ukeys))
        return DHTState(alloc=alloc, table=table), _Exchange(
            uniq=uniq, owner=owner, pos=pos, routed=routed, ruq=ruq,
            uids=uids)

    def _back(self, x, e: _Exchange):
        """Owner-side values per received lane (``[S*C, ...]``) back to
        the requesters, spread to local flat order (unrouted keys: 0).
        Differentiable in ``x`` (floating rows)."""
        S, C = self.S, self.bucket_cap
        if x.is_floating_point():
            back = _RowsBack.apply(x, self.axis, None)
        else:
            back = self.axis.all_to_all(x.view((S, C) + x.shape[1:]))
            back = back.view(x.shape)
        u_idx = torch.where(e.routed, e.owner * C + e.pos, 0)
        mask = e.routed.view((-1,) + (1,) * (x.dim() - 1))
        return torch.where(mask, back[u_idx], 0)[e.uniq.inverse]

    def gen_ids(self, state: DHTState, keys: torch.Tensor):
        """Global dense ids of this rank's ``keys``: allocated on the
        owner, -1 for padding, keys not admitted and dropped keys.
        Returns ``(state, ids [n] int32)``."""
        state, e = self._exchange(state, keys)
        gid = torch.where(e.uids >= 0, e.uids * self.S + self.rank, -1)
        ids = self._back((gid[e.ruq.inverse] + 1).to(torch.int32), e) - 1
        return state, ids

    def _lookup(self, state: DHTState, keys: torch.Tensor):
        """``(state, exchange, owner rows [S*C, dim] as a grad leaf, rows
        [n, dim], valid [n])``: the owner's rows through K1."""
        state, e = self._exchange(state, keys)
        urows = hta.gather(state.table, e.uids)[e.ruq.inverse]
        urows.requires_grad_(True)
        rows = self._back(urows, e)
        ok = (e.uids >= 0)[e.ruq.inverse].to(torch.int32)
        valid = self._back(ok, e) > 0
        return state, e, urows, rows, valid

    def _owner_grads(self, e: _Exchange, urows, rows, cotangent):
        """The cotangent of ``rows`` summed onto the owner's unique keys
        (the reverse ``all_to_all`` runs inside ``backward``)."""
        rows.backward(cotangent.to(rows).reshape(rows.shape))
        return segment_sum(urows.grad, e.ruq.inverse, e.ruq.ukeys.shape[0])

    def lookup_and_grads(self, state: DHTState, keys: torch.Tensor,
                         cotangent: torch.Tensor):
        """Rows in key order and the table-row cotangent of a supplied
        output cotangent: ``(state, rows [n, dim], valid [n], d_rows
        [cap+1, dim])``, ``d_rows`` this rank's partition's (the gradient
        exchange of the backward pass, summed over requesters)."""
        state, e, urows, rows, valid = self._lookup(state, keys)
        g = self._owner_grads(e, urows, rows, cotangent)
        d_rows = torch.zeros_like(state.table.rows)
        dest = torch.where(e.uids >= 0, e.uids, self.cap + 1)
        d_rows = torch.cat([d_rows, d_rows[:1]]).index_add_(
            0, dest.long(), g)[:self.cap + 1]
        return state, rows.detach(), valid, d_rows

    def apply_cotangent(self, state: DHTState, opt, slot_state,
                        keys: torch.Tensor, cotangent: torch.Tensor,
                        step: int):
        """The full training update: lookup, then the owner applies the
        summed cotangent of its keys (``TensibleVariableApply*``). Returns
        ``(state, slot_state, rows, valid)``."""
        state, e, urows, rows, valid = self._lookup(state, keys)
        g = self._owner_grads(e, urows, rows, cotangent)
        table, slot_state = hta.apply_sparse(state.table, opt, slot_state,
                                             e.uids, g, step)
        return state._replace(table=table), slot_state, rows.detach(), valid

    # -- global views (collectives: every rank calls them) --------------------
    def _counters(self, state: DHTState):
        mine = torch.stack([state.alloc.next_id.long(),
                            state.alloc.index.overflow.sum().long()])
        return self.axis.all_gather(mine[None]).cpu().numpy()

    def size(self, state: DHTState) -> int:
        return int(self._counters(state)[:, 0].sum())

    def health(self, state: DHTState) -> dict:
        """Allocator fill, index overflow (keys whose insert failed read
        id -1, like keys not admitted) and the per-shard skew."""
        c = self._counters(state)
        return {"size": int(c[:, 0].sum()), "capacity_per_shard": self.cap,
                "shards": self.S, "load_factor": int(c[:, 0].max()) / self.cap,
                "overflow": int(c[:, 1].sum()),
                "max_shard_size": int(c[:, 0].max())}

    def maybe_grow(self, state: DHTState, threshold: float = 0.7
                   ) -> DHTState:
        """Rebuild every partition at twice the capacity when the fullest
        passes ``threshold`` (or an insert failed): keys re-insert, ids
        and rows stay."""
        h = self.health(state)
        if h["load_factor"] < threshold and h["overflow"] == 0:
            return state
        new_cap = self.cap * 2
        a = state.alloc
        fresh = hta.create(new_cap, None, self.device)
        index, slots, _ = ht.lookup_or_insert_(fresh.index, a.index.keys,
                                               self.max_probes)
        ids = hta._set_ids(fresh.ids, slots, slots < new_cap, a.ids)
        self.cap = new_cap
        self._init_cfg = dataclasses.replace(self._init_cfg,
                                             capacity=new_cap)
        return DHTState(alloc=hta.HashTableState(index=index, ids=ids,
                                                 next_id=a.next_id,
                                                 cbf=a.cbf),
                        table=hta.grow(state.table, new_cap))

    def snapshot(self, state: DHTState):
        """``(keys int64 [n], global ids [n])`` of every partition, in
        rank order."""
        keys = state.alloc.index.keys.cpu().numpy()
        live = keys != K.EMPTY
        gid = state.alloc.ids.cpu().numpy()[live].astype(np.int64) \
            * self.S + self.rank
        pair = np.stack([keys[live], gid], axis=1)
        both = mh.allgather_varlen(pair, self.axis)
        return both[:, 0], both[:, 1].astype(np.int32)

    # -- reshard-safe checkpoints ----------------------------------------------
    def checkpoint_arrays(self, state: DHTState) -> dict:
        """This rank's part of a save: its live keys and their rows, and
        its CBF block (``cbf__shardNNN`` beside ``cbf_shards`` on a mesh).
        Ids are partition internals and re-allocate at restore
        (``HashTableDirectRestoreOp``). Concatenate every rank's keys and
        values, and keep every block, for :meth:`restore_arrays`."""
        a = state.alloc
        keys = a.index.keys.cpu().numpy()
        ids = a.ids.cpu().numpy()
        live = (keys != K.EMPTY) & (ids >= 0)
        out = {"keys": keys[live],
               "values": state.table.rows[torch.from_numpy(
                   ids[live].astype(np.int64)).to(self.device)].cpu().numpy()}
        if a.cbf is not None:
            out["cbf_shards"] = np.asarray(self.S, np.int32)
            name = "cbf" if self.S == 1 else f"cbf__shard{self.rank:03d}"
            out[name] = a.cbf.cpu().numpy()
        return out

    def restore_arrays(self, arrays: dict) -> DHTState:
        """This rank's partition from a whole save (any shard count): the
        keys the owner hash routes here re-insert, ids re-allocate in scan
        order, the capacity doubles until the fullest partition fits at
        load 0.7."""
        from ..checkpoint.saver import route_to_shards
        n_max = int(np.ceil(arrays["keys"].shape[0] / self.S)) + 8
        while n_max > 0.7 * self.cap:
            self.cap *= 2
        self._init_cfg = dataclasses.replace(self._init_cfg,
                                             capacity=self.cap)
        part = route_to_shards(arrays, self.S)[self.rank]
        st = self.init()
        keys = torch.as_tensor(part["keys"], dtype=torch.int64).to(
            self.device)
        index, ids_plane, next_id, live, new_ids = hta.reinsert(
            st.alloc, keys, self.max_probes)
        cbf = st.alloc.cbf
        if cbf is not None and "cbf" in part \
                and tuple(part["cbf"].shape) == tuple(cbf.shape):
            cbf = torch.as_tensor(part["cbf"]).to(cbf)
        _scatter_set(st.table.rows, torch.where(live, new_ids, self.cap + 1),
                     torch.as_tensor(part["values"]).to(st.table.rows))
        return DHTState(alloc=hta.HashTableState(index=index, ids=ids_plane,
                                                 next_id=next_id, cbf=cbf),
                        table=st.table)
