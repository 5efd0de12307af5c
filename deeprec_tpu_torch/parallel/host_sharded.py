"""Host-sharded embedding: the host-index engine on the mesh.

Port of ``deeprec_tpu/parallel/host_sharded.py`` for one rank per process
(the JAX package's multi-process layout, one shard per process). The
host resolves the whole sharded lookup one step ahead of the device:

1. every rank deduplicates its own ``[W, B/S]`` batch slice with a
   ``row_capacity=0`` resolver (every key stays pending: only the
   batch-local lanes and inverse are used);
2. it routes each unique key to its owner, ``hash32(key, OWNER_SEED=13) %
   S`` (the device-index engine's and the checkpoint's routing), into
   ``[S, C]`` buckets of at most ``C`` keys, with their multiplicities;
3. the buckets for the other ranks cross the host bucket exchange
   (``host_exchange.HostBucketExchange``, TCP beside the device group);
4. the rank resolves its own shard's receive set, the requesters in rank
   order, with its shard resolver (``self._resolver``): slots, created
   flags and the owner-side multiplicities.

Everything lands in ONE int32 wire per rank and step (:class:`HostShardedWire`).
The device step then only gathers the owner's rows at the host-assigned
slots (kernel K1, created rows reading their lazy init), runs the rows
``all_to_all`` (the port's ``Axis``), unbuckets, pools (kernel K2), runs
backward (K2's backward and the reverse ``all_to_all``), segment-sums onto
the owner lanes and applies the optimizer; the owner's version, frequency
and admission bookkeeping is kernel K3a (``lookup_meta``) under the
metadata layout. No ids cross the device group.

The peer blocks of the exchange are indexed by the shard ranges every rank
reports when the mesh forms (``multihost.shard_ranges``); a layout other
than one shard per rank in rank order raises there. (The JAX package
assumed peer process q owned shards ``[q·SL, (q+1)·SL)`` without
checking.)

Saves are the 4-array format routed by the same owner hash, one part per
rank, so they restore into either engine at any shard count. Tiered
storage is refused, as in the JAX package; so is a CBF filter (the JAX
shard resolvers never apply it).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..checkpoint.saver import last_wins_sel, needed_capacity
from ..feature_column import CollectionAux
from ..host_index import HostEVState, HostIndexEmbeddingCollection, ResolvedIds
from ..ops.gather import gather_rows
from ..ops.segment import segment_sum
from ..optim.sparse import permute_slot_state
from ..sparse import embedding_var as ev
from ..sparse import keys as K
from ..utils.native import HostIndexResolver
from . import multihost
from .sharded import _bucket_positions, _RowsBack, owner_of_np


class HostShardedWire:
    """One rank's resolved exchange: one int32 tensor, one copy per step.
    Layout::

        [inv_local (Nl) | u_idx (Uc) | key hi (Ur) | key lo (Ur) |
         uslots (Ur) | counts | created<<30 (Ur) | inv_recv (S*C) |
         n_dropped, owner n_overflow, readonly, 0]

    ``u_idx[u] = owner*C + pos`` of local unique ``u`` in the rows-back
    exchange, -1 for EMPTY or dropped keys."""

    __slots__ = ("buf", "n_local", "u_cap", "ur", "sc", "bucket_cap")

    def __init__(self, buf: torch.Tensor, n_local: int, u_cap: int, ur: int,
                 sc: int, bucket_cap: int):
        self.buf = buf
        self.n_local, self.u_cap, self.ur = int(n_local), int(u_cap), int(ur)
        self.sc, self.bucket_cap = int(sc), int(bucket_cap)

    def tensors(self):
        return [self.buf]

    def to(self, device, non_blocking: bool = False) -> "HostShardedWire":
        return HostShardedWire(self.buf.to(device, non_blocking=non_blocking),
                               self.n_local, self.u_cap, self.ur, self.sc,
                               self.bucket_cap)

    def decode(self):
        """``(inv_local, u_idx, owner ResolvedIds, n_dropped, owner
        n_overflow)`` on the buffer's device."""
        b = self.buf
        Nl, Uc, Ur, SC = self.n_local, self.u_cap, self.ur, self.sc
        o = 0
        inv_local = b[o:o + Nl]; o += Nl
        u_idx = b[o:o + Uc]; o += Uc
        hi = b[o:o + Ur].long(); o += Ur
        lo = b[o:o + Ur].long(); o += Ur
        uslots = b[o:o + Ur]; o += Ur
        pc = b[o:o + Ur]; o += Ur
        inv_recv = b[o:o + SC].long(); o += SC
        tail = b[o:o + 4]
        owner = ResolvedIds(
            ukeys=(hi << 32) | (lo & 0xFFFFFFFF), uslots=uslots,
            inverse=inv_recv, created=((pc >> 30) & 1) == 1,
            counts=pc & ((1 << 30) - 1),
            n_unique=(pc > 0).sum(dtype=torch.int32), n_overflow=tail[1],
            readonly=tail[2] == 1)
        return inv_local, u_idx, owner, tail[0], tail[1]


class HSAux(NamedTuple):
    """One rank's aux of a host-sharded exchange."""

    owner_aux: CollectionAux   # owner-side lookup aux (received lanes)
    inv_local: torch.Tensor    # [Nl] flat position -> local unique
    u_idx: torch.Tensor        # [Uc] signed rows-back lane (-1: none)
    n_dropped: torch.Tensor    # int32: this rank's keys over a bucket cap
    sat: torch.Tensor          # int32: the owner's keys over max_unique


class HostShardedCollection(HostIndexEmbeddingCollection):
    """The host-index collection of a ``ShardedTrainer``: this rank's
    resolver (``self._resolver``) owns its shard of the keys; a second
    resolver deduplicates the rank's requests. Bind it to the mesh
    (:meth:`bind_mesh`, which the trainer calls) before the first
    resolve."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self._tiered:
            raise NotImplementedError(
                "tiered storage on the host-sharded engine: use the one-card "
                "HostIndexEmbeddingCollection (tiering rides its resolve "
                "wire) or TieredShardedTrainer with the device-index "
                "EmbeddingCollection on a mesh")
        if self.config.cbf_filter is not None:
            raise NotImplementedError(
                "CBF admission on the host-sharded engine (its owner "
                "resolvers would count requesting ranks, not occurrences): "
                "use CounterFilter, or the device-index mesh engine")
        # the requester dedup takes the shard resolver's implementation:
        # the two order their lanes alike only at one group
        self._dedup = HostIndexResolver(
            n_groups=self._resolver.n_groups,
            use_native=self._resolver._h is not None)
        self._axis = None
        self._S = None
        self._ranges = None
        self._hx = None          # the host bucket exchange (S > 1)
        self._hs_dropped = 0     # global, from every rank's frame
        self._hs_sat = 0         # steps where some rank's dedup saturated

    # -- the mesh ------------------------------------------------------------
    def bind_mesh(self, axis) -> None:
        """Form the engine on ``axis``: check every rank's shard range and
        open the host exchange (every rank calls it together). A second
        call on a mesh of another size raises."""
        if self._S not in (None, axis.size):
            raise ValueError(f"mesh size changed {self._S} -> {axis.size}")
        if self._axis is not None:
            return
        self._S = axis.size
        self._ranges = multihost.shard_ranges(axis)
        self._axis = axis
        if axis.size > 1:
            from .host_exchange import HostBucketExchange
            # soft one-step-ahead deadline: past 50 ms of host exchange the
            # resolve no longer hides under a device step; counted, the
            # step still completes
            self._hx = HostBucketExchange(axis, tag=f"hs-{self.config.name}",
                                          deadline_ms=50.0)

    # -- host side -------------------------------------------------------------
    def sharded_resolve(self, ids: np.ndarray, bucket_cap: int,
                        train: bool = True, pin: bool = False
                        ) -> HostShardedWire:
        """The whole exchange of this rank's ``[W, B/S]`` ids, resolved on
        the host (one host exchange when S > 1). Train resolves mutate the
        shard's index: every rank calls this in step order."""
        if self._axis is None:
            raise RuntimeError("bind_mesh(axis) before the first resolve")
        S, me = self._S, self._axis.rank
        ids = np.ascontiguousarray(ids, np.int64).reshape(-1)
        Nl = ids.shape[0]
        cfg = self.config
        cap = cfg.capacity
        Uc = cfg.max_unique + 1 if cfg.max_unique else Nl + 1
        Ur = Uc
        C = int(bucket_cap)
        SC = S * C

        uk, _, inv, _, ct, _, nov = self._dedup.resolve(ids, Uc, 0, 0)
        sat = int(nov > 0)
        valid = uk != K.EMPTY
        own = owner_of_np(uk, S)  # EMPTY -> S
        pos = _bucket_positions(torch.from_numpy(own)).numpy()
        routed = valid & (own < S) & (pos < C)
        dropped = int((valid & (own < S) & (pos >= C)).sum())
        send_keys = np.full((S, C), K.EMPTY, np.int64)
        send_counts = np.zeros((S, C), np.int32)
        send_keys[own[routed], pos[routed]] = uk[routed]
        send_counts[own[routed], pos[routed]] = ct[routed]
        u_idx = np.where(routed, own * C + pos, -1).astype(np.int32)

        # the receive set of this shard: [S requesters, C], rank order
        lo, hi = self._ranges[me]
        recv_keys = np.full((S, C), K.EMPTY, np.int64)
        recv_counts = np.zeros((S, C), np.int32)
        recv_keys[me] = send_keys[lo:hi].reshape(C)
        recv_counts[me] = send_counts[lo:hi].reshape(C)
        g_dropped, g_sat = dropped, sat
        if self._hx is not None:
            stats = np.asarray([dropped, sat], np.int64).tobytes()
            blobs = []
            for q in range(S):
                qlo, qhi = self._ranges[q]
                blobs.append(b"" if q == me else
                             send_keys[qlo:qhi].tobytes()
                             + send_counts[qlo:qhi].tobytes() + stats)
            nk = C * 8
            for q, blob in enumerate(self._hx.all_to_all(blobs)):
                if q == me:
                    continue
                recv_keys[q] = np.frombuffer(blob[:nk], np.int64)
                recv_counts[q] = np.frombuffer(blob[nk:nk + 4 * C], np.int32)
                qd, qs = np.frombuffer(blob[nk + 4 * C:], np.int64)
                g_dropped += int(qd)
                g_sat = max(g_sat, int(qs))

        ruk, rus, rinv, rcr, _, _, rnov = self._resolver.resolve(
            recv_keys.reshape(-1), Ur, cap, cap, readonly=not train)
        # owner multiplicities: the requesters' counts summed per lane
        # (the reference's AddFreq(count))
        freq = np.bincount(rinv, weights=recv_counts.reshape(-1),
                           minlength=Ur)[:Ur].astype(np.int32)
        if train:
            self._hs_dropped += g_dropped
            self._hs_sat += g_sat

        wire = torch.empty((Nl + Uc + 4 * Ur + SC + 4,), dtype=torch.int32,
                           pin_memory=pin)
        w = wire.numpy()
        o = 0
        w[o:o + Nl] = inv; o += Nl
        w[o:o + Uc] = u_idx; o += Uc
        w[o:o + Ur] = (ruk >> 32).astype(np.int32); o += Ur
        w[o:o + Ur] = (ruk & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
        o += Ur
        w[o:o + Ur] = rus; o += Ur
        w[o:o + Ur] = freq | (rcr.astype(np.int32) << 30); o += Ur
        w[o:o + SC] = rinv; o += SC
        w[o:o + 4] = (dropped, rnov, 0 if train else 1, 0)
        return HostShardedWire(wire, Nl, Uc, Ur, SC, C)

    # -- device side -------------------------------------------------------------
    def sharded_init_local(self, opt, device="cuda"):
        """This rank's fresh row stores and optimizer state; resets the
        shard's resolvers."""
        from ..train.trainer import TableBundle
        st = self.init(device)
        self._dedup.reset()
        return TableBundle(ev=st, slot=self.init_slot(opt, st),
                           health=torch.zeros((3,), dtype=torch.int32,
                                              device=device))

    def sharded_lookup_or_create(self, state, wire: HostShardedWire, step,
                                 axis, bucket_cap):
        """The owner's metadata writes, init and admission for its
        received lanes (the one-card host path's lookup, K3a under the
        metadata layout), on this rank's shard."""
        inv_local, u_idx, owner_r, n_dropped, sat = \
            wire.to(state.values.device).decode()
        state, owner_aux = HostIndexEmbeddingCollection.lookup_or_create(
            self, state, owner_r, step)
        return state, HSAux(owner_aux=owner_aux, inv_local=inv_local,
                            u_idx=u_idx, n_dropped=n_dropped, sat=sat)

    def sharded_rows(self, state, aux: HSAux):
        """The owner's rows per received lane, ``[S*C, dim]`` (K1; created
        rows read their lazy init): the differentiable leaf."""
        a = aux.owner_aux.ev_aux
        return ev.gather(state.values, a, self.config)[a.uniq.inverse]

    def sharded_rows_back(self, urows, aux: HSAux, axis, bucket_cap):
        """The rows ``all_to_all`` and the unbucketing: ``(row_u [Uc, dim],
        inv_local [Nl], valid_flat [Nl])``, differentiable in ``urows``."""
        back = _RowsBack.apply(urows, axis, self.config.exchange_dtype)
        routed = aux.u_idx >= 0
        row_u = torch.where(routed[:, None],
                            back[aux.u_idx.clamp(min=0).long()], 0.0)
        return row_u, aux.inv_local, routed[aux.inv_local.long()]

    def sharded_apply_gradients(self, state, opt, slot_state, aux: HSAux,
                                d_urows, step, axis, num_shards):
        """Sum the cotangent onto the owner's lanes and apply (in place)."""
        a = aux.owner_aux.ev_aux
        grads_u = segment_sum(d_urows, a.uniq.inverse, a.uniq.ukeys.shape[0])
        cur = ev.gather(state.values, a, self.config)
        _, slot_state = opt.apply(state.values, slot_state, a.slots, grads_u,
                                  a.admitted, step, cur_rows=cur,
                                  created=a.created)
        return state, slot_state

    def sharded_readonly(self, state, wire: HostShardedWire, axis,
                         bucket_cap):
        """The eval exchange: keys missing from their owner read their
        deterministic init row; nothing is written."""
        inv_local, u_idx, owner_r, _, _ = \
            wire.to(state.values.device).decode()
        found = ~owner_r.created  # a read-only resolve flags missing keys
        rows = gather_rows(state.values, owner_r.uslots,
                           self.config.embedding_dim)
        defaults = ev.init_rows(self.config, owner_r.ukeys).to(rows.dtype)
        valid = ~K.is_empty(owner_r.ukeys)
        urows = torch.where((found | ~valid)[:, None], rows, defaults)
        aux = HSAux(owner_aux=None, inv_local=inv_local, u_idx=u_idx,
                    n_dropped=None, sat=None)
        return self.sharded_rows_back(urows[owner_r.inverse.long()], aux,
                                      axis, bucket_cap)

    def sharded_health(self, health, aux: HSAux):
        """Device counters, as the JAX engine keeps them: this rank's
        exchange drops, the owner's keys past ``max_unique`` and its unique
        high-water mark."""
        if health is None:
            return None
        u = aux.owner_aux.ev_aux.uniq
        nu = (u.n_unique + u.n_overflow).to(torch.int32)
        return torch.stack([health[0] + aux.n_dropped,
                            health[1] + aux.sat,
                            torch.maximum(health[2], nu)])

    def sharded_host_health(self, axis) -> Dict[str, int]:
        """The JAX package's health schema over every rank's resolver (one
        collective): total size, the fullest shard's load, index and
        unique overflow summed; drops and saturated steps are global
        already (every frame carries its rank's counts)."""
        size, cap_ovf, uniq_ovf = self._resolver.stats()
        late = self._hx.late_steps if self._hx is not None else 0
        mine = np.asarray([size, cap_ovf, uniq_ovf, late], np.int64)
        if axis.size > 1:
            g = axis.all_gather(multihost._host_group_tensor(
                axis, mine[None])).cpu().numpy()
        else:
            g = mine[None]
        cap = self.config.capacity
        out = {"size": int(g[:, 0].sum()), "capacity": cap,
               "shards": axis.size, "load_factor": int(g[:, 0].max()) / cap,
               "overflow": int(g[:, 1].sum()), "dropped": self._hs_dropped,
               "unique_saturated_steps": self._hs_sat, "max_n_unique": 0,
               "unique_overflow": int(g[:, 2].sum()),
               "max_unique": self.config.max_unique}
        if self._hx is not None:
            # soft one-step-ahead deadline misses, the worst rank's
            out["exchange_late_steps"] = int(g[:, 3].max())
        return out

    # -- growth (slots never move: the stores are padded) --------------------------
    def sharded_needs_growth(self) -> bool:
        """This rank's shard at 0.9 load, or keys that overflowed its rows
        since the last growth (the trainer takes the max over the
        ranks)."""
        return self.needs_growth(None)

    def sharded_grow_local(self, bundle, new_cap, fills):
        st = bundle.ev
        ident = torch.arange(st.capacity, device=st.values.device)
        new_ev = HostEVState(
            values=ev.permute_rows(st.values, ident, new_cap),
            freqs=ev.permute_rows(st.freqs, ident, new_cap),
            versions=ev.permute_rows(st.versions, ident, new_cap, -1),
            create_steps=ev.permute_rows(st.create_steps, ident, new_cap, -1))
        slot = permute_slot_state(bundle.slot, ident, new_cap, fills=fills)
        return bundle._replace(ev=new_ev, slot=slot)

    def note_grown(self) -> None:
        self._last_cap_ovf = self._resolver.stats()[1]

    # -- checkpoint: this rank's part, restores routed by the owner hash -------------
    def ckpt_arrays(self, bundle, num_shards: int, since: Optional[int],
                    evict: bool, global_step: Optional[int], shard: int = 0):
        """This rank's shard in the 4-array format (its resolver's keys in
        slot order, its stores' rows): one part of a multi-rank save."""
        return super().ckpt_arrays(bundle, 1, since, evict, global_step)

    def ckpt_restore(self, trainer, template, parts, num_shards: int):
        """Keep the saved rows the owner hash routes to this rank, at a
        capacity every rank computes alike from the fullest shard."""
        S, rank = getattr(trainer, "S", 1), getattr(trainer, "rank", 0)
        parts = [p for p in parts if "keys" in p]
        if S > 1:
            keys = np.concatenate([p["keys"] for p in parts])
            own = owner_of_np(keys[last_wins_sel(keys)], S)
            per = int(np.bincount(own, minlength=S).max()) if len(own) else 0
            cap = needed_capacity(per + 8, self.config.capacity, load=0.9)
            if cap != self.config.capacity:
                self.config = dataclasses.replace(self.config, capacity=cap)
                trainer.rejit()
            parts = [_rows_of_owner(p, owner_of_np(p["keys"], S) == rank)
                     for p in parts]
        out = super().ckpt_restore(trainer, template, parts, 1)
        self._dedup.reset()
        return out


def _rows_of_owner(part, keep: np.ndarray):
    """A saved part's rows where ``keep``; its scalar leaves whole."""
    n = part["keys"].shape[0]
    keep_t = torch.from_numpy(keep)
    out = {}
    for k, v in part.items():
        if getattr(v, "ndim", 0) >= 1 and v.shape[0] == n:
            v = v[keep_t if isinstance(v, torch.Tensor) else keep]
        out[k] = v
    return out
