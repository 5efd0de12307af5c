"""Host-index embedding collection: the key -> slot index lives on the host.

Port of ``deeprec_tpu/host_index.py`` (``HostEVState``, ``ResolvedIds``,
``ResolvedWire`` and the training and eval half of
``HostIndexEmbeddingCollection``). The native C++ ``HostIndexResolver``
(``utils/native.py``, shared ``native/deeprec_native.cc``) turns each batch
of ids into unique keys, dense row slots, the inverse permutation, created
flags and multiplicities, packed into ONE uint8 wire buffer; the device
step decodes it with dtype views and needs no dedup and no hash probe. The
row stores stay on the device.

What the device does with a resolved batch (:meth:`lookup_or_create`):
eager init of created rows when the table admits by frequency or has
``lazy_init`` off (plain ``index_copy_``: an XLA scatter in the JAX
package), then the metadata writes (create step, version, freq add) and
the ``admitted`` mask as ONE launch of kernel K3a
``ops.meta_scatter.lookup_meta`` under the ``--metadata`` layout (the
light layout, with no metadata, tests ``uslots != cap`` alone). It updates
the stores in place and returns the same state.

Fence-time hooks (call them with any ``HostStepPipeline`` drained):
growth (``needs_growth``/``grow_state``: slots never move, the stores are
padded to twice the rows and the null row moves from ``cap`` to
``2*cap``), ``host_health``, and the checkpoint hooks ``ckpt_arrays`` /
``ckpt_restore`` of ``checkpoint.saver.CheckpointManager``, in the JAX
package's 4-array format. ``device_view`` is what a ``Predictor`` serves.

Tiered storage (``StorageOption(HBM_DRAM)`` or ``HBM_DRAM_SSD``): a host
tier (``utils.native.HostKV``, or a ``TierStack`` whose DRAM part spills
to a file-backed store, under the temp dir unless ``ssd_path`` is set)
holds the rows demoted from the device, each as one
``sparse.tier_payload`` row (values, bit-cast metadata, optimizer slot
rows). Demotion (``demote_cold``) runs at fences: the policy-cold and
budget-excess rows are read with kernel K1 at full row width, copied to
the host once, packed and upserted into the tier, and the resolver and
every store are compacted with one permutation. Promotion rides the
resolve wire: the resolve probes the tier for the batch's created lanes
(``_tier_promo``), takes the hits out of it and ships their payloads as
the wire's ``promo`` planes; ``apply_promo`` writes them into the stores
before the batch's metadata writes. A read-only resolve patches its rows
from the tier and changes nothing. CBF admission with tiers is rejected,
as in the JAX package.

Threads: ``_tier_promo`` runs on ``HostStepPipeline``'s resolve thread
and takes rows out of the tier; demotion, checkpoint export and import,
and eval resolves run on the caller's thread. The C++ store is not
documented as thread-safe, so one lock per collection (``_tier_lock``)
guards the tier store and the since-save key set on every path.

Two faults of the JAX package are fixed here (the tests hold the intended
behaviour): ``export_tier(since=...)`` leaves the since-save window alone
(the saver clears it through ``tier_saved`` once the save is on disk), and
a tiered restore leaves a key whose tier row wins out of the device stores
and the resolver (``checkpoint.saver``), so it lives in one tier only.
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import tempfile
import threading
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from .checkpoint import format as F
from .checkpoint.saver import (_cbf_for_shard, _rows, last_wins_sel,
                               needed_capacity)
from .config import L2WeightEvict, StorageType
from .feature_column import CollectionAux, EmbeddingCollection
from .ops.gather import gather_rows
from .ops.meta_scatter import lookup_meta
from .ops.unique import UniqueResult
from .optim.sparse import _scatter_set, permute_slot_state
from .sparse import embedding_var as ev
from .sparse import keys as K
from .sparse import tier_payload as TP
from .utils.native import (HostIndexResolver, HostKV, TierStack,
                           resolve_wire_into, wire_layout)
from .utils.tree import leaves_with_paths, map_leaves

_arena_ids = itertools.count()  # one SSD arena file per default-path tier


class HostEVState(NamedTuple):
    """Device half of a host-indexed table: row stores only (the key index
    is the collection's resolver). Row ``capacity`` is the null row."""

    values: torch.Tensor        # [capacity+1, dim + fused slot columns]
    freqs: torch.Tensor         # [capacity+1] int32
    versions: torch.Tensor      # [capacity+1] int32
    create_steps: torch.Tensor  # [capacity+1] int32

    @property
    def capacity(self) -> int:
        return self.values.shape[0] - 1


class ResolvedIds(NamedTuple):
    """One batch's host-resolved lookup. ``created`` flags rows assigned
    this batch (train) or keys missing from the index (readonly)."""

    ukeys: torch.Tensor       # [U] int64 unique keys, EMPTY-padded
    uslots: torch.Tensor      # [U] int32 (capacity = null row)
    inverse: torch.Tensor     # [n] int32 flat position -> unique lane
    created: torch.Tensor     # [U] bool
    counts: torch.Tensor      # [U] int32 within-batch multiplicity
    n_unique: torch.Tensor    # int32 scalar
    n_overflow: torch.Tensor  # int32 scalar
    readonly: torch.Tensor    # bool scalar (eval resolve)


class ResolvedWire:
    """The transferred form of :class:`ResolvedIds`: one uint8 tensor.

    Layout (``utils.native.wire_layout``; U = max_unique + 1, n = flat
    batch width)::

        [uslots | created<<30 : i32 U][key hi : i32 U][key lo : i32 U]
        [counts : i32 U, only when the table reads freq/version metadata]
        [inverse : i16 n, 4-byte padded (i32 when U > 32767)]
        [tail : i32 4 = n_unique, n_overflow, readonly, 0x5EC2]

    One host-to-device copy per step; :meth:`decode` slices the buffer
    with dtype views at those byte offsets, on the buffer's device.

    A tiered table's wire may carry ``promo``: ``(lanes int32 [m],
    payload float32 [m, width])``, the tier rows of the keys this resolve
    found in the host tier, one per lane (no padding). They travel with
    the buffer (``to`` copies them, a pinned resolve pins them), and
    :meth:`decode` clears ``created`` on those lanes, so no init path
    overwrites a promoted row.
    """

    __slots__ = ("buf", "u", "n", "with_counts", "inv16", "promo")

    def __init__(self, buf: torch.Tensor, u: int, n: int, with_counts: bool,
                 inv16: bool, promo=None):
        self.buf = buf  # uint8 [wire_layout(...)[0]]
        self.u = int(u)
        self.n = int(n)
        self.with_counts = bool(with_counts)
        self.inv16 = bool(inv16)
        self.promo = promo  # None | (lanes, payload)

    def tensors(self):
        """The buffer and the promo planes."""
        return [self.buf] + list(self.promo or ())

    def to(self, device, non_blocking: bool = False) -> "ResolvedWire":
        promo = None if self.promo is None else tuple(
            t.to(device, non_blocking=non_blocking) for t in self.promo)
        return ResolvedWire(self.buf.to(device, non_blocking=non_blocking),
                            self.u, self.n, self.with_counts, self.inv16,
                            promo)

    def decode(self) -> ResolvedIds:
        U, n, buf = self.u, self.n, self.buf
        _, off = wire_layout(U, n, self.with_counts, self.inv16)

        def i32(byte_off, count):
            return buf[byte_off:byte_off + 4 * count].view(torch.int32)

        sf = i32(off["slots"], U)
        hi = i32(off["hi"], U).long()
        lo = i32(off["lo"], U).long()
        ukeys = (hi << 32) | (lo & 0xFFFFFFFF)
        if self.with_counts:
            counts = i32(off["counts"], U)
        else:
            # no consumer reads multiplicities under this layout: expose
            # lane occupancy so a (counts > 0) liveness test stays right
            counts = (~K.is_empty(ukeys)).to(torch.int32)
        if self.inv16:
            o = off["inverse"]
            inverse = buf[o:o + 2 * n].view(torch.int16).to(torch.int32)
        else:
            inverse = i32(off["inverse"], n)
        tail = i32(off["tail"], 4)
        created = ((sf >> 30) & 1) == 1
        if self.promo is not None:
            # a promoted row is restored training state, not a fresh key
            created[self.promo[0].long()] = False
        return ResolvedIds(
            ukeys=ukeys,
            uslots=sf & ((1 << 30) - 1),
            inverse=inverse,
            created=created,
            counts=counts,
            n_unique=tail[0],
            n_overflow=tail[1],
            readonly=tail[2] == 1)


class HostIndexEmbeddingCollection(EmbeddingCollection):
    """An :class:`EmbeddingCollection` whose key index lives on the host.

    ``n_groups`` is the resolver's deterministic key-sharding fan-out (it
    defines the slot-assignment order; keep the default). ``use_native``:
    None takes the C++ resolver when it builds and the Python fallback
    otherwise; True raises when the C++ resolver cannot be built.
    """

    def __init__(self, columns, name: str = "emb", capacity: int = 1 << 20,
                 n_groups: int = 16, use_native: Optional[bool] = None,
                 **kwargs):
        super().__init__(columns, name=name, capacity=capacity, **kwargs)
        self.tier_store = None          # the host tier, made at first use
        self._tier_since_save = set()   # keys demoted since the last save
        self._tier_lock = threading.Lock()
        self._tiered = self.config.storage.storage_type is not StorageType.HBM
        if self._tiered and self.config.cbf_filter is not None:
            # the resolver's bloom gate would deny a slot to a returning
            # demoted key until its estimate re-crosses filter_freq
            raise NotImplementedError(
                "host-index tiered storage with CBF admission: use "
                "CounterFilter, or the device-index EmbeddingCollection")
        self._resolver = HostIndexResolver(n_groups=n_groups,
                                           use_native=use_native)
        self._resolver.reserve(min(capacity, 1 << 22))
        if self.config.cbf_filter is not None:
            # bloom admission lives in the resolver, as in the JAX package
            cbf = self.config.cbf_filter
            self._resolver.cbf_enable(cbf.num_counters(), cbf.num_hashes,
                                      cbf.filter_freq)
        if not self.config.version_tracked:
            # light layout: the resolver records touched slots, the
            # incremental checkpoint's delta
            self._resolver.track_touched(True)
        self._last_cap_ovf = 0
        self._sat_steps = 0   # train resolves that overflowed max_unique
        self._max_nu = 0      # high-water unique demand

    # -- state ---------------------------------------------------------
    def init(self, device="cuda") -> HostEVState:
        """Fresh row stores on ``device``; resets the host index and the
        host tier (the halves of the table restart together)."""
        self._resolver.reset()
        with self._tier_lock:
            self.tier_store = None
            self._tier_since_save = set()
        cfg = self.config
        cap = cfg.capacity
        width = cfg.embedding_dim + cfg.fused_slot_columns
        i32 = dict(dtype=torch.int32, device=device)
        return HostEVState(
            values=torch.zeros((cap + 1, width),
                               dtype=getattr(torch, cfg.value_dtype),
                               device=device),
            freqs=torch.zeros((cap + 1,), **i32),
            versions=torch.full((cap + 1,), -1, **i32),
            create_steps=torch.full((cap + 1,), -1, **i32))

    # -- host hot path ---------------------------------------------------
    def _wire_params(self, n: int):
        cfg = self.config
        u_out = cfg.max_unique + 1 if cfg.max_unique else n + 1
        with_counts = (cfg.freq_tracked or cfg.version_tracked
                       or cfg.counter_filter is not None)
        return u_out, with_counts, u_out <= 32767

    def _resolve(self, batch, readonly: bool, device=None,
                 pin: bool = False) -> ResolvedWire:
        packed = batch if isinstance(batch, np.ndarray) \
            else self.pack_ids_np(batch)
        cap = self.config.capacity
        n = packed.size
        u_out, with_counts, inv16 = self._wire_params(n)
        # the resolver writes the wire straight into the tensor's memory
        # (page-locked when ``pin``, so its copy to the card can be async)
        buf = torch.empty((wire_layout(u_out, n, with_counts, inv16)[0],),
                          dtype=torch.uint8, pin_memory=pin)
        nu, nov = resolve_wire_into(
            self._resolver, packed, u_out, cap, cap, readonly, with_counts,
            inv16, buf.numpy())
        if not readonly:
            self._sat_steps += int(nov > 0)
            self._max_nu = max(self._max_nu, int(nu) + int(nov))
        promo = (self._tier_promo(buf.numpy(), u_out, readonly, pin)
                 if self._tiered else None)
        wire = ResolvedWire(buf, u_out, n, with_counts, inv16, promo)
        return wire if device is None else wire.to(device)

    def _tier_promo(self, buf: np.ndarray, u_out: int, readonly: bool,
                    pin: bool = False):
        """The host half of promotion, at resolve time: the created (train)
        or missing (read-only) lanes probe the tier; the hits become the
        wire's promo planes ``(lanes, payload)`` and, on a train resolve,
        leave the tier (their payload is now on its way to the device)."""
        with self._tier_lock:
            if self.tier_store is None or len(self.tier_store) == 0:
                return None
            p32 = buf[:12 * u_out].view(np.int32)
            sf = p32[:u_out]
            lanes = np.nonzero((sf >> 30) & 1)[0].astype(np.int32)
            if not lanes.size:
                return None
            hi = p32[u_out:2 * u_out][lanes].astype(np.int64)
            lo = p32[2 * u_out:3 * u_out][lanes].astype(np.uint32)
            keys = (hi << 32) | lo.astype(np.int64)
            rows, found = self.tier_store.lookup(keys)
            if not found.any():
                return None
            lanes = lanes[found]
            rows = rows[found]
            if not readonly:
                hit_keys = keys[found]
                self.tier_store.erase(hit_keys)
                self._tier_since_save.difference_update(
                    int(k) for k in hit_keys)
        promo = (torch.from_numpy(lanes), torch.from_numpy(rows))
        return tuple(t.pin_memory() for t in promo) if pin else promo

    def pack_ids(self, batch, device="cuda") -> ResolvedWire:
        """Train resolve (find-or-insert; mutates the index: call once per
        training batch, in step order), with the wire copied to
        ``device``."""
        return self._resolve(batch, readonly=False, device=device)

    def pack_ids_host(self, batch, pin: bool = False) -> ResolvedWire:
        """Train resolve with the wire left in host memory, page-locked
        when ``pin`` (the resolve stage of ``train.pipeline.
        HostStepPipeline``, whose transfer stage copies it). Same
        step-order rule."""
        return self._resolve(batch, readonly=False, pin=pin)

    def pack_ids_eval(self, batch, device="cuda") -> ResolvedWire:
        """Eval resolve: find-only, no mutation."""
        return self._resolve(batch, readonly=True, device=device)

    # -- device step ------------------------------------------------------
    def apply_promo(self, state: HostEVState, slot_state, wire):
        """Write the wire's promoted tier rows into the stores, in place:
        values, the bit-cast freq, version and create step, and the
        optimizer slot rows, at the promo lanes' slots (``index_copy_``
        through ``optim.sparse._scatter_set``; an XLA scatter in the JAX
        package). A no-op when the wire carries no promo planes. Runs
        before :meth:`lookup_or_create`, so the batch's metadata writes
        land on the restored row. Returns ``(state, slot_state)``."""
        if not isinstance(wire, ResolvedWire) or wire.promo is None:
            return state, slot_state
        dev = state.values.device
        lanes, payload = (t.to(dev) for t in wire.promo)
        cap = state.capacity
        sf = wire.buf.to(dev)[:4 * wire.u].view(torch.int32)
        slots = (sf & ((1 << 30) - 1))[lanes.long()]
        dest = torch.where(slots != cap, slots, cap + 1)  # cap + 1: dropped
        spec = TP.spec(state.values.shape[1], slot_state, cap + 1)
        dim = spec.dim
        _scatter_set(state.values, dest, payload[:, :dim])
        for i, plane in enumerate((state.freqs, state.versions,
                                   state.create_steps)):
            _scatter_set(plane, dest,
                         TP._from_f32_bits(payload[:, dim + i], torch.int32))
        leaves = [leaf for _, leaf in leaves_with_paths(slot_state)]
        o = dim + 3
        for s in spec.slot_rows:
            part = TP._from_f32_bits(payload[:, o:o + s.width], s.dtype)
            _scatter_set(leaves[s.index], dest,
                         part.reshape((-1,) + s.shape))
            o += s.width
        return state, slot_state

    @staticmethod
    def _decoded(batch, device) -> ResolvedIds:
        if isinstance(batch, ResolvedWire):
            return batch.to(device).decode()
        return batch

    def lookup_or_create(self, state: HostEVState, batch, step: int):
        """Consume a host-resolved batch (a raw batch is resolved here):
        eager init, metadata writes and admission; the index work already
        happened on the host. Updates ``state`` in place and returns
        ``(state, aux)``."""
        dev = state.values.device
        if not isinstance(batch, (ResolvedWire, ResolvedIds)):
            batch = self.pack_ids(batch, dev)
        r = self._decoded(batch, dev)
        cfg = self.config
        cap = state.capacity

        dest = torch.where(r.created & ~r.readonly, r.uslots, cap + 1)
        if cfg.filter_freq > 0 or not cfg.lazy_init:
            rows0 = ev.init_rows(cfg, r.ukeys)
            if cfg.fused_slot_columns:
                pad = torch.full((rows0.shape[0], cfg.fused_slot_columns),
                                 cfg.fused_slot_init, dtype=rows0.dtype,
                                 device=dev)
                rows0 = torch.cat([rows0, pad], -1)
            _scatter_set(state.values, dest, rows0)

        vt, ft = cfg.version_tracked, cfg.freq_tracked
        cf = cfg.counter_filter
        if vt or ft or cf is not None:
            # K3a: the writes and the admission test in one launch; row
            # cap (the null row) untouched
            admitted = lookup_meta(
                r.uslots, r.counts, r.readonly, dest, int(step), cap,
                create_steps=state.create_steps if vt else None,
                versions=state.versions if vt else None, freqs=state.freqs,
                add_freqs=ft,
                filter_freq=None if cf is None else cf.filter_freq)
        else:
            admitted = r.uslots != cap
        return state, self._aux(r, admitted, r.created)

    @staticmethod
    def _aux(r: ResolvedIds, admitted, created) -> CollectionAux:
        uniq = UniqueResult(ukeys=r.ukeys, inverse=r.inverse, counts=r.counts,
                            n_unique=r.n_unique, n_overflow=r.n_overflow)
        return CollectionAux(ev_aux=ev.LookupAux(
            uniq=uniq, slots=r.uslots, admitted=admitted, created=created))

    def readonly_rows(self, state: HostEVState, cats):
        """Eval path: ``(aux, unique rows)`` without mutation. Missing keys
        read their deterministic would-be init row."""
        dev = state.values.device
        if not isinstance(cats, (ResolvedWire, ResolvedIds)):
            cats = self.pack_ids_eval(cats, dev)
        r = self._decoded(cats, dev)
        cfg = self.config
        found = ~r.created  # readonly resolve: created == missing
        aux = self._aux(r, found, torch.zeros_like(found))
        rows = gather_rows(state.values, r.uslots, cfg.embedding_dim)
        defaults = ev.init_rows(cfg, r.ukeys).to(rows.dtype)
        valid = ~K.is_empty(r.ukeys)
        rows = torch.where((found | ~valid)[:, None], rows, defaults)
        if isinstance(cats, ResolvedWire) and cats.promo is not None:
            # keys in the host tier read their saved rows; decode already
            # marked their lanes found, and nothing is mutated
            lanes, payload = (t.to(dev) for t in cats.promo)
            rows[lanes.long()] = payload[:, :cfg.embedding_dim].to(rows.dtype)
        return aux, rows

    # -- growth and health (fence work) -----------------------------------
    def load_factor(self, state) -> float:
        """The resolver's load (``state``, the row stores, for the JAX
        package's signature)."""
        return self._resolver.size / self.config.capacity

    def needs_growth(self, state) -> bool:
        """At 0.9 load, or when keys overflowed the row capacity since the
        last growth (they wait, pending, for a row)."""
        _, cap_ovf, _ = self._resolver.stats()
        return self.load_factor(state) >= 0.9 or \
            cap_ovf > self._last_cap_ovf

    def grow_state(self, state: HostEVState, slot_state, opt=None):
        """Double the rows. Slots never move, so no index rebuild: the
        stores are padded (values and freqs 0, versions and create steps
        -1) and the null row moves from ``cap`` to ``2*cap``. Every
        resolve after this one passes the new ``cap`` as the null slot;
        call it on a drained pipeline only."""
        cap = self.config.capacity
        new_cap = 2 * cap
        ident = torch.arange(cap, device=state.values.device)
        new_state = HostEVState(
            values=ev.permute_rows(state.values, ident, new_cap),
            freqs=ev.permute_rows(state.freqs, ident, new_cap),
            versions=ev.permute_rows(state.versions, ident, new_cap, -1),
            create_steps=ev.permute_rows(state.create_steps, ident, new_cap,
                                         -1))
        slot_state = permute_slot_state(slot_state, ident, new_cap,
                                        fills=opt.fills if opt else None)
        self.config = dataclasses.replace(self.config, capacity=new_cap)
        self._last_cap_ovf = self._resolver.stats()[1]
        return new_state, slot_state

    def index_view(self, state):
        """None: no device index; health comes from :meth:`host_health`."""
        return None

    # -- tiered storage (fence work, except promotion) ----------------------
    def _make_tier(self, width: int):
        st = self.config.storage
        if st.storage_type is StorageType.HBM_DRAM_SSD:
            path = st.ssd_path or os.path.join(
                tempfile.gettempdir(),
                f"deeprec_hidx_ssd_{self.config.name}_{os.getpid()}_"
                f"{next(_arena_ids)}.arena")
            # the payload's version column: values block, freq, version
            vcol = self.config.embedding_dim \
                + self.config.fused_slot_columns + 1
            return TierStack(width, vcol, st.dram_row_budget, path)
        return HostKV(width, 1 << 16)

    def demote_cold(self, state: HostEVState, slot_state, global_step: int,
                    opt=None):
        """Move the policy-cold rows (``ev.cold_mask_np``) and, past
        ``storage.hbm_capacity``, the least recently touched ones
        (``ev.budget_cold_np``) to the host tier; compact the resolver and
        the stores. Call at a fence only, on a drained pipeline: in-flight
        resolves hold slot numbers this renumbers. The cold rows are read
        on the device with kernel K1 at full row width and come to the host
        in one copy. Returns ``(state, slot_state, n_demoted)``."""
        cfg = self.config
        budget = cfg.storage.hbm_capacity
        n = self._resolver.size
        if (cfg.evict is None and budget <= 0) or n == 0:
            return state, slot_state, 0
        versions = state.versions[:n].cpu().numpy()
        freqs = state.freqs[:n].cpu().numpy()
        occupied = np.ones((n,), bool)
        values_np = (state.values[:n].float().cpu().numpy()
                     if isinstance(cfg.evict, L2WeightEvict)
                     else np.zeros((n, 1), np.float32))
        cold = ev.cold_mask_np(cfg, values_np, versions, occupied,
                               int(global_step))
        cold = ev.budget_cold_np(cfg, versions, freqs, occupied, cold,
                                 budget)
        if not cold.any():
            return state, slot_state, 0
        idx = np.nonzero(cold)[0]
        keys_cold = self._resolver.export_keys()[idx]

        cap = cfg.capacity
        spec = TP.spec(state.values.shape[1], slot_state, cap + 1)
        payload = TP.gather_np(spec, state, slot_state, idx, freqs, versions)
        m = idx.shape[0]
        with self._tier_lock:
            if self.tier_store is None:
                self.tier_store = self._make_tier(spec.width)
            if self.tier_store.dim != spec.width:
                raise ValueError("the tier payload width changed (another "
                                 "optimizer's slot rows?)")
            self.tier_store.upsert(keys_cold, payload)
            self._tier_since_save.update(int(k) for k in keys_cold)

        # compact: the resolver renumbers the kept slots densely and the
        # stores follow with one permutation (dropped rows go to cap + 1)
        old_to_new = self._resolver.compact((~cold).astype(np.uint8))
        o2n = np.full((cap,), cap + 1, np.int64)
        o2n[:n] = np.where(old_to_new >= 0, old_to_new, cap + 1)
        perm = torch.from_numpy(o2n).to(state.values.device)
        new_state = HostEVState(
            values=ev.permute_rows(state.values, perm, cap),
            freqs=ev.permute_rows(state.freqs, perm, cap),
            versions=ev.permute_rows(state.versions, perm, cap, -1),
            create_steps=ev.permute_rows(state.create_steps, perm, cap, -1))
        slot_state = permute_slot_state(slot_state, perm, cap,
                                        fills=opt.fills if opt else None)
        return new_state, slot_state, m

    def export_tier(self, since=None):
        """``(keys, payload rows)`` of the tier for a save's
        ``__tier__<name>`` table, or None when there are none. With
        ``since`` (an incremental save) only the rows demoted since the
        last save. The window is left alone: the saver calls
        :meth:`tier_saved` once the save is on disk."""
        with self._tier_lock:
            if self.tier_store is None or len(self.tier_store) == 0:
                return None
            keys, rows = self.tier_store.export()
            if since is not None:
                sel = np.isin(keys, np.fromiter(self._tier_since_save,
                                                np.int64,
                                                len(self._tier_since_save)))
                keys, rows = keys[sel], rows[sel]
        if not len(keys):
            return None
        return keys, rows

    def tier_saved(self) -> None:
        """A save holding the tier is durable: start the next window."""
        with self._tier_lock:
            self._tier_since_save.clear()

    def import_tier(self, keys: np.ndarray, rows: np.ndarray) -> None:
        """Restore demoted rows into the host tier (made at the restored
        payload width)."""
        with self._tier_lock:
            if self.tier_store is None:
                self.tier_store = self._make_tier(rows.shape[1])
            self.tier_store.upsert(keys, rows)

    def host_tier_rows(self) -> int:
        with self._tier_lock:
            return len(self.tier_store) if self.tier_store is not None else 0

    def host_health(self) -> Dict[str, int]:
        """The JAX package's health schema (``Trainer.table_health``)."""
        size, cap_ovf, uniq_ovf = self._resolver.stats()
        return {"size": size, "capacity": self.config.capacity,
                "shards": 1,
                "load_factor": size / self.config.capacity,
                "overflow": cap_ovf, "dropped": 0,
                "unique_saturated_steps": self._sat_steps,
                "max_n_unique": self._max_nu,
                "unique_overflow": uniq_ovf,
                "max_unique": self.config.max_unique}

    def device_view(self) -> EmbeddingCollection:
        """A plain device-index :class:`EmbeddingCollection` over the same
        columns and config: what a ``serving.Predictor`` serves. It
        rebuilds its table from the checkpoint and neither needs nor
        shares the training job's resolver."""
        view = EmbeddingCollection.__new__(EmbeddingCollection)
        view.__dict__.update({k: v for k, v in self.__dict__.items()
                              if not k.startswith("_resolver")
                              and not k.startswith("_tier")
                              and k not in ("_last_cap_ovf", "_sat_steps",
                                            "_max_nu", "tier_store")})
        return view

    # -- checkpoint hooks (checkpoint.saver.CheckpointManager) --------------
    def ckpt_arrays(self, bundle, num_shards: int, since: Optional[int],
                    evict: bool, global_step: Optional[int]):
        """The 4-array compacted format: keys from the resolver in slot
        order, rows from the stores. ``since`` selects an incremental's
        delta: ``versions >= since`` in a version-tracked layout, the
        resolver's touched slots in the light layout. Every save clears
        the touched-slot window, a full one too."""
        if num_shards != 1:
            raise NotImplementedError("host-index tables are unsharded")
        cfg = self.config
        st = bundle.ev
        n = self._resolver.size
        keys = self._resolver.export_keys()
        values = st.values[:n].cpu()
        freqs, versions, create_steps = (
            t[:n].cpu().numpy() for t in (st.freqs, st.versions,
                                          st.create_steps))

        touched = None
        if since is not None and not cfg.version_tracked:
            touched = self._resolver.touched_slots(clear=True)
            touched = touched[touched < n]
            since = None
        live = np.ones((n,), bool)
        if evict and cfg.evict is not None and global_step is not None:
            live &= ~ev.cold_mask_np(cfg, values.float().numpy(), versions,
                                     live, global_step)
        if since is not None:
            live &= versions >= since
        if touched is not None:
            sel = np.zeros((n,), bool)
            sel[touched] = True
            live &= sel
        elif since is None and not cfg.version_tracked:
            self._resolver.touched_slots(clear=True)
        idx = np.nonzero(live)[0]

        out = {"keys": keys[idx], "values": _rows(values, idx),
               "freqs": freqs[idx], "versions": versions[idx],
               "create_steps": create_steps[idx]}
        if cfg.cbf_filter is not None:
            out["cbf"] = self._resolver.cbf_export()
            out["cbf_shards"] = np.asarray(1, np.int32)
        for name, leaf in F.slot_leaf_names(bundle.slot):
            if leaf.dim() >= 1 and leaf.shape[0] == cfg.capacity + 1:
                out[f"slot__{name}"] = _rows(leaf[:n].cpu(), idx)
            else:
                out[f"scalar__{name}"] = leaf.cpu().numpy()
        return out

    def ckpt_restore(self, trainer, template, parts, num_shards: int):
        """Rebuild the resolver and the stores from saved parts (oldest
        first; the newest row of a key wins). The parts may come from any
        save in the 4-array format, the JAX package's included. Grows the
        capacity when the rows need it (load 0.9)."""
        if num_shards != 1:
            raise NotImplementedError("host-index tables are unsharded")
        with self._tier_lock:  # the saver imports the tier after this
            self.tier_store = None
            self._tier_since_save = set()
        cfg = self.config
        parts = [p for p in parts if "keys" in p]
        all_keys = np.concatenate([p["keys"] for p in parts])
        sel = last_wins_sel(all_keys)
        n = sel.shape[0]
        cap = needed_capacity(n + 8, cfg.capacity, load=0.9)
        if cap != cfg.capacity:
            self.config = cfg = dataclasses.replace(cfg, capacity=cap)
            trainer.rejit()
        width = cfg.embedding_dim + cfg.fused_slot_columns
        sel_t = torch.from_numpy(sel)

        def merged(key):
            return torch.cat([torch.as_tensor(p[key]) for p in parts])[sel_t]

        self._resolver.load_keys(all_keys[sel])
        self._resolver.reserve(min(cap, 1 << 22))
        if cfg.cbf_filter is not None:
            cbf_parts = [p for p in parts
                         if "cbf" in p or any(k.startswith("cbf__shard")
                                              for k in p)]
            if cbf_parts:  # the newest part's counters win
                counters = _cbf_for_shard(cbf_parts[-1], 0, 1)
                if (counters is not None and counters.shape[0]
                        == cfg.cbf_filter.num_counters()):
                    self._resolver.cbf_load(counters)

        dev = template.ev.values.device

        def store(col, fill, dtype, extra_shape=()):
            out = torch.full((cap + 1,) + extra_shape, fill, dtype=dtype)
            out[:n] = merged(col).to(dtype)
            return out.to(dev)

        st = HostEVState(
            values=store("values", 0, getattr(torch, cfg.value_dtype),
                         (width,)),
            freqs=store("freqs", 0, torch.int32),
            versions=store("versions", -1, torch.int32),
            create_steps=store("create_steps", -1, torch.int32))
        opt = trainer.sparse_optimizers[
            next(k for k, c in trainer.collections.items() if c is self)]

        def leaf_from_parts(path, leaf):
            name = F.slot_leaf_name(path)
            rk, sk = f"slot__{name}", f"scalar__{name}"
            if all(rk in p for p in parts):
                leaf[:n] = merged(rk).to(leaf)
                return leaf
            scalars = [p[sk] for p in parts if sk in p]
            if scalars:  # the newest part that carries the leaf wins
                return torch.as_tensor(scalars[-1]).to(leaf)
            return leaf
        slot = map_leaves(leaf_from_parts, opt.init(st.values))
        return template._replace(ev=st, slot=slot)

