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

Not ported yet: tiered storage (``apply_promo``, demotion, the tier
export), ``grow_state``, the checkpoint hooks and ``host_health``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .config import StorageType
from .feature_column import CollectionAux, EmbeddingCollection
from .ops.gather import gather_rows
from .ops.meta_scatter import lookup_meta
from .ops.unique import UniqueResult
from .optim.sparse import _scatter_set
from .sparse import embedding_var as ev
from .sparse import keys as K
from .utils.native import HostIndexResolver, wire_layout


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
    """

    __slots__ = ("buf", "u", "n", "with_counts", "inv16")

    def __init__(self, buf: torch.Tensor, u: int, n: int, with_counts: bool,
                 inv16: bool):
        self.buf = buf  # uint8 [wire_layout(...)[0]]
        self.u = int(u)
        self.n = int(n)
        self.with_counts = bool(with_counts)
        self.inv16 = bool(inv16)

    def to(self, device) -> "ResolvedWire":
        return ResolvedWire(self.buf.to(device), self.u, self.n,
                            self.with_counts, self.inv16)

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
        return ResolvedIds(
            ukeys=ukeys,
            uslots=sf & ((1 << 30) - 1),
            inverse=inverse,
            created=((sf >> 30) & 1) == 1,
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
        if self.config.storage.storage_type is not StorageType.HBM:
            raise NotImplementedError(
                "host-index tiered storage is not ported to "
                "deeprec_tpu_torch yet")
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
            # incremental checkpoint's delta (the saver is not ported yet)
            self._resolver.track_touched(True)

    # -- state ---------------------------------------------------------
    def init(self, device="cuda") -> HostEVState:
        """Fresh row stores on ``device``; resets the host index (both
        halves of the table restart together)."""
        self._resolver.reset()
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

    def _resolve(self, batch, readonly: bool, device=None) -> ResolvedWire:
        packed = batch if isinstance(batch, np.ndarray) \
            else self.pack_ids_np(batch)
        cap = self.config.capacity
        n = packed.size
        u_out, with_counts, inv16 = self._wire_params(n)
        buf, _, _ = self._resolver.resolve_wire(
            packed, u_out, null_slot=cap, row_capacity=cap,
            readonly=readonly, with_counts=with_counts, inv16=inv16)
        wire = ResolvedWire(torch.from_numpy(buf), u_out, n, with_counts,
                            inv16)
        return wire if device is None else wire.to(device)

    def pack_ids(self, batch, device="cuda") -> ResolvedWire:
        """Train resolve (find-or-insert; mutates the index: call once per
        training batch, in step order), with the wire copied to
        ``device``."""
        return self._resolve(batch, readonly=False, device=device)

    def pack_ids_host(self, batch) -> ResolvedWire:
        """Train resolve with the wire left in host memory (for a pipeline
        stage that copies it later). Same step-order rule."""
        return self._resolve(batch, readonly=False)

    def pack_ids_eval(self, batch, device="cuda") -> ResolvedWire:
        """Eval resolve: find-only, no mutation."""
        return self._resolve(batch, readonly=True, device=device)

    # -- device step ------------------------------------------------------
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
        return aux, torch.where((found | ~valid)[:, None], rows, defaults)
