"""Full-fidelity row payloads for host-tier demotion and promotion.

Port of ``deeprec_tpu/sparse/tier_payload.py``. One row of a tiered table
demotes to the host tier as a single float32 vector::

    [ values (dim incl. fused slot cols) | freq | version | create_step |
      flattened optimizer slot rows ... ]

Integer columns (freq, version, create step and any integer slot leaves)
are stored as bit patterns, not value casts: versions are global steps and
must survive runs past 2^24 exactly.

:class:`SlotLeaf`, :class:`PayloadSpec`, :func:`spec`, :func:`_to_f32_bits`
and :func:`pack_np` are verbatim copies (``tests/test_torch_tier_store.py``
holds them to their source). :func:`slot_row_leaves` walks the port's slot
trees through ``utils/tree.py`` in ``jax.tree_util``'s leaf order, and
:func:`_from_f32_bits` is the torch inverse of :func:`_to_f32_bits`.
:func:`gather_np` packs a table's rows on the device for demotion (both
engines). :func:`scatter` is the device-index promotion (a tiered
host-index table promotes through its resolve wire instead,
``host_index.apply_promo``).
"""
from __future__ import annotations

from typing import Any, List, NamedTuple, Tuple

import numpy as np
import torch

from ..ops.gather import gather_rows
from ..utils.tree import leaves_with_paths
from . import hashtable as ht
from . import keys as K


class SlotLeaf(NamedTuple):
    index: int                 # position in tree_leaves(slot_state)
    width: int                 # flattened per-row width
    shape: Tuple[int, ...]     # per-row shape
    dtype: Any                 # leaf dtype


class PayloadSpec(NamedTuple):
    dim: int                   # values row width (incl. fused slot columns)
    slot_rows: Tuple[SlotLeaf, ...]
    width: int                 # total payload width


def slot_row_leaves(slot_state, cap1: int) -> List[SlotLeaf]:
    """Row-shaped slot leaves (leading dim == ``cap1``), indexed by their
    position among the slot tree's leaves."""
    out = []
    for i, (_, leaf) in enumerate(leaves_with_paths(slot_state)):
        if isinstance(leaf, torch.Tensor) and leaf.dim() >= 1 \
                and leaf.shape[0] == cap1:
            w = int(np.prod(leaf.shape[1:], dtype=np.int64)) \
                if leaf.dim() > 1 else 1
            out.append(SlotLeaf(i, w, tuple(leaf.shape[1:]), leaf.dtype))
    return out


def spec(values_width: int, slot_state, cap1: int) -> PayloadSpec:
    rows = tuple(slot_row_leaves(slot_state, cap1))
    return PayloadSpec(values_width, rows,
                       values_width + 3 + sum(r.width for r in rows))


def _to_f32_bits(arr: np.ndarray) -> np.ndarray:
    """Lossless mapping into the f32 payload: floats cast, ints bit-cast."""
    if arr.dtype.kind in "iu":
        return np.ascontiguousarray(arr.astype(np.int32)).view(np.float32)
    return arr.astype(np.float32)


def pack_np(spec_: PayloadSpec, idx: np.ndarray, values_np: np.ndarray,
            freqs_np: np.ndarray, versions_np: np.ndarray,
            create_steps_np: np.ndarray, slot_leaves_np) -> np.ndarray:
    """Host-side packing of the selected rows ``idx`` into [n, width] f32.

    ``slot_leaves_np``: full list of tree_leaves arrays (per-shard view, so
    row-shaped leaves have leading dim cap1)."""
    dim = spec_.dim
    n = idx.shape[0]
    payload = np.zeros((n, spec_.width), np.float32)
    payload[:, :dim] = values_np[idx].astype(np.float32)
    payload[:, dim] = _to_f32_bits(np.asarray(freqs_np)[idx])
    payload[:, dim + 1] = _to_f32_bits(np.asarray(versions_np)[idx])
    payload[:, dim + 2] = _to_f32_bits(np.asarray(create_steps_np)[idx])
    o = dim + 3
    for sl in spec_.slot_rows:
        part = np.asarray(slot_leaves_np[sl.index])[idx].reshape(n, -1)
        payload[:, o:o + sl.width] = _to_f32_bits(part)
        o += sl.width
    return payload


def _from_f32_bits(col: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`_to_f32_bits` on a float32 tensor: integer
    columns are bit-cast back (``view``, never a value cast), float ones
    cast."""
    if not dtype.is_floating_point:
        return col.contiguous().view(torch.int32).to(dtype)
    return col.to(dtype)


def to_f32_bits(t: torch.Tensor) -> torch.Tensor:
    """:func:`_to_f32_bits` on a tensor, on its device: floats cast to
    float32, integers bit-cast through int32."""
    if not t.dtype.is_floating_point:
        return t.to(torch.int32).contiguous().view(torch.float32)
    return t.float()


def gather_np(spec_: PayloadSpec, state, slot_state, idx: np.ndarray,
              freqs_np: np.ndarray, versions_np: np.ndarray) -> np.ndarray:
    """The payload rows of slots ``idx`` of a table's stores (``state``:
    values and create steps) and optimizer state, ``[len(idx), width]``:
    the values (kernel K1 at the full row width), create steps and slot
    rows gathered on the device into one float32 block (integers bit-cast)
    and copied to the host once; ``freqs_np`` and ``versions_np`` are the
    host copies of those planes, indexed by slot."""
    didx = torch.from_numpy(idx).to(state.values.device)
    leaves = [leaf for _, leaf in leaves_with_paths(slot_state)]
    block = torch.cat(
        [gather_rows(state.values, didx).float(),
         to_f32_bits(state.create_steps[didx])[:, None]]
        + [to_f32_bits(leaves[s.index][didx].reshape(idx.shape[0], -1))
           for s in spec_.slot_rows], 1).cpu().numpy()
    rows_np, o = list(leaves), spec_.dim + 1
    for s in spec_.slot_rows:
        part = block[:, o:o + s.width]
        rows_np[s.index] = (part if s.dtype.is_floating_point
                            else part.view(np.int32))
        o += s.width
    return pack_np(spec_, np.arange(idx.shape[0]), block[:, :spec_.dim],
                   freqs_np[idx], versions_np[idx],
                   block[:, spec_.dim].view(np.int32), rows_np)


def scatter(bundle, cfg, spec_: PayloadSpec, keys: torch.Tensor,
            payload: torch.Tensor):
    """Promotion into a device-index table bundle: insert ``keys`` into
    its index and write the payload rows into the values, the metadata
    planes and the optimizer slot rows, all in place and at full fidelity.
    Returns ``(bundle, live)``: ``live`` marks the rows the index placed
    (a near-full table can refuse one; its host-tier row must stay)."""
    from ..optim.sparse import _scatter_set  # it imports embedding_var
    st = bundle.ev
    cap = cfg.capacity
    dim = spec_.dim
    index, slots, _ = ht.lookup_or_insert_(st.index, keys, cfg.max_probes)
    live = ~K.is_empty(keys) & (slots != cap)
    dest = torch.where(live, slots, cap + 1)  # cap + 1: dropped
    _scatter_set(st.values, dest, payload[:, :dim])
    for i, plane in enumerate((st.freqs, st.versions, st.create_steps)):
        _scatter_set(plane, dest, _from_f32_bits(payload[:, dim + i],
                                                 torch.int32))
    leaves = [leaf for _, leaf in leaves_with_paths(bundle.slot)]
    o = dim + 3
    for sl in spec_.slot_rows:
        part = _from_f32_bits(payload[:, o:o + sl.width], sl.dtype)
        _scatter_set(leaves[sl.index], dest,
                     part.reshape((keys.shape[0],) + sl.shape))
        o += sl.width
    return bundle._replace(ev=st._replace(index=index)), live
