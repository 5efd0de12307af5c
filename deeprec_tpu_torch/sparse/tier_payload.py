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
:func:`_from_f32_bits` is the torch inverse of :func:`_to_f32_bits`. The
JAX module's ``scatter`` belongs to the device-index engine and is not
ported.
"""
from __future__ import annotations

from typing import Any, List, NamedTuple, Tuple

import numpy as np
import torch

from ..utils.tree import leaves_with_paths


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
