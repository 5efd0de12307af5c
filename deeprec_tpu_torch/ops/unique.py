"""Deduplication of 64-bit key batches.

Port of ``deeprec_tpu/ops/unique.py`` ``unique``, ``unique_cols`` and
``unique_int32``: a stable sort with the original positions as payload,
then adjacent-difference segmentation (``unique_cols``: one batched sort of
the rows of a feature-major ``[W, B]`` block; ``unique_int32``: one plane
of small indices, the multi-hash sub-indices and the adaptive buckets).

The sort key is ``ids ^ 0x80000000``: flipping bit 31 makes int64 order
equal to the JAX package's lexicographic order over the signed int32
``(hi, lo)`` planes, so the unique keys come out in the same order as
there and a ``max_unique`` cap keeps the same keys.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..sparse import keys as K


class UniqueResult(NamedTuple):
    ukeys: torch.Tensor     # [U] int64 unique keys, EMPTY-padded at the tail
    inverse: torch.Tensor   # [n] int64: position of each input key in ukeys
    counts: torch.Tensor    # [U] int64 multiplicity (0 for EMPTY groups)
    n_unique: torch.Tensor  # scalar: valid unique keys kept
    n_overflow: torch.Tensor  # scalar: distinct valid keys beyond the cap


def _group_sizes(inverse: torch.Tensor, u_out: int) -> torch.Tensor:
    """Members of each of the ``u_out`` groups: a scatter-add, which, unlike
    ``torch.bincount`` on the card, needs no host sync."""
    return torch.zeros((u_out,), dtype=torch.int64,
                       device=inverse.device).index_add_(
        0, inverse, torch.ones_like(inverse))


INT32_MAX = torch.iinfo(torch.int32).max


def unique_int32(idx: torch.Tensor):
    """Dedup a 1-D batch of non-negative indices below 2^31 (static
    tables' rows). Returns ``(uidx, inverse, counts)``, all of length
    ``n``: ``uidx`` int32, the distinct values ascending, padded at the
    tail with INT32_MAX (callers mask with ``uidx < size``); ``inverse``
    int64, each input's position in ``uidx``; ``counts`` int64, each
    group's size (0 in the padding). The values are the JAX package's; no
    host sync."""
    n = idx.shape[0]
    sidx, order = torch.sort(idx.to(torch.int32), stable=True)
    first = torch.ones(n, dtype=torch.bool, device=idx.device)
    first[1:] = sidx[1:] != sidx[:-1]
    uid_sorted = torch.cumsum(first, 0) - 1
    inverse = torch.empty_like(uid_sorted)
    inverse[order] = uid_sorted
    uidx = torch.full((n + 1,), INT32_MAX, dtype=torch.int32,
                      device=idx.device)
    uidx[torch.where(first, uid_sorted, n)] = sidx  # non-starts: trash
    return uidx[:n], inverse, _group_sizes(inverse, n)


def unique(ids: torch.Tensor, max_unique: Optional[int] = None
           ) -> UniqueResult:
    """Deduplicate a 1-D int64 key batch.

    Without a cap ``U = n``. With ``max_unique < n``, ``U = max_unique + 1``
    and the unique keys past the cap collapse into an EMPTY overflow group
    at index ``max_unique``: they read the null row (zeros) downstream.
    EMPTY inputs form their own group(s), excluded from ``n_unique``.
    """
    n = ids.shape[0]
    order = torch.sort(ids ^ 0x80000000, stable=True).indices
    skeys = ids[order]
    first = torch.ones(n, dtype=torch.bool, device=ids.device)
    first[1:] = skeys[1:] != skeys[:-1]
    uid_sorted = torch.cumsum(first, 0) - 1

    if max_unique is None or max_unique >= n:
        u_out = n
        inv_sorted = uid_sorted
        keep_first = first
        over = torch.zeros_like(first)
    else:
        u_out = max_unique + 1  # index max_unique = the overflow/null group
        over = uid_sorted >= max_unique
        inv_sorted = torch.where(over, max_unique, uid_sorted)
        keep_first = first & ~over

    inverse = torch.empty_like(inv_sorted)
    inverse[order] = inv_sorted
    # group starts in sorted order scatter the keys; non-starts and
    # overflow groups go to a trash slot past the end
    dest = torch.where(keep_first, inv_sorted, u_out)
    ukeys = torch.full((u_out + 1,), K.EMPTY, dtype=torch.int64,
                       device=ids.device)
    ukeys[dest] = skeys
    ukeys = ukeys[:u_out]
    valid_group = ~K.is_empty(ukeys)
    counts = _group_sizes(inverse, u_out) * valid_group
    n_unique = valid_group.sum()
    n_overflow = (first & over & ~K.is_empty(skeys)).sum()
    return UniqueResult(ukeys, inverse, counts, n_unique, n_overflow)


def unique_cols(ids: torch.Tensor, max_unique: Optional[int] = None
                ) -> UniqueResult:
    """Column-parallel dedup of a feature-major ``[W, B]`` key batch:
    ``W`` row sorts of width ``B`` (one batched ``torch.sort``) instead of
    one sort of ``W*B``.

    The unique keys come row-major, as in the JAX package: row 0's groups
    in sort order, then row 1's, and so on; ``max_unique`` cuts that
    concatenated order (not a global sort), and the groups past it collapse
    into the EMPTY overflow group at index ``max_unique``. ``inverse``
    indexes the flat feature-major layout (``w*B + b``). Valid only when
    every key can appear in one row alone: width-1 columns with distinct
    salt groups (``EmbeddingCollection`` checks, and uses :func:`unique`
    otherwise)."""
    W, B = ids.shape
    n = W * B
    dev = ids.device
    cap = n if max_unique is None or max_unique >= n else max_unique
    u_out = cap + 1 if cap < n else n

    skeys, spos = torch.sort(ids ^ 0x80000000, dim=1, stable=True)
    skeys = skeys ^ 0x80000000
    first = torch.ones((W, B), dtype=torch.bool, device=dev)
    first[:, 1:] = skeys[:, 1:] != skeys[:, :-1]
    uid_row = torch.cumsum(first, 1) - 1
    offsets = torch.cumsum(uid_row[:, -1] + 1, 0) - (uid_row[:, -1] + 1)
    guid = offsets[:, None] + uid_row
    over = guid >= cap

    # inverse in the flat feature-major layout: one collision-free scatter
    row_base = torch.arange(W, device=dev)[:, None] * B
    inverse = torch.empty((n,), dtype=torch.int64, device=dev)
    inverse[(row_base + spos).reshape(-1)] = \
        torch.where(over, cap, guid).reshape(-1)
    # group starts scatter the keys; the rest go to a trash slot
    dest = torch.where(first & ~over, guid, u_out).reshape(-1)
    ukeys = torch.full((u_out + 1,), K.EMPTY, dtype=torch.int64, device=dev)
    ukeys[dest] = skeys.reshape(-1)
    ukeys = ukeys[:u_out]
    valid_group = ~K.is_empty(ukeys)
    # the overflow group's count is masked out with its EMPTY key
    counts = _group_sizes(inverse, u_out) * valid_group
    n_unique = valid_group.sum()
    n_overflow = (first & over & ~K.is_empty(skeys)).sum()
    return UniqueResult(ukeys, inverse, counts, n_unique, n_overflow)
