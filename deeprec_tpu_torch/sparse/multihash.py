"""Multi-hash embedding variables (the Q-R compositional trick).

Port of ``deeprec_tpu/sparse/multihash.py`` (DeepRec's
``MultiHashVariable``, ``get_multihash_variable``): an id indexes several
small dense sub-tables through complementary partitions (a remainder, then
per-table hashes), and its embedding combines the sub-rows with ``add``,
``mult`` or ``concat``. Memory is O(sum of the sub-table sizes).

Each sub-table here is stored ``[size_i + 1, sub_dim]``: the last row is a
zero null row that padding ids read, so kernel K1 (``ops.gather``) fetches
the sub-rows directly and the sparse optimizers drop masked lanes onto it
(``optim.sparse._scatter_set``), where the JAX package concatenates a zero
row on every lookup and apply. Checkpoints keep the JAX shapes
(``[size_i, sub_dim]``; ``feature_column_variants``). Updates are in place.

Sub-index 0 is ``key mod size_0`` over the full 64-bit key, never negative
(``torch.remainder``). The JAX ``keys.mod`` multiplies two int32 values
that overflow for a size that is not a power of two and is at least
46,341 (ROADMAP C8); below that, and for powers of two, both agree.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ..ops.gather import gather_rows
from ..ops.segment import segment_sum
from ..ops.unique import unique_int32
from . import keys as K


@dataclasses.dataclass(frozen=True)
class MultiHashConfig:
    """``num_of_partitions`` complementary partitions (reference supports 2
    via Q-R; >2 generalises by repeated division)."""

    name: str
    embedding_dim: int
    table_sizes: Tuple[int, ...]       # e.g. (Q, R): Q*R >= vocab
    combiner: str = "add"              # add | mult | concat
    initializer_scale: float = 0.05
    seed: int = 0

    def __post_init__(self):
        if self.combiner not in ("add", "mult", "concat"):
            raise ValueError(self.combiner)

    @property
    def sub_dim(self) -> int:
        if self.combiner == "concat":
            d, r = divmod(self.embedding_dim, len(self.table_sizes))
            if r:
                raise ValueError("embedding_dim must divide evenly for concat")
            return d
        return self.embedding_dim


class MultiHashState(NamedTuple):
    tables: Tuple[torch.Tensor, ...]  # [size_i + 1, sub_dim]; last row zero


def create(config: MultiHashConfig,
           generator: Optional[torch.Generator] = None,
           device="cuda") -> MultiHashState:
    """Sub-tables of ``normal * initializer_scale`` rows, drawn on the host
    from ``generator`` (default: seeded with ``config.seed``), so a card
    and a CPU table start alike."""
    g = generator if generator is not None else \
        torch.Generator().manual_seed(config.seed)
    tables = []
    for size in config.table_sizes:
        t = torch.zeros((size + 1, config.sub_dim), dtype=torch.float32)
        t[:size] = torch.randn((size, config.sub_dim), generator=g) \
            * config.initializer_scale
        tables.append(t.to(device))
    return MultiHashState(tables=tuple(tables))


def sub_indices(config: MultiHashConfig, ids: torch.Tensor
                ) -> Tuple[torch.Tensor, ...]:
    """Each table's row of every int64 id: the remainder for table 0,
    ``hash32(id, 101 + i) % size_i`` for table ``i > 0`` (the JAX hashes,
    bit-equal), and the null row ``size_i`` for EMPTY ids."""
    empty = K.is_empty(ids)
    out = []
    for i, size in enumerate(config.table_sizes):
        if i == 0:
            idx = torch.remainder(ids, size)
        else:
            idx = K.hash32(ids, seed=101 + i) % size
        out.append(torch.where(empty, size, idx))
    return tuple(out)


def _sub_rows(state: MultiHashState, subs) -> list:
    return [gather_rows(t, idx) for t, idx in zip(state.tables, subs)]


def lookup(state: MultiHashState, config: MultiHashConfig,
           ids: torch.Tensor) -> torch.Tensor:
    """``[n, embedding_dim]``; padding ids read the null rows, so they
    combine to zeros."""
    rows = _sub_rows(state, sub_indices(config, ids))
    if config.combiner == "add":
        return sum(rows[1:], rows[0])
    if config.combiner == "mult":
        out = rows[0]
        for r in rows[1:]:
            out = out * r
        return out
    return torch.cat(rows, -1)


def apply_gradients(state: MultiHashState, config: MultiHashConfig, opt,
                    slot_states: Sequence, ids: torch.Tensor,
                    grads: torch.Tensor, step: int
                    ) -> Tuple[MultiHashState, tuple]:
    """Sparse-apply the gradient of :func:`lookup`'s output onto each
    sub-table: split it per combiner, dedup each table's rows
    (:func:`~..ops.unique.unique_int32`), sum per row, update with the
    shared sparse optimizer (in place)."""
    subs = sub_indices(config, ids)
    n_tables = len(state.tables)
    if config.combiner == "concat":
        gparts = list(torch.split(grads, config.sub_dim, -1))
    elif config.combiner == "add":
        gparts = [grads] * n_tables
    else:  # mult: d/dt_i = grads * prod_{j != i} rows_j
        rows = _sub_rows(state, subs)
        gparts = []
        for i in range(n_tables):
            other = torch.ones_like(grads)
            for j, r in enumerate(rows):
                if j != i:
                    other = other * r
            gparts.append(grads * other)

    valid = ~K.is_empty(ids)
    new_slots = []
    for t, idx, g, slot in zip(state.tables, subs, gparts, slot_states):
        size = t.shape[0] - 1
        uidx, inv, _ = unique_int32(torch.where(valid, idx, size))
        gu = segment_sum(g, inv, uidx.shape[0])
        mask = uidx < size
        _, slot = opt.apply(t, slot, torch.where(mask, uidx, size), gu,
                            mask, step)
        new_slots.append(slot)
    return state, tuple(new_slots)


def init_slots(state: MultiHashState, opt) -> tuple:
    """One optimizer state per sub-table, over its ``[size_i + 1]`` rows
    (the JAX package's padded view)."""
    return tuple(opt.init(t) for t in state.tables)
