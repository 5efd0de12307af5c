"""Adaptive embedding: a static hash-bucket table plus a dynamic EV, each
id routed by admission.

Port of ``deeprec_tpu/sparse/adaptive.py`` (DeepRec's
``categorical_column_with_adaptive_embedding``): keys the admission filter
has admitted own an exact EV row; the others (the long tail) read and
train a row shared by hash in a small static ``[buckets+1, dim]`` table
(its last row the zero null row). A key admitted this step seeds its EV
row from its static bucket's row, so what the bucket learned carries over.

Row reads go through kernel K1 (``ops.gather``) on both tables; the EV
lookup through ``embedding_var.lookup_or_create`` (its metadata writes and
the CounterFilter test are kernel K3a). The stores are updated in place.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import EmbeddingVariableConfig
from ..ops.gather import gather_rows
from ..ops.segment import segment_sum
from ..ops.unique import unique_int32
from . import embedding_var as ev
from . import keys as K


class AdaptiveState(NamedTuple):
    ev: ev.EVState
    static: torch.Tensor   # [buckets+1, dim]; last row = null


def create(config: EmbeddingVariableConfig, buckets: int,
           generator: Optional[torch.Generator] = None,
           device="cuda") -> AdaptiveState:
    """A fresh EV and a static table of ``normal * initializer.scale``
    rows drawn on the host from ``generator`` (default: seeded with 7, as
    the JAX package's fixed key), so a card and a CPU table start alike."""
    if config.counter_filter is None and config.cbf_filter is None:
        raise ValueError("adaptive embedding needs an admission filter "
                         "(CounterFilter/CBFFilter) to define hot vs tail")
    g = generator if generator is not None else \
        torch.Generator().manual_seed(7)
    static = torch.randn((buckets + 1, config.embedding_dim), generator=g) \
        * config.initializer.scale
    static[buckets] = 0.0
    return AdaptiveState(ev=ev.create(config, device),
                         static=static.to(device))


def bucket_of(keys: torch.Tensor, buckets: int) -> torch.Tensor:
    """``hash32(key, 29) % buckets`` (bit-equal to the JAX package), the
    null row ``buckets`` for EMPTY keys."""
    b = K.hash32(keys, seed=29) % buckets
    return torch.where(K.is_empty(keys), buckets, b)


def lookup_or_create(state: AdaptiveState, config: EmbeddingVariableConfig,
                     ids: torch.Tensor, global_step: int):
    """EV lookup with admission; a key crossing the admission threshold
    this step seeds its EV row from its static bucket row. Detecting the
    crossing reads the frequency plane, so a CounterFilter table must
    track frequencies (the default); without, no key is ever admitted, as
    in the JAX package."""
    from ..optim.sparse import _scatter_set  # it imports embedding_var
    ev_state, aux = ev.lookup_or_create(state.ev, config, ids, global_step)
    buckets = state.static.shape[0] - 1
    b = bucket_of(aux.uniq.ukeys, buckets)
    if config.counter_filter is not None:
        prev_freq = ev_state.freqs[aux.slots] - aux.uniq.counts
        newly_admitted = aux.admitted & (
            prev_freq < config.counter_filter.filter_freq)
    else:
        # CBF gating: slot allocation IS admission — seed at creation
        newly_admitted = aux.created
    dest = torch.where(newly_admitted, aux.slots, config.capacity + 1)
    _scatter_set(ev_state.values, dest, gather_rows(state.static, b))
    return AdaptiveState(ev=ev_state, static=state.static), aux


def gather(state: AdaptiveState, config: EmbeddingVariableConfig,
           aux: ev.LookupAux) -> torch.Tensor:
    """``[n_unique, dim]``: admitted keys read their EV row, tail keys the
    shared static bucket."""
    return gather_from(state.ev.values, state.static, config, aux)


def gather_from(values: torch.Tensor, static: torch.Tensor,
                config: EmbeddingVariableConfig,
                aux: ev.LookupAux) -> torch.Tensor:
    b = bucket_of(aux.uniq.ukeys, static.shape[0] - 1)
    ev_rows = gather_rows(values, aux.slots, config.embedding_dim)
    st_rows = gather_rows(static, b).to(ev_rows.dtype)
    return torch.where(aux.admitted[:, None], ev_rows, st_rows)


def apply_gradients(state: AdaptiveState, config: EmbeddingVariableConfig,
                    opt, slot_state, static_opt, static_slot,
                    aux: ev.LookupAux, grads_u: torch.Tensor,
                    global_step: int):
    """Split the unique-row gradient by route: admitted keys -> the EV's
    sparse apply; tail keys -> their buckets, deduplicated
    (:func:`~..ops.unique.unique_int32`) and summed, then the static
    table's sparse apply (collided tail keys share their update). In
    place; returns ``(state, slot_state, static_slot)``."""
    _, slot_state = opt.apply(state.ev.values, slot_state, aux.slots,
                              grads_u, aux.admitted, global_step)
    buckets = state.static.shape[0] - 1
    tail = ~aux.admitted & ~K.is_empty(aux.uniq.ukeys)
    b = torch.where(tail, bucket_of(aux.uniq.ukeys, buckets), buckets)
    ub, inv, _ = unique_int32(b)
    gb = segment_sum(torch.where(tail[:, None], grads_u, 0.0), inv,
                     ub.shape[0])
    mask = ub < buckets
    _, static_slot = static_opt.apply(
        state.static, static_slot, torch.where(mask, ub, buckets), gb,
        mask, global_step)
    return state, slot_state, static_slot
