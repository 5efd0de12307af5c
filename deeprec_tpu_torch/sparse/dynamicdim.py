"""Dynamic-dimension embedding: frequency-adaptive row width.

Port of ``deeprec_tpu/sparse/dynamicdim.py`` (DeepRec's
``DynamicEmbeddingVariable``, ``get_dynamic_dimension_embedding_variable``):
a row is ``block_num`` blocks of ``block_dim`` floats, and block ``b`` is
active once the key's frequency reaches ``freq_thresholds[b]``. Storage is
the base table's ``[capacity+1, block_num*block_dim]`` rows; the width is
a per-key 0/1 block mask over the frequency plane the table keeps, so the
row fetch (kernel K1, through ``embedding_var.gather``), the model and the
optimizer keep fixed shapes. Masked blocks read zeros and train nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..config import EmbeddingVariableConfig
from ..ops.gather import gather_rows
from . import embedding_var as ev


@dataclasses.dataclass(frozen=True)
class DynamicDimConfig:
    """``block_num`` blocks of ``block_dim``; block b requires
    ``freq_thresholds[b]`` observations (threshold[0] must be 0)."""

    block_num: int
    block_dim: int
    freq_thresholds: Tuple[int, ...]

    def __post_init__(self):
        if len(self.freq_thresholds) != self.block_num:
            raise ValueError("one freq threshold per block")
        if self.freq_thresholds[0] != 0:
            raise ValueError("first block must always be active")
        if list(self.freq_thresholds) != sorted(self.freq_thresholds):
            raise ValueError("thresholds must be non-decreasing")

    @property
    def full_dim(self) -> int:
        return self.block_num * self.block_dim


def ev_config(name: str, dd: DynamicDimConfig, **kwargs) -> EmbeddingVariableConfig:
    """Base EV config with the full (all-blocks) row width. Frequency
    tracking is forced on: block widths gate on the freq metadata, which
    the light layout would otherwise skip writing."""
    kwargs.setdefault("track_freq", True)
    return EmbeddingVariableConfig(name=name, embedding_dim=dd.full_dim, **kwargs)


def _active(dd: DynamicDimConfig, freqs: torch.Tensor) -> torch.Tensor:
    # against Python ints: nothing is copied to the device
    return torch.stack([freqs >= t for t in dd.freq_thresholds], -1)  # [n, B]


def block_mask(dd: DynamicDimConfig, freqs: torch.Tensor) -> torch.Tensor:
    """``[n, block_num*block_dim]`` float32 0/1 mask from the frequencies
    ``[n]``."""
    return _active(dd, freqs).to(torch.float32).repeat_interleave(
        dd.block_dim, dim=-1)


def gather(state: ev.EVState, dd: DynamicDimConfig, aux: ev.LookupAux,
           config: Optional[EmbeddingVariableConfig] = None) -> torch.Tensor:
    """``[n_unique, full_dim]`` rows with the inactive blocks zeroed. With
    the EV ``config``, created rows read their lazy init
    (``embedding_var.gather``); without it the stored rows, whole width.
    Both through K1."""
    if config is not None:
        rows = ev.gather(state.values, aux, config)
    else:
        rows = gather_rows(state.values, aux.slots)
    return rows * block_mask(dd, state.freqs[aux.slots])


def effective_dims(state: ev.EVState, dd: DynamicDimConfig,
                   aux: ev.LookupAux) -> torch.Tensor:
    """Per-unique-key active width (int32; the reference's
    ``DynamicEmbeddingVariable.blocknum_list`` times the block width)."""
    active = _active(dd, state.freqs[aux.slots])
    return active.sum(-1, dtype=torch.int32) * dd.block_dim
