"""Sequence (user-behaviour) models, port of
``deeprec_tpu/models/sequence.py``: DIN, DIEN, ``DINAttentionScores`` and
the zoo's ``dien_forward`` (``modelzoo/DIEN/train.py``); and the port's
own BST (Behavior Sequence Transformer), which the JAX package lacks.

Inputs: ``dense`` ``[B, Dd]`` or None; ``emb``, pooled embeddings name ->
``[B, d]`` (candidate item, its category, user); ``seq``, behaviour
sequences name -> (``[B, L, d]``, mask ``[B, L]``). Logits ``[B]``. Each
model takes its input widths (``emb_dim``, ``dense_dim``) as the CTR
models do, and describes its flax tree (``flax_tree``) and its ``Dice``
running statistics (``flax_batch_stats``: flax's ``batch_stats``
collection), which ``models.ctr`` carries to and from flax.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..utils import spans
from .ctr import concat_emb
from .layers import (AUGRU, GRU, DINAttention, Dice, PositionRows,
                     TransformerBlock)


def _concat_item_eb(emb, seq, candidate_name, seq_name,
                    candidate_context_names, seq_context_names):
    """candidate = ``[item, cate, ...]``; each history position =
    ``[hist_item, hist_cate, ...]``; the main sequence's mask governs."""
    cand = torch.cat([emb[candidate_name]]
                     + [emb[n] for n in candidate_context_names], -1)
    hist, mask = seq[seq_name]
    hist = torch.cat([hist] + [seq[n][0] for n in seq_context_names], -1)
    return cand, hist, mask


class _SequenceModel(nn.Module):
    """What the sequence models share: the item embedding widths, the
    head's context parts, the ``fc_i`` tower (``activation`` after each
    layer: ``dice``, ``relu``, ``leaky_relu`` at slope 0.01, or
    ``sigmoid``) and its ``Dice`` running stats."""

    def __init__(self, candidate_name: str, seq_name: str, emb_dim: int,
                 context_names: Sequence[str],
                 candidate_context_names: Sequence[str],
                 seq_context_names: Sequence[str], dense_dim: int):
        super().__init__()
        if len(candidate_context_names) != len(seq_context_names):
            raise ValueError("the candidate and the history positions must "
                             "concatenate as many embeddings")
        self.candidate_name, self.seq_name = candidate_name, seq_name
        self.context_names = list(context_names)
        self.candidate_context_names = list(candidate_context_names)
        self.seq_context_names = list(seq_context_names)
        self.dense_dim = dense_dim
        self.item_dim = emb_dim * (1 + len(self.seq_context_names))
        self.context_dim = emb_dim * len(self.context_names) + dense_dim

    def _tower(self, in_dim: int, hidden_units: Sequence[int],
               dice: bool) -> None:
        widths = [in_dim, *hidden_units]
        self.fc = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))
        self.dice = nn.ModuleList(Dice(u) for u in hidden_units) \
            if dice else None
        self.out = nn.Linear(widths[-1], 1)

    def _head(self, parts, dense, emb, train: bool) -> torch.Tensor:
        if self.context_names:
            parts.append(concat_emb(emb, self.context_names))
        if dense is not None and dense.shape[-1]:
            parts.append(dense)
        x = torch.cat(parts, -1)
        for i, fc in enumerate(self.fc):
            x = fc(x)
            if self.dice is not None:
                x = self.dice[i](x, train=train)
            elif self.activation == "relu":
                x = torch.relu(x)
            elif self.activation == "leaky_relu":
                x = F.leaky_relu(x, 0.01)
            else:
                x = torch.sigmoid(x)
        return self.out(x)[:, 0]

    def _tower_tree(self) -> dict:
        tree = {f"fc_{i}": fc for i, fc in enumerate(self.fc)}
        if self.dice is not None:
            tree.update({f"dice_{i}": d.flax_tree()
                         for i, d in enumerate(self.dice)})
        tree["out"] = self.out
        return tree

    def flax_batch_stats(self) -> dict:
        return ({} if self.dice is None else
                {f"dice_{i}": d.flax_batch_stats()
                 for i, d in enumerate(self.dice)})


class DIN(_SequenceModel):
    """Deep Interest Network: DIN attention pools the behaviour history
    against the candidate; the tower ``[cand, pooled, history sum, cand *
    pooled, context, dense]`` -> ``fc_i`` with ``activation`` (``dice``,
    ``relu`` or ``sigmoid``) -> ``out``. At emb 16 with one context
    embedding per item and ``uid``, ``fc_0`` takes 144."""

    def __init__(self, candidate_name: str, seq_name: str, emb_dim: int,
                 context_names: Sequence[str] = (),
                 candidate_context_names: Sequence[str] = (),
                 seq_context_names: Sequence[str] = (),
                 hidden_units: Sequence[int] = (200, 80),
                 att_units: Sequence[int] = (80, 40),
                 activation: str = "dice", dense_dim: int = 0):
        super().__init__(candidate_name, seq_name, emb_dim, context_names,
                         candidate_context_names, seq_context_names,
                         dense_dim)
        if activation not in ("dice", "relu", "sigmoid"):
            raise ValueError(f"unknown activation {activation!r}")
        self.activation = activation
        self.attention = DINAttention(self.item_dim, att_units)
        self._tower(4 * self.item_dim + self.context_dim, hidden_units,
                    activation == "dice")

    def forward(self, dense, emb: Dict[str, torch.Tensor], seq,
                train: bool = False) -> torch.Tensor:
        cand, hist, mask = _concat_item_eb(
            emb, seq, self.candidate_name, self.seq_name,
            self.candidate_context_names, self.seq_context_names)
        pooled = self.attention(cand, hist, mask)
        sum_pool = (hist * mask[..., None]).sum(1)
        return self._head([cand, pooled, sum_pool, cand * pooled], dense,
                          emb, train)

    def flax_tree(self) -> dict:
        return {"DINAttention_0": self.attention.flax_tree(),
                **self._tower_tree()}


class DINAttentionScores(DINAttention):
    """DIN attention returning the normalised weights ``[B, L]`` (for
    AUGRU): no 1/sqrt(d) on the scores."""

    scaled = False

    def forward(self, query, keys, mask) -> torch.Tensor:
        return self.weights(query, keys, mask)


class DIEN(_SequenceModel):
    """Deep Interest Evolution Network: a GRU extracts interest states from
    the history, attention of the projected candidate (``cand_proj``) over
    them weights an AUGRU whose last state is the evolved interest; the
    tower ``[cand, final, history sum, context, dense]`` -> ``fc_i`` with
    Dice -> ``out``. At emb 16 with ``gru_units`` 32, ``fc_0`` takes 112.

    With ``return_aux`` (and ``use_aux_loss``) it also returns the
    auxiliary loss: the GRU state at t scores behaviour t + 1 against a
    negative, the same position of the previous example in the batch
    (``roll`` over the batch, padding included), through ONE shared
    ``aux_proj``; the log-sigmoid terms are masked by ``mask[:, 1:]``.

    The forward records spans ``dien.interest_extractor``,
    ``dien.attention``, ``dien.interest_evolution``, ``dien.tower`` and
    ``dien.aux_loss`` and counters ``seq.lanes``, ``seq.valid_lanes`` and
    ``seq.recurrence_steps`` (``utils/spans.py``); the mask's sum, which
    ``seq.valid_lanes`` reads, is one reduction made whether or not the
    recorder is on."""

    activation = "dice"

    def __init__(self, candidate_name: str, seq_name: str, emb_dim: int,
                 context_names: Sequence[str] = (),
                 candidate_context_names: Sequence[str] = (),
                 seq_context_names: Sequence[str] = (),
                 gru_units: int = 36,
                 hidden_units: Sequence[int] = (200, 80),
                 att_units: Sequence[int] = (80, 40),
                 use_aux_loss: bool = True, dense_dim: int = 0):
        super().__init__(candidate_name, seq_name, emb_dim, context_names,
                         candidate_context_names, seq_context_names,
                         dense_dim)
        d, g = self.item_dim, gru_units
        self.use_aux_loss = use_aux_loss
        self.interest_extractor = GRU(d, g)
        self.cand_proj = nn.Linear(d, g)
        self.att = DINAttentionScores(g, att_units)
        self.interest_evolution = AUGRU(g, g)
        self.aux_proj = nn.Linear(d, g) if use_aux_loss else None
        self._tower(2 * d + g + self.context_dim, hidden_units, True)

    def forward(self, dense, emb: Dict[str, torch.Tensor], seq,
                train: bool = False, return_aux: bool = False):
        cand, hist, mask = _concat_item_eb(
            emb, seq, self.candidate_name, self.seq_name,
            self.candidate_context_names, self.seq_context_names)
        b, L = mask.shape
        spans.count("seq.lanes", b * L)
        spans.count("seq.valid_lanes", mask.sum())
        spans.count("seq.recurrence_steps", 2 * L)
        with spans.span("dien.interest_extractor"):
            states = self.interest_extractor(hist, mask)
        with spans.span("dien.attention"):
            att = self.att(self.cand_proj(cand), states, mask)
        with spans.span("dien.interest_evolution"):
            final = self.interest_evolution(states, att, mask)
        with spans.span("dien.tower"):
            logits = self._head(
                [cand, final, (hist * mask[..., None]).sum(1)], dense, emb,
                train)
        if not (return_aux and self.use_aux_loss):
            return logits
        with spans.span("dien.aux_loss"):
            prev = states[:, :-1]
            pos = (prev * self.aux_proj(hist[:, 1:])).sum(-1)
            neg = (prev * self.aux_proj(
                torch.roll(hist[:, 1:], 1, 0))).sum(-1)
            m = mask[:, 1:].float()
            aux = -(torch.log(torch.sigmoid(pos) + 1e-8)
                    + torch.log(1 - torch.sigmoid(neg) + 1e-8)) * m
            aux = aux.sum() / m.sum().clamp_min(1.0)
        return logits, aux

    def flax_tree(self) -> dict:
        tree = {"att": self.att.flax_tree(), "cand_proj": self.cand_proj,
                "interest_evolution": self.interest_evolution.flax_tree(),
                "interest_extractor": self.interest_extractor.flax_tree(),
                **self._tower_tree()}
        if self.aux_proj is not None:
            tree["aux_proj"] = self.aux_proj
        return tree


class BST(_SequenceModel):
    """Behavior Sequence Transformer (Chen et al., "Behavior Sequence
    Transformer for E-commerce Recommendation in Alibaba", DLP-KDD 2019,
    arXiv:1905.06874). The sequence is the ``L`` history slots followed
    by the candidate: token ``t < L`` is ``[hist_item, hist_cate, ...,
    pos]``, token ``L`` is ``[item, cate, ..., pos]``, width ``d`` =
    ``item_dim + emb_dim``. ``pos`` is a row of the learned ``pos_emb``
    table ``[L + 1, emb_dim]``, indexed by recency rank: a valid slot's
    rank is the count of valid slots at or after it (``n - t`` for slot
    ``t`` of a history of ``n`` right-padded slots), the candidate's and
    a padded slot's 0. The paper indexes it by the time between the
    behaviour and the candidate, which the behaviour data does not carry.
    One post-LN :class:`~.layers.TransformerBlock` (``heads`` heads, an
    FFN ``4 * d`` wide, ``dropout``) runs over the tokens, padded slots
    masked out as keys; the block's outputs at padded slots are then set
    to zero, and the ``[B, (L + 1) * d]`` flatten, with the context
    embeddings and dense features, goes through ``fc_i`` with LeakyReLU,
    then ``out``.

    The forward records spans ``bst.tokens``, ``bst.attention`` (the
    attention and the first LayerNorm), ``bst.ffn`` and ``bst.tower``
    (the forward's launches only) and counters ``seq.lanes``,
    ``seq.valid_lanes``, ``bst.tokens`` (``B * (L + 1)``, an int) and
    ``bst.valid_tokens`` (the valid slots and the candidates, a 0-dim
    tensor the forward makes on or off)."""

    activation = "leaky_relu"

    def __init__(self, candidate_name: str, seq_name: str, emb_dim: int,
                 max_len: int, context_names: Sequence[str] = (),
                 candidate_context_names: Sequence[str] = (),
                 seq_context_names: Sequence[str] = (), heads: int = 8,
                 hidden_units: Sequence[int] = (1024, 512, 256),
                 dropout: float = 0.2, dense_dim: int = 0):
        super().__init__(candidate_name, seq_name, emb_dim, context_names,
                         candidate_context_names, seq_context_names,
                         dense_dim)
        self.max_len = max_len
        d = self.item_dim + emb_dim
        self.pos_emb = nn.Embedding(max_len + 1, emb_dim)
        self.block = TransformerBlock(d, heads, 4 * d, dropout)
        self._tower((max_len + 1) * d + self.context_dim, hidden_units,
                    False)

    def forward(self, dense, emb: Dict[str, torch.Tensor], seq,
                train: bool = False) -> torch.Tensor:
        cand, hist, mask = _concat_item_eb(
            emb, seq, self.candidate_name, self.seq_name,
            self.candidate_context_names, self.seq_context_names)
        b, L = mask.shape
        if L != self.max_len:
            raise ValueError(f"histories of {L} slots; the model holds "
                             f"{self.max_len} positions")
        valid = mask.sum()
        spans.count("seq.lanes", b * L)
        spans.count("seq.valid_lanes", valid)
        spans.count("bst.tokens", b * (L + 1))
        spans.count("bst.valid_tokens", valid)
        spans.count("bst.valid_tokens", b)
        with spans.span("bst.tokens"):
            rank, keep = self.ranks(mask)
            x = torch.cat([torch.cat([hist, cand[:, None]], 1),
                           PositionRows.apply(self.pos_emb.weight, rank,
                                              keep)], -1)
        with spans.span("bst.attention"):
            s = self.block.attend(x, keep, train)
        with spans.span("bst.ffn"):
            f = torch.where(keep[..., None],
                            self.block.feed_forward(s, train), 0.0)
        with spans.span("bst.tower"):
            return self._head([f.reshape(b, -1)], dense, emb, train)

    @staticmethod
    def ranks(mask: torch.Tensor):
        """``(rank, keep)``, each ``[B, L + 1]``: each token's recency rank
        (the valid slots at or after it, 0 at padding and for the
        candidate) and whether it takes part (the valid slots and the
        candidate)."""
        m = mask.long()
        rank = (m.sum(1, keepdim=True) - m.cumsum(1) + 1) * m
        rank = torch.cat([rank, rank.new_zeros((m.shape[0], 1))], 1)
        keep = torch.cat([mask, mask.new_ones((m.shape[0], 1))], 1)
        return rank, keep

    def flax_tree(self) -> dict:
        return {"block": self.block.flax_tree(),
                "pos_emb": {"embedding": self.pos_emb.weight},
                **self._tower_tree()}


def dien_forward(apply_fn, dense, outputs, train):
    """``modelzoo/DIEN/train.py``'s forward: the auxiliary loss in
    training (``(logits, aux_loss)``), logits otherwise."""
    emb, seq = outputs["emb"]
    return apply_fn(dense, emb, seq=seq, train=train, return_aux=train)
