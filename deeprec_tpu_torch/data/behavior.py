"""Synthetic user-behaviour stream (the behaviour feature names and
:class:`SyntheticBehavior`) for DSSM and, later, DIN and DIEN.

A framework-free copy of ``deeprec_tpu/data/behavior.py:36-123``: the port
cannot import the JAX package. ``tests/test_torch_zoo_models.py`` checks that
both give byte-identical batches and that the copy is the source. Each
example is (user, candidate item, its category, the click history,
label): ``uid``, ``item``, ``cate`` int64 ``[B]``; ``hist_item`` and
``hist_cate`` int64 ``[B, L]``, -1 padded; ``label`` f32 ``[B]``.
:func:`oracle_auc` and :func:`_rank_auc` (numpy) are copies of
``behavior.py:125-156`` too.
"""
from __future__ import annotations

import itertools
from typing import Dict

import numpy as np

FEATURES = ["uid", "item", "cate", "hist_item", "hist_cate"]


class SyntheticBehavior:
    """Streaming synthetic behaviour-sequence batches."""

    def __init__(
        self,
        batch_size: int,
        max_len: int = 32,
        n_users: int = 10_000,
        n_items: int = 50_000,
        n_cates: int = 200,
        latent_dim: int = 8,
        seed: int = 0,
        noise: float = 0.5,
        emit_clean_logit: bool = False,
    ):
        # emit_clean_logit: include the generator's noiseless logit as
        # "_clean_logit" per batch — ranking by it is Bayes-optimal
        # (the noise is additive pre-sigmoid, so E[y|features+latents] is
        # monotone in the clean logit). Used to compute the stream's
        # achievable AUC ceiling; trainers ignore unknown batch keys.
        self.emit_clean_logit = emit_clean_logit
        self.batch_size = batch_size
        self.max_len = max_len
        self.n_users = n_users
        self.n_items = n_items
        self.n_cates = n_cates
        self.rng = np.random.default_rng(seed)
        wrng = np.random.default_rng(1234)  # label model shared across seeds
        self.item_vec = wrng.normal(size=(n_items, latent_dim)).astype(np.float32)
        self.item_cate = wrng.integers(0, n_cates, size=n_items)
        self.noise = noise

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        B, L = self.batch_size, self.max_len
        rng = self.rng
        uid = rng.integers(0, self.n_users, size=B)
        # history: a user's clicks cluster around a taste point in latent
        # space — draw a taste, pick items by affinity-biased sampling
        taste_items = rng.integers(0, self.n_items, size=B)
        taste = self.item_vec[taste_items]                    # [B, d]
        lens = rng.integers(4, L + 1, size=B)
        cand = rng.integers(0, self.n_items, size=B)
        pool = rng.integers(0, self.n_items, size=(B, L, 4))
        aff = np.einsum("bd,blkd->blk", taste, self.item_vec[pool])
        pick = pool[np.arange(B)[:, None], np.arange(L)[None, :],
                    np.argmax(aff, axis=-1)]
        valid = np.arange(L)[None, :] < lens[:, None]
        hist_item = np.where(valid, pick, -1)
        hist_cate = np.where(valid, self.item_cate[pick], -1)
        # label signal 1: per-item hidden bias (hash-derived, O(1) memory)
        h = (cand.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
             + np.uint64(77))
        h ^= h >> np.uint64(29)
        h *= np.uint64(0xBF58476D1CE4E5B9)
        bias = ((h >> np.uint64(40)).astype(np.float64) / (1 << 24) - 0.5) * 2.0
        # label signal 2: best affinity between candidate and any history
        # item (the DIN-attention-shaped signal); padding excluded
        cand_aff = np.einsum("bd,bld->bl", self.item_vec[cand],
                             self.item_vec[np.maximum(hist_item, 0)])
        cand_aff = np.where(hist_item >= 0, cand_aff, -np.inf)
        repeat = np.tanh(np.max(cand_aff, axis=1) / 2.0)
        # label signal 3: latent taste affinity (slow co-occurrence tail)
        logit = (1.2 * bias + 1.2 * repeat
                 + 0.5 * np.einsum("bd,bd->b", taste, self.item_vec[cand]))
        clean = logit.copy()
        logit += rng.normal(0, self.noise, size=B)
        p = 1.0 / (1.0 + np.exp(-logit))
        out = {
            "uid": uid.astype(np.int64),
            "item": cand.astype(np.int64),
            "cate": self.item_cate[cand].astype(np.int64),
            "hist_item": hist_item,
            "hist_cate": hist_cate,
            "label": (rng.random(B) < p).astype(np.float32),
        }
        if self.emit_clean_logit:
            out["_clean_logit"] = clean.astype(np.float32)
        return out

    def take(self, n: int):
        return itertools.islice(self, n)


def oracle_auc(n_batches: int = 50, **gen_kwargs) -> float:
    """Bayes-optimal AUC of the behaviour stream: rank by the generator's
    noiseless logit (the label noise is additive pre-sigmoid, so this is
    the achievable ceiling any model is measured against — the
    '% of achievable lift' denominator, like the Criteo-stream oracle
    docs/Performance.md uses for DCN). benchmarks/behavior_oracle.py adds
    the feature-observable variants."""
    gen_kwargs.setdefault("batch_size", 4096)
    gen = SyntheticBehavior(emit_clean_logit=True, **gen_kwargs)
    scores, labels = [], []
    for b in gen.take(n_batches):
        scores.append(b["_clean_logit"])
        labels.append(b["label"])
    return _rank_auc(np.concatenate(scores), np.concatenate(labels))


def _rank_auc(s: np.ndarray, y: np.ndarray) -> float:
    """Exact (tie-corrected, rank-based) AUC of scores s against labels y."""
    order = np.argsort(s, kind="stable")
    ranks = np.empty(len(s), np.float64)
    ranks[order] = np.arange(1, len(s) + 1)
    # tie-correct via average ranks on sorted groups
    s_sorted = s[order]
    starts = np.flatnonzero(np.r_[True, s_sorted[1:] != s_sorted[:-1]])
    ends = np.r_[starts[1:], len(s)]
    for a, e in zip(starts, ends):
        if e - a > 1:
            ranks[order[a:e]] = (a + 1 + e) / 2.0
    pos = y > 0.5
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))
