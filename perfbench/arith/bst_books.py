"""Operations and bytes of a BST training step
(``configs/bst_books.json``), from the shapes of ``reference/bst.params``,
counted at the valid tokens only.

An example of history length ``n`` has ``n + 1`` valid tokens (its valid
slots and the candidate) and ``(n + 1)^2`` valid query-key pairs. As
multiply-adds of the forward: the token-wise products (``qkv``, the
attention's ``out``, ``ffn_in``, ``ffn_out``: each weight's ``in * out``)
at each valid token; ``Q K^T`` and ``A V``, ``d`` each a pair (``heads``
heads of ``d / heads``); the tower's layers once, the first at its whole
``(L + 1) * d + context`` input. Padded tokens are left out: by the
model's definition they contribute nothing (their keys are masked out and
their outputs zeroed), so a step that skips them does all of this work.
Every input takes a gradient (the rows are trained), so the backward takes
two products of each. Two FLOPs a multiply-add.

The expectations over the history lengths are exact, from the traffic's
length law (``generators/behavior.py`` ``lengths``: ``min_len`` plus a
Zipf rank over ``[0, max_len - min_len]``, the weights ``k^-a``), read
from ``traffic/amazon_books_behavior.json``: ``E[n + 1]`` about 14.74,
``E[(n + 1)^2]`` about 539.
"""
from __future__ import annotations

import json
from pathlib import Path

from perfbench.reference import bst

MIX = Path(__file__).resolve().parent.parent / "traffic" / \
    "amazon_books_behavior.json"
_TOKENWISE = ("block.attention.qkv", "block.attention.out", "block.ffn_in",
              "block.ffn_out")


def token_moments(cfg: dict):
    """``(E[n + 1], E[(n + 1)^2])`` of the mix's history lengths, cut at
    the configuration's history length."""
    with open(MIX) as f:
        mix = json.load(f)
    lo = int(mix["min_len"])
    hi = min(int(mix["max_len"]), bst.history_length(cfg))
    a = float(mix["length_exponent"])
    w = [k ** -a for k in range(1, hi - lo + 2)]
    tokens = [lo + k + 1 for k in range(hi - lo + 1)]
    total = sum(w)
    return (sum(p * t for p, t in zip(w, tokens)) / total,
            sum(p * t * t for p, t in zip(w, tokens)) / total)


def forward_macs(cfg: dict, moments=None):
    """``(token-wise, attention, tower)`` multiply-adds of an example's
    forward, the first two expected over the history lengths
    (``moments``: ``(E[n + 1], E[(n + 1)^2])``, by default
    :func:`token_moments`)."""
    _, d, _ = bst.widths(cfg)
    per_token = tower = 0
    for name, shape, _ in bst.params(cfg):
        if name.endswith(".weight") and len(shape) == 2 and \
                not name.startswith("pos_emb"):
            if name.rsplit(".", 1)[0] in _TOKENWISE:
                per_token += shape[0] * shape[1]
            else:
                tower += shape[0] * shape[1]
    tokens, pairs = moments or token_moments(cfg)
    return per_token * tokens, 2 * d * pairs, tower


def train_flops_per_example(cfg: dict) -> float:
    return 2 * 3 * sum(forward_macs(cfg))


def attention_flops_per_example(cfg: dict) -> float:
    """``Q K^T`` and ``A V`` over the valid pairs, forward and backward."""
    return 2 * 3 * forward_macs(cfg)[1]


def attention_bytes_per_example(cfg: dict) -> float:
    """The bytes the attention must move at the valid tokens, each read
    or written once: the forward reads ``Q``, ``K``, ``V`` and writes the
    output and each head's log-sum-exp; the backward reads ``Q``, ``K``,
    ``V``, the output, its gradient and the log-sum-exp, and writes the
    gradients of ``Q``, ``K`` and ``V``. float32."""
    _, d, _ = bst.widths(cfg)
    h = cfg["heads"]
    tokens, _ = token_moments(cfg)
    return 4 * tokens * ((4 * d + h) + (5 * d + h + 3 * d))
