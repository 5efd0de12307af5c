"""BST in plain PyTorch: the port's equations (``models/sequence.py``
``BST`` with ``modelzoo/BST/train.py``'s widths), written out here.

Chen, Zhao, Li, Huang and Ou, "Behavior Sequence Transformer for
E-commerce Recommendation in Alibaba", DLP-KDD 2019, arXiv:1905.06874.
With ``e = emb_dim``, ``L`` the history length the configuration gives
the entry (``--max_len`` in its ``flags``), ``d = e * (len(candidate) +
1)`` and ``h = heads``:

* Tokens: history slot ``t < L`` is ``[emb(x_t) for x in history] + [P
  r_t]``, the candidate (slot ``L``) ``[emb(x) for x in candidate] + [P
  0]``; ``P`` the position table ``pos_emb.weight [L + 1, e]``, ``r_t``
  the count of valid slots at or after ``t`` where ``t`` is valid (``n -
  t`` for a right-padded history of ``n``), 0 where it is padding. A key
  is valid where the first history column is, and the candidate always.
* The block, post-LN: ``Q, K, V = S W_qkv^T + b_qkv`` (in that order,
  ``h`` heads of ``d / h`` each), ``A_i = softmax(Q_i K_i^T / sqrt(d /
  h))`` over the valid keys, ``MH(S) = [A_i V_i] W_o^T + b_o``; ``S' =
  LN_1(S + MH(S))``; ``F = LN_2(S' + W_2 LeakyReLU(W_1 S' + b_1) + b_2)``,
  LeakyReLU's slope 0.01, ``LN(x) = (x - mean) / sqrt(var + 1e-5) * g +
  b`` over the last axis, the population variance. LN is
  ``F.layer_norm``: written out, autograd through the mean and the
  variance lost up to ~2e-3 of the block's gradients in float32 against
  float64 at the cell's widths (cancellation where the upstream gradient
  lies along the normalised input), where ``F.layer_norm``'s own backward
  stays within ~1e-6.
* The tower: ``F`` set to zero at the padded slots, flattened to ``[B,
  (L + 1) d]``, then ``[flat, context]`` through ``fc_i`` each followed by
  LeakyReLU (slope 0.01), then ``out``: the logit. No auxiliary loss.

Where this departs from the paper: the position feature is the recency
rank, not a bucket of ``t(target) - t(behaviour)`` (the behaviour data has
no timestamps); the block's outputs at padded slots are zeroed before the
flatten (the paper's sequences have no padding); dropout (the paper's
0.2) is the identity, since the comparison follows the program step for
step and cannot draw its masks: the configuration runs ``--dropout 0``;
the paper gives no LeakyReLU slope, LayerNorm epsilon, FFN width nor
embedding width ("4 ~ 64"), so the configuration's ``assumed`` sets them.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from .ctr import linear_params

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SLOPE = 0.01
EPS = 1e-5


def _flag(cfg: dict, name: str, default=None):
    flags = cfg["flags"]
    return flags[flags.index(name) + 1] if name in flags else default


def history_length(cfg: dict) -> int:
    return int(_flag(cfg, "--max_len"))


def widths(cfg: dict):
    """``(e, d, L)``: an embedding's width, the block's, the history's."""
    e = cfg["emb_dim"]
    return e, e * (len(cfg["candidate"]) + 1), history_length(cfg)


def _norm_params(name: str, d: int) -> list:
    return [(f"{name}.weight", (d,), "ones"), (f"{name}.bias", (d,), "zeros")]


def params(cfg: dict) -> list:
    e, d, L = widths(cfg)
    tower = [(L + 1) * d + e * len(cfg["context"]), *cfg["hidden_units"]]
    return ([("pos_emb.weight", (L + 1, e), "lecun")]
            + linear_params([("block.attention.qkv", d, 3 * d),
                             ("block.attention.out", d, d)])
            + _norm_params("block.norm1", d)
            + linear_params([("block.ffn_in", d, cfg["d_ff"]),
                             ("block.ffn_out", cfg["d_ff"], d)])
            + _norm_params("block.norm2", d)
            + linear_params([(f"fc.{i}", a, b) for i, (a, b) in
                             enumerate(zip(tower[:-1], tower[1:]))]
                            + [("out", tower[-1], 1)]))


def _dense(w: Dict[str, torch.Tensor], name: str, x: torch.Tensor):
    return x @ w[f"{name}.weight"].T + w[f"{name}.bias"]


def _norm(w, name: str, x):
    return F.layer_norm(x, x.shape[-1:], w[f"{name}.weight"],
                        w[f"{name}.bias"], EPS)


def forward(cfg: dict, w: Dict[str, torch.Tensor], inputs: dict,
            train: bool):
    if train and float(_flag(cfg, "--dropout", 0.2)) != 0.0:
        raise ValueError("the reference follows training steps without "
                         "dropout only (--dropout 0)")
    one = {n: inputs["emb"][:, i] for i, n in enumerate(inputs["names"])}
    seq = inputs["seq"]
    _, d, L = widths(cfg)
    h = cfg["heads"]
    cand = torch.cat([one[c] for c in cfg["candidate"]], -1)
    hist = torch.cat([seq[c][0] for c in cfg["history"]], -1)
    mask = seq[cfg["history"][0]][1]
    b = mask.shape[0]

    rank = torch.zeros((b, L + 1), dtype=torch.long, device=mask.device)
    for t in range(L):
        later = mask[:, t:].long().sum(1)
        rank[:, t] = torch.where(mask[:, t], later, 0)
    keep = torch.cat([mask, torch.ones_like(mask[:, :1])], 1)
    s = torch.cat([torch.cat([hist, cand[:, None]], 1),
                   w["pos_emb.weight"][rank]], -1)

    qkv = _dense(w, "block.attention.qkv", s)
    q, k, v = (qkv[..., i * d:(i + 1) * d].reshape(b, L + 1, h, d // h)
               .transpose(1, 2) for i in range(3))
    scores = q @ k.transpose(-1, -2) / math.sqrt(d // h)
    scores = torch.where(keep[:, None, None, :], scores, float("-inf"))
    att = torch.softmax(scores, -1) @ v
    mh = _dense(w, "block.attention.out",
                att.transpose(1, 2).reshape(b, L + 1, d))
    s1 = _norm(w, "block.norm1", s + mh)
    ffn = _dense(w, "block.ffn_out", F.leaky_relu(
        _dense(w, "block.ffn_in", s1), SLOPE))
    out = _norm(w, "block.norm2", s1 + ffn) * keep[..., None]

    x = torch.cat([out.reshape(b, -1)] + [one[c] for c in cfg["context"]],
                  -1)
    for i in range(len(cfg["hidden_units"])):
        x = F.leaky_relu(_dense(w, f"fc.{i}", x), SLOPE)
    return _dense(w, "out", x)[:, 0], None
