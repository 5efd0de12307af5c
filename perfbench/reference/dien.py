"""DIEN in plain PyTorch: the port's equations (``models/sequence.py``
``DIEN`` with ``modelzoo/DIEN/train.py``'s widths), written out here.

Zhou et al., "Deep Interest Evolution Network for Click-Through Rate
Prediction", AAAI 2019, arXiv:1809.03672; DeepRec ``modelzoo/dien``.
The candidate is ``c = [emb(x) for x in candidate]``, each history
position ``e_t = [emb(x_t) for x in history]``, valid where the first
history column is (``mask``); ``g = gru_units``.

* Interest extraction, a GRU from ``h_0 = 0``: ``z, r = sigmoid(W_g [e_t,
  h] + b_g)`` (``z`` the first ``g`` outputs), ``n = tanh(W_c [e_t, r * h]
  + b_c)``, ``h' = (1 - z) * h + z * n``; a padded step holds ``h``. The
  states ``s_t`` are the ``h`` after each step.
* Attention: ``q = W_p c + b_p``; DIN's scores ``a_t = att_out(sigmoid(
  att_1(sigmoid(att_0([q, s_t, q - s_t, q * s_t])))))``, unscaled, and a
  softmax over the valid positions (padding at -1e9, its weight then 0).
* Interest evolution, an AUGRU over ``s_t``: the same cell with ``z``
  scaled by ``a_t``; its last state ``f``.
* The tower: ``[c, f, sum_t e_t, context]`` through ``fc_i`` each followed
  by Dice (``p * x + (1 - p) * alpha * x``, ``p = sigmoid((x - mean) /
  sqrt(var + 1e-9))``, the batch's mean and population variance in
  training), then ``out``: the logit.
* The auxiliary loss: ``s_t`` scores behaviour ``t + 1`` through ONE shared
  ``aux_proj``, ``pos_t = s_t . (W_a e_{t+1} + b_a)``, against a negative,
  the same position of the previous example in the batch (a roll over
  the batch, padding included), ``neg_t``; ``aux = -sum_t m_{t+1}
  (log(sigmoid(pos_t) + 1e-8) + log(1 - sigmoid(neg_t) + 1e-8)) / max(sum
  m_{t+1}, 1)``.

Where this departs from the published DIEN code (``script/model.py``):
its auxiliary net is an MLP 100-50-2 with a softmax over ``[h_t,
e_{t+1}]`` and its negatives are sampled non-clicked items, here one shared
linear projection, a dot product and the batch's roll; its tower takes a
BatchNorm first, ``item * history sum`` besides, and ends in two
softmax outputs, here no BatchNorm, no product and one sigmoid logit; its
query projection is followed by a PReLU, here none.
"""
from __future__ import annotations

from typing import Dict

import torch

from .ctr import linear_params


def _widths(cfg: dict):
    e = cfg["emb_dim"]
    d = e * len(cfg["candidate"])
    return d, cfg["gru_units"], e * len(cfg["context"])


def params(cfg: dict) -> list:
    d, g, ctx = _widths(cfg)
    att = [4 * g, *cfg["att_units"]]
    tower = [2 * d + g + ctx, *cfg["hidden_units"]]
    layers = ([("interest_extractor.cell.gates", d + g, 2 * g),
               ("interest_extractor.cell.cand", d + g, g),
               ("cand_proj", d, g)]
              + [(f"att.att.{i}", a, b)
                 for i, (a, b) in enumerate(zip(att[:-1], att[1:]))]
              + [("att.att_out", att[-1], 1),
                 ("interest_evolution.cell.gates", 2 * g, 2 * g),
                 ("interest_evolution.cell.cand", 2 * g, g),
                 ("aux_proj", d, g)]
              + [(f"fc.{i}", a, b)
                 for i, (a, b) in enumerate(zip(tower[:-1], tower[1:]))])
    return (linear_params(layers)
            + [(f"dice.{i}.alpha", (u,), "zeros")
               for i, u in enumerate(cfg["hidden_units"])]
            + linear_params([("out", tower[-1], 1)]))


def _dense(w: Dict[str, torch.Tensor], name: str, x: torch.Tensor):
    return x @ w[f"{name}.weight"].T + w[f"{name}.bias"]


def _cell(w, name: str, h, x, a=None):
    g = h.shape[-1]
    zr = torch.sigmoid(_dense(w, f"{name}.gates", torch.cat([x, h], -1)))
    z, r = zr[..., :g], zr[..., g:]
    n = torch.tanh(_dense(w, f"{name}.cand", torch.cat([x, r * h], -1)))
    if a is not None:
        z = a[:, None] * z
    return (1.0 - z) * h + z * n


def _dice(x, alpha, train: bool):
    if not train:
        raise ValueError("the reference follows training steps only")
    mean, var = x.mean(0), x.var(0, unbiased=False)
    p = torch.sigmoid((x - mean) / torch.sqrt(var + 1e-9))
    return p * x + (1.0 - p) * alpha * x


def forward(cfg: dict, w: Dict[str, torch.Tensor], inputs: dict,
            train: bool):
    one = {n: inputs["emb"][:, i] for i, n in enumerate(inputs["names"])}
    seq = inputs["seq"]
    cand = torch.cat([one[c] for c in cfg["candidate"]], -1)
    hist = torch.cat([seq[c][0] for c in cfg["history"]], -1)
    mask = seq[cfg["history"][0]][1]
    b, L = mask.shape
    g = cfg["gru_units"]

    h = hist.new_zeros((b, g))
    states = []
    for t in range(L):
        h = torch.where(mask[:, t, None],
                        _cell(w, "interest_extractor.cell", h, hist[:, t]),
                        h)
        states.append(h)
    s = torch.stack(states, 1)

    q = _dense(w, "cand_proj", cand)[:, None, :].expand_as(s)
    x = torch.cat([q, s, q - s, q * s], -1)
    for i in range(len(cfg["att_units"])):
        x = torch.sigmoid(_dense(w, f"att.att.{i}", x))
    score = torch.where(mask, _dense(w, "att.att_out", x)[..., 0], -1e9)
    att = torch.where(mask, torch.softmax(score, -1), 0.0)

    f = hist.new_zeros((b, g))
    for t in range(L):
        f = torch.where(mask[:, t, None],
                        _cell(w, "interest_evolution.cell", f, s[:, t],
                              att[:, t]), f)

    m = mask.to(hist.dtype)
    x = torch.cat([cand, f, (hist * m[..., None]).sum(1)]
                  + [one[c] for c in cfg["context"]], -1)
    for i in range(len(cfg["hidden_units"])):
        x = _dice(_dense(w, f"fc.{i}", x), w[f"dice.{i}.alpha"], train)
    logits = _dense(w, "out", x)[:, 0]

    prev, nxt = s[:, :-1], hist[:, 1:]
    pos = (prev * _dense(w, "aux_proj", nxt)).sum(-1)
    neg = (prev * _dense(w, "aux_proj", torch.roll(nxt, 1, 0))).sum(-1)
    m1 = m[:, 1:]
    aux = -(torch.log(torch.sigmoid(pos) + 1e-8)
            + torch.log(1.0 - torch.sigmoid(neg) + 1e-8)) * m1
    return logits, aux.sum() / m1.sum().clamp_min(1.0)
