"""Behaviour traffic in the zoo's format (``data/behavior.py``): ``uid``,
``item``, ``cate`` int64 ``[B]``; ``hist_item`` and ``hist_cate`` int64
``[B, L]``, right-padded with -1; ``label`` float32 ``[B]``.

A mix gives ``spaces``, a list of ``{"name", "count"}`` over ``items``,
``categories`` and ``users``, in the order of the program's salt groups
(DIN and DIEN list ``item``, then ``cate``, then ``uid``), and one Zipf
exponent a space (``zipf_exponents``), each the fit
(``core.traffic.fit_exponent``) of the space's count over the mix's
``rows``. Everything is drawn from ``--seed`` on the device in a few
large calls:

* a user, a candidate item and each history position's item: a Zipf rank
  of its space (``core.traffic._zipf_ranks``, head ``zipf_head``) and the
  rank -> id bijection of ``core/traffic.py``;
* each item's category: a fixed map, the Zipf rank of the categories'
  law at a hash of the item id, so ``hist_cate`` agrees with
  ``hist_item`` and ``cate`` with ``item``;
* each history's length, ``min_len`` plus a Zipf rank over ``[0, max_len
  - min_len]`` of exponent ``length_exponent`` (short histories common,
  long ones rare; 0: every length alike);
* the label: a Bernoulli draw of ``sigmoid(label_bias + label_id_weight
  * (w(item) + w(uid)) + label_match_weight * m + label_noise * z)``,
  ``w`` a hash of the rank in ``[-1, 1)``, ``m`` the share of the
  history's behaviours in the candidate's category: the loss is
  learnable, and the attention over the history has something to find.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from perfbench.core.traffic import (Pool, Space, _hash_unit, _zipf_ranks,
                                    multiplier)

COLUMNS = {"items": ["item", "hist_item"], "categories": ["cate", "hist_cate"],
           "users": ["uid"]}
_CATE_SALT, _ITEM_SALT, _USER_SALT = 0x2545F491, 0x6C8E9CF5, 0x3C6EF372


def _ids(ranks: torch.Tensor, v: int) -> torch.Tensor:
    return (ranks * multiplier(v) + v // 3) % v


def categories(items: torch.Tensor, v: int, a: float,
               head: int) -> torch.Tensor:
    """The category id of each item id in ``items`` (``v`` categories,
    exponent ``a``): a function of the item alone."""
    u = (_hash_unit(items, _CATE_SALT) + 1.0) / 2.0
    return _ids(_zipf_ranks(u, v, a, head), v)


def lengths(mix: dict, u: torch.Tensor) -> torch.Tensor:
    """History lengths in ``[min_len, max_len]`` from uniforms ``u``."""
    lo, hi = int(mix["min_len"]), int(mix["max_len"])
    return lo + _zipf_ranks(u, hi - lo + 1, float(mix["length_exponent"]),
                            int(mix["zipf_head"]))


def draw(mix: dict, n: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """The pool's columns on ``device`` from ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & (2 ** 63 - 1))
    law = {s["name"]: (int(s["count"]), float(a))
           for s, a in zip(mix["spaces"], mix["zipf_exponents"])}
    head, L = int(mix["zipf_head"]), int(mix["max_len"])
    u = torch.rand((n, 3 + L), generator=g, dtype=torch.float64,
                   device=device)
    z = torch.randn((n,), generator=g, dtype=torch.float64, device=device)
    ub = torch.rand((n,), generator=g, dtype=torch.float64, device=device)
    (vi, ai), (vc, ac), (vu, au) = (law["items"], law["categories"],
                                    law["users"])
    user_r = _zipf_ranks(u[:, 0], vu, au, head)
    item_r = _zipf_ranks(u[:, 1], vi, ai, head)
    hist_r = _zipf_ranks(u[:, 3:].reshape(-1), vi, ai, head).view(n, L)
    valid = torch.arange(L, device=device)[None, :] < \
        lengths(mix, u[:, 2])[:, None]
    item, hist_item = _ids(item_r, vi), _ids(hist_r, vi)
    cate = categories(item, vc, ac, head)
    hist_cate = categories(hist_item, vc, ac, head)
    match = ((hist_cate == cate[:, None]) & valid).sum(1).double() / \
        valid.sum(1).double()
    logit = (float(mix["label_bias"])
             + float(mix["label_id_weight"]) * (
                 _hash_unit(item_r, _ITEM_SALT)
                 + _hash_unit(user_r, _USER_SALT))
             + float(mix["label_match_weight"]) * match
             + float(mix["label_noise"]) * z)
    pad = torch.full_like(hist_item, -1)
    return {"uid": _ids(user_r, vu), "item": item, "cate": cate,
            "hist_item": torch.where(valid, hist_item, pad),
            "hist_cate": torch.where(valid, hist_cate, pad),
            "label": (ub < torch.sigmoid(logit)).to(torch.float32)}


def distinct_per_batch(keys: torch.Tensor, batch: int) -> List[int]:
    """Distinct non-negative keys in each batch of ``keys [n, W]`` (-1:
    padding)."""
    srt = torch.sort(keys.reshape(-1, batch * keys.shape[1]), dim=1).values
    new = torch.ones_like(srt, dtype=torch.bool)
    new[:, 1:] = srt[:, 1:] != srt[:, :-1]
    return [int(c) for c in (new & (srt >= 0)).sum(1).tolist()]


def make_pool(mix: dict, n: int, batch: int, seed: int, device) -> Pool:
    """The pool of ``n`` examples; the device arrays are freed before it
    returns."""
    cols = draw(mix, n, seed, device)
    spaces, keys = [], []
    nb = n // batch
    for s, sp in enumerate(mix["spaces"]):
        names = COLUMNS[sp["name"]]
        lanes = torch.cat([cols[c].view(n, -1) for c in names], 1)
        keys.append(torch.where(lanes >= 0, lanes + (s << 40), -1))
        flat = lanes.reshape(-1)
        per = (lanes >= 0).view(nb, -1).sum(1)
        ends = np.concatenate([[0], np.cumsum(per.cpu().numpy())])
        spaces.append(Space(sp["name"], names, int(sp["count"]),
                            flat[flat >= 0].cpu().numpy(), ends))
    keys = torch.cat(keys, 1)
    uniq = distinct_per_batch(keys, batch)
    valid = (keys >= 0).view(nb, -1).sum(1).tolist()
    host = {k: v.cpu().numpy() for k, v in cols.items()}
    del cols, keys
    batches = [{k: v[s:s + batch] for k, v in host.items()}
               for s in range(0, n, batch)]
    return Pool(batches, uniq, batch, [int(v) for v in valid],
                3 + 2 * int(mix["max_len"]), spaces)
