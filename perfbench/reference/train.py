"""The first training steps of a cell, in plain PyTorch, and what the
comparison reads from them.

Set-up fills the table through the collection's own lookup-or-create:
every pool batch ``admission_passes`` times, then every id of each
column's range ``admission_passes`` times. Every key of the dataset is
then in the table and admitted by CounterFilter(2), its row is its
initial row, its Adagrad accumulator ``0.1``, its frequency ``passes *
(1 + its count in the pool)``. The reference
starts from that state, worked out again here, and follows the first
three steps: each embedding row the id's (mean of one id), the tower's
forward, the mean sigmoid cross-entropy, autograd, the sparse Adagrad
update ``a += g^2; v -= lr * g * rsqrt(a)`` on the batch's rows (the sum
of each row's gradient over its occurrences) and the dense Adagrad update
``a += g^2; p -= lr * g * rsqrt(a + 1e-7)``.

:class:`KeySet` is the reference's own key -> row map over the checked
batches: each column's distinct raw ids, sorted, one after another.
:func:`readings` returns what the comparison reads: each step's loss, the
norm of each leaf's first gradient, the norm of each leaf's change after
the three steps, and each key's frequency.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from . import ctr
from .keys import column_keys, initial_rows


class KeySet:
    """Distinct raw ids of each column over ``batches``."""

    def __init__(self, columns: Sequence[str], batches: Sequence[dict]):
        self.columns = list(columns)
        self.ids = [np.unique(np.concatenate([np.asarray(b[c], np.int64)
                                              for b in batches]))
                    for c in self.columns]
        self.offsets = np.cumsum([0] + [len(x) for x in self.ids])

    def __len__(self) -> int:
        return int(self.offsets[-1])

    def rows(self, batch: dict, n: int) -> np.ndarray:
        """``[n, columns]`` row of each of the first ``n`` examples' ids."""
        return np.stack([self.offsets[c] + np.searchsorted(
            self.ids[c], np.asarray(batch[name][:n], np.int64))
            for c, name in enumerate(self.columns)], 1)

    def member(self, batch: dict, n: int) -> np.ndarray:
        """bool ``[len]``: keys that occur in the first ``n`` examples."""
        out = np.zeros(len(self), bool)
        out[self.rows(batch, n).reshape(-1)] = True
        return out


def pool_counts(keyset: KeySet, pool_ids: np.ndarray, device) -> np.ndarray:
    """Each key's count in the pool (``pool_ids [columns, n]`` raw ids)."""
    out = []
    for c, ids in enumerate(keyset.ids):
        col = torch.sort(torch.from_numpy(pool_ids[c]).to(device)).values
        q = torch.from_numpy(ids).to(device)
        n = torch.searchsorted(col, q, right=True) - torch.searchsorted(col, q)
        out.append(n.cpu().numpy())
        del col
    return np.concatenate(out).astype(np.int64)


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """float32 products in TF32 (``tf32``) or in full float32."""
    m, c = torch.backends.cuda.matmul, torch.backends.cudnn
    was = (m.allow_tf32, c.allow_tf32)
    m.allow_tf32, c.allow_tf32 = tf32, tf32
    try:
        yield
    finally:
        m.allow_tf32, c.allow_tf32 = was


def readings(cfg: dict, weights: Dict[str, torch.Tensor],
             batches: Sequence[dict], keyset: KeySet, freq0: np.ndarray,
             device, tf32: bool = False, half: bool = False) -> dict:
    """The reference's readings of the steps over ``batches``. ``freq0``:
    each key's frequency before them. ``tf32`` computes the products in
    TF32 (the control); ``half`` keeps the first half of every batch (a
    fault)."""
    lr, d = float(cfg["learning_rate"]), cfg["emb_dim"]
    keys = torch.cat([column_keys(c, torch.from_numpy(ids).to(device))
                      for c, ids in enumerate(keyset.ids)])
    table = initial_rows(keys, d)
    table0 = table.clone()
    tacc = torch.full_like(table, 0.1)
    params = {n: w.detach().clone() for n, w in weights.items()}
    pacc = {n: torch.full_like(w, 0.1) for n, w in params.items()}
    freq = freq0.copy()
    losses: List[float] = []
    grad: Dict[str, float] = {}
    with matmul_precision(tf32):
        for step, b in enumerate(batches):
            n = len(b["label"]) // 2 if half else len(b["label"])
            rows_np = keyset.rows(b, n)
            np.add.at(freq, rows_np.reshape(-1), 1)
            rows = torch.from_numpy(rows_np).to(device)
            dense = torch.stack([torch.from_numpy(np.asarray(b[x][:n]))
                                 for x in cfg["dense_names"]], 1).to(device)
            dense = torch.log1p(torch.clamp_min(dense.float(), 0.0))
            y = torch.from_numpy(np.asarray(b["label"][:n])).to(device)
            leaf = table.clone().requires_grad_(True)
            live = {k: v.clone().requires_grad_(True)
                    for k, v in params.items()}
            z = ctr.forward(cfg, live, dense, leaf[rows])
            loss = torch.mean(-y * F.logsigmoid(z)
                              - (1.0 - y) * F.logsigmoid(-z))
            names = list(live)
            gs = torch.autograd.grad(loss, [leaf] + [live[k] for k in names])
            with torch.no_grad():
                if step == 0:
                    grad = {k: float(g.double().norm())
                            for k, g in zip(names, gs[1:])}
                    grad["emb"] = float(gs[0].double().norm())
                tacc += gs[0] * gs[0]
                table -= lr * gs[0] * torch.rsqrt(tacc)
                for k, g in zip(names, gs[1:]):
                    pacc[k] += g * g
                    params[k] -= lr * g * torch.rsqrt(pacc[k] + 1e-7)
            losses.append(float(loss.detach()))
    change = {k: float((params[k] - weights[k]).double().norm())
              for k in params}
    change["emb"] = float((table - table0).double().norm())
    return {"loss": losses, "grad": grad, "change": change,
            "index_misses": 0, "freqs": freq}
