"""The first training steps of a cell, in plain PyTorch, and what the
comparison reads from them.

Set-up fills the table through the collection's own lookup-or-create,
space by space: every valid lane of the pool ``admission_passes`` times,
then every id of the space's range ``admission_passes`` times. Every key
of the dataset is then in the table and admitted by CounterFilter(2), its
row is its initial row, its optimizer slots their initial values, its
frequency ``passes * (1 + its count of lanes in the pool)``. The
reference starts from that state, worked out again here, and follows the
first three steps: each one-id column's row the id's (mean of one id),
each history position's the id's (zeros at padding), the model's forward
(``reference/<model>.py``), the mean sigmoid cross-entropy plus
``aux_loss_weight`` times the auxiliary loss where the model has one,
autograd, and the configuration's ``optimizer``, sparse on the table
(each row's gradient the sum over its lanes) and dense on the parameters:

* ``adagrad``: sparse ``a += g^2; v -= lr * g * rsqrt(a)`` from ``a =
  0.1``; dense ``a += g^2; p -= lr * g * rsqrt(a + 1e-7)`` from ``a =
  0.1``;
* ``adam`` (``b1, b2, eps`` from the configuration's ``adam``): sparse, on
  the rows the step holds alone, ``m = b1 m + (1 - b1) g; v = b2 v + (1 -
  b2) g^2; v_row -= lr sqrt(1 - b2^t) / (1 - b1^t) * m / (sqrt(v) +
  eps)``; dense, on every parameter, ``m`` and ``v`` alike and ``p -= lr
  * (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)``; ``t`` the step,
  from 1, and ``m = v = 0`` before the first.

:class:`KeySet` is the reference's own key -> row map over the checked
batches: each space's distinct raw ids, sorted, one space after another.
:func:`readings` returns what the comparison reads: each step's loss, the
norm of each leaf's first gradient, the norm of each leaf's change after
the three steps, and each key's frequency.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from . import ctr
from .keys import column_keys, initial_rows


class KeySet:
    """Distinct raw ids of each space over ``batches``. ``spaces``: each
    with its ``name`` and ``columns`` (``core.traffic.Space``), in the
    order of the program's salt groups. Ids below 0 are padding."""

    def __init__(self, spaces: Sequence, batches: Sequence[dict]):
        self.spaces = [(s.name, list(s.columns)) for s in spaces]
        # the column under which the program keys each space
        self.columns = [cols[0] for _, cols in self.spaces]
        cols = [c for _, cs in self.spaces for c in cs]
        self.one_id = [c for c in cols if np.ndim(batches[0][c]) == 1]
        self.history = [c for c in cols if np.ndim(batches[0][c]) == 2]
        self.ids = []
        for _, cs in self.spaces:
            x = np.concatenate([np.asarray(b[c], np.int64).reshape(-1)
                                for c in cs for b in batches])
            self.ids.append(np.unique(x[x >= 0]))
        self.offsets = np.cumsum([0] + [len(x) for x in self.ids])
        self._space = {c: s for s, (_, cs) in enumerate(self.spaces)
                       for c in cs}

    def __len__(self) -> int:
        return int(self.offsets[-1])

    def rows(self, batch: dict, n: int) -> Dict[str, np.ndarray]:
        """Each id column's rows of the first ``n`` examples (``[n]`` or
        ``[n, L]``), -1 at padding."""
        out = {}
        for c in self.one_id + self.history:
            s = self._space[c]
            x = np.asarray(batch[c][:n], np.int64)
            r = self.offsets[s] + np.searchsorted(self.ids[s], x)
            out[c] = np.where(x >= 0, r, -1)
        return out

    def lanes(self, batch: dict, n: int) -> np.ndarray:
        """The rows of every valid lane of the first ``n`` examples."""
        flat = np.concatenate([r.reshape(-1)
                               for r in self.rows(batch, n).values()])
        return flat[flat >= 0]

    def member(self, batch: dict, n: int) -> np.ndarray:
        """bool ``[len]``: keys that occur in the first ``n`` examples."""
        out = np.zeros(len(self), bool)
        out[self.lanes(batch, n)] = True
        return out


def pool_counts(keyset: KeySet, pool, device) -> np.ndarray:
    """Each key's count of lanes in the pool (``pool.spaces``: each
    space's raw ids, in the keyset's order)."""
    out = []
    for space, ids in zip(pool.spaces, keyset.ids):
        col = torch.sort(torch.from_numpy(space.ids).to(device)).values
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


class _Adagrad:
    """The sparse and the dense Adagrad (see the module docstring)."""

    def __init__(self, cfg, table, params):
        self.lr = float(cfg["learning_rate"])
        self.tacc = torch.full_like(table, 0.1)
        self.pacc = {n: torch.full_like(w, 0.1) for n, w in params.items()}

    def sparse(self, table, g, touched, t):
        self.tacc += g * g
        table -= self.lr * g * torch.rsqrt(self.tacc)

    def dense(self, params, grads, t):
        for k, g in grads.items():
            self.pacc[k] += g * g
            params[k] -= self.lr * g * torch.rsqrt(self.pacc[k] + 1e-7)


class _Adam:
    """The sparse (lazy: the step's rows alone) and the dense Adam."""

    def __init__(self, cfg, table, params):
        self.lr = float(cfg["learning_rate"])
        a = cfg["adam"]
        self.b1, self.b2, self.eps = (float(a["beta1"]), float(a["beta2"]),
                                      float(a["epsilon"]))
        self.tm, self.tv = torch.zeros_like(table), torch.zeros_like(table)
        self.pm = {n: torch.zeros_like(w) for n, w in params.items()}
        self.pv = {n: torch.zeros_like(w) for n, w in params.items()}

    def sparse(self, table, g, touched, t):
        b1, b2 = self.b1, self.b2
        m = b1 * self.tm + (1.0 - b1) * g
        v = b2 * self.tv + (1.0 - b2) * g * g
        alpha = self.lr * math.sqrt(1.0 - b2 ** t) / (1.0 - b1 ** t)
        new = table - alpha * m / (torch.sqrt(v) + self.eps)
        on = touched[:, None]
        table.copy_(torch.where(on, new, table))
        self.tm = torch.where(on, m, self.tm)
        self.tv = torch.where(on, v, self.tv)

    def dense(self, params, grads, t):
        b1, b2 = self.b1, self.b2
        c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        for k, g in grads.items():
            self.pm[k] = (1.0 - b1) * g + b1 * self.pm[k]
            self.pv[k] = (1.0 - b2) * g * g + b2 * self.pv[k]
            params[k] -= self.lr * (self.pm[k] / c1) / (
                torch.sqrt(self.pv[k] / c2) + self.eps)


OPTIMIZERS = {"adagrad": _Adagrad, "adam": _Adam}


def readings(cfg: dict, weights: Dict[str, torch.Tensor],
             batches: Sequence[dict], keyset: KeySet, freq0: np.ndarray,
             device, tf32: bool = False, half: bool = False) -> dict:
    """The reference's readings of the steps over ``batches``. ``freq0``:
    each key's frequency before them. ``tf32`` computes the products in
    TF32 (the control); ``half`` keeps the first half of every batch (a
    fault)."""
    model = ctr.model(cfg)
    d = cfg["emb_dim"]
    keys = torch.cat([column_keys(c, torch.from_numpy(ids).to(device))
                      for c, ids in enumerate(keyset.ids)])
    table = initial_rows(keys, d)
    table0 = table.clone()
    params = {n: w.detach().clone() for n, w in weights.items()}
    opt = OPTIMIZERS[cfg["optimizer"]](cfg, table, params)
    freq = freq0.copy()
    losses: List[float] = []
    grad: Dict[str, float] = {}
    with matmul_precision(tf32):
        for step, b in enumerate(batches):
            n = len(b["label"]) // 2 if half else len(b["label"])
            rows_np = keyset.rows(b, n)
            lanes = keyset.lanes(b, n)
            np.add.at(freq, lanes, 1)
            one = torch.from_numpy(np.stack([rows_np[c] for c in
                                             keyset.one_id], 1)).to(device)
            leaf = table.clone().requires_grad_(True)
            live = {k: v.clone().requires_grad_(True)
                    for k, v in params.items()}
            inputs = {"names": keyset.one_id, "emb": leaf[one], "seq": {},
                      "dense": None}
            for c in keyset.history:
                r = torch.from_numpy(rows_np[c]).to(device)
                mask = r >= 0
                inputs["seq"][c] = (torch.where(
                    mask[..., None], leaf[r.clamp_min(0)], 0.0), mask)
            if cfg.get("dense_names"):
                dense = torch.stack([torch.from_numpy(np.asarray(b[x][:n]))
                                     for x in cfg["dense_names"]],
                                    1).to(device)
                inputs["dense"] = torch.log1p(
                    torch.clamp_min(dense.float(), 0.0))
            y = torch.from_numpy(np.asarray(b["label"][:n])).to(device)
            z, aux = model.forward(cfg, live, inputs, True)
            loss = torch.mean(-y * F.logsigmoid(z)
                              - (1.0 - y) * F.logsigmoid(-z))
            if aux is not None:
                loss = loss + float(cfg["aux_loss_weight"]) * aux
            names = list(live)
            gs = torch.autograd.grad(loss, [leaf] + [live[k] for k in names])
            with torch.no_grad():
                if step == 0:
                    grad = {k: float(g.double().norm())
                            for k, g in zip(names, gs[1:])}
                    grad["emb"] = float(gs[0].double().norm())
                touched = torch.zeros(len(keyset), dtype=torch.bool,
                                      device=device)
                touched[torch.from_numpy(lanes).to(device)] = True
                opt.sparse(table, gs[0], touched, step + 1)
                opt.dense(params, dict(zip(names, gs[1:])), step + 1)
            losses.append(float(loss.detach()))
    change = {k: float((params[k] - weights[k]).double().norm())
              for k in params}
    change["emb"] = float((table - table0).double().norm())
    return {"loss": losses, "grad": grad, "change": change,
            "index_misses": 0, "freqs": freq}
