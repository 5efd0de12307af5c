"""Traffic: a mix is a data file of parameters, read by a generator.

:func:`make_pool` draws a pool of examples from ``--seed`` on the device
and returns it in the program's input format (numpy column arrays, the
dict a ``Trainer.train_step`` takes) cut into batches, with what set-up,
the reference and the readers need of it (:class:`Pool`). A mix that
names a ``generator`` is drawn by ``generators/<generator>.py``, whose
``make_pool(mix, n, batch, seed, device)`` returns a :class:`Pool`; a mix
without one by this module's Criteo generator:

``traffic/<mix>.json`` gives each categorical column's id count, its Zipf
exponent (``zipf_exponents``, one a column, or one ``zipf_exponent`` for
all), and the dense-feature and label model; each column is an embedding
space of its own.

Ids: each column draws a rank ``k`` in ``1..v`` (``v`` its count) from the
Zipf law ``P(k) ~ k^-a`` truncated at ``v`` and renormalised over
``1..v``. Ranks up to ``zipf_head`` come from the exact inverse CDF; deeper
ranks from the continuous (Pareto) inverse over ``[head + 0.5, v + 0.5]``,
the midpoint rule of ``SyntheticCriteo``'s sampler, so the head's mass and
the tail's are consistent. A fixed bijection of ``0..v-1``,
``id = (r * m + c) mod v`` with ``m`` coprime to ``v``, maps each rank to
the id the column emits, so the hottest ids are not the smallest.

Exponents are fitted, not chosen (:func:`fit_exponent`): where a mix gives
the number of rows its counts were read over (``rows``), a column's
exponent is the one under which that many draws of the untruncated law
show the column's count of distinct ids in expectation (the law's
vocabulary growth, Heaps' law). ``python3 -m perfbench.core.traffic
<mix>`` prints the fit of each column.

Dense features are counts, ``floor(exp(mu + sigma * z))``. The label is a
Bernoulli draw of ``sigmoid(bias + id_weight * sum_c w_c(rank) +
dense_weight * sum_j s_j (log1p(x_j) - mu) + noise * z)``, ``w_c`` a hash of
the column and the rank in ``[-1, 1)``: the loss is learnable.
"""
from __future__ import annotations

import importlib
import json
import math
from pathlib import Path
from typing import Dict, List, NamedTuple

import numpy as np
import torch

HERE = Path(__file__).resolve().parent.parent
_M32 = 0xFFFFFFFF


def load_mix(name: str) -> dict:
    """The mix ``traffic/<name>.json``."""
    with open(HERE / "traffic" / f"{name}.json") as f:
        return json.load(f)


class Space(NamedTuple):
    """An embedding space: the columns whose ids share table rows, in the
    order the program's collection lists them (the first names the space
    where set-up looks its ids up), and the ids it holds, ``0..count-1``.
    A pool's spaces come in the order of the program's salt groups: space
    ``s``'s key of id ``x`` is ``x ^ salt(s)`` (``reference/keys.py``)."""
    name: str
    columns: List[str]
    count: int
    ids: np.ndarray    # int64 raw ids of every valid lane, batch by batch
    ends: np.ndarray   # [batches + 1]: batch b is ids[ends[b]:ends[b + 1]]


class Pool(NamedTuple):
    batches: List[Dict[str, np.ndarray]]  # the program's input format
    unique_counts: List[int]  # distinct (space, id) pairs of each batch
    batch: int
    lanes: List[int]          # valid id lanes of each batch (no padding)
    width: int                # id lanes an example, padding included
    spaces: List[Space]


def multiplier(v: int) -> int:
    """The bijection's multiplier for a column of ``v`` ids: coprime to
    ``v``, fixed by ``v`` alone."""
    m = (2654435761 % v) | 1 if v > 2 else 1
    while math.gcd(m, v) != 1:
        m += 2
    return m


_FIT_HEAD = 1 << 20


def zeta(a: float) -> float:
    """Riemann's zeta at ``a > 1`` (the head summed, Euler-Maclaurin's
    tail)."""
    k = np.arange(1, _FIT_HEAD + 1, dtype=np.float64)
    m = float(_FIT_HEAD)
    return float(np.sum(k ** -a)) + m ** (1 - a) / (a - 1) - 0.5 * m ** -a \
        + a / 12 * m ** (-a - 1)


def expected_distinct(a: float, n: int) -> float:
    """Distinct ranks expected in ``n`` draws of the untruncated Zipf law
    of exponent ``a > 1``: the sum over ranks of ``1 - (1 - p_k)^n``, the
    head exact, the tail integrated in its Poisson form."""
    z = zeta(a)
    k = np.arange(1, _FIT_HEAD + 1, dtype=np.float64)
    p = k ** -a / z
    head = float(np.sum(-np.expm1(n * np.log1p(-p))))
    c = n / z
    xs = np.exp(np.linspace(math.log(_FIT_HEAD + 0.5),
                            math.log(_FIT_HEAD + 0.5) + 60.0, 20001))
    f = -np.expm1(-c * xs ** -a)
    tail = float(np.sum((f[1:] + f[:-1]) / 2 * np.diff(xs)))
    return head + tail + c * xs[-1] ** (1 - a) / (a - 1)


def fit_exponent(v: int, n: int) -> float:
    """The exponent under which ``n`` draws show ``v`` distinct ids in
    expectation (bisection; ``expected_distinct`` falls as ``a`` grows)."""
    lo, hi = 1.0 + 1e-6, 30.0
    for _ in range(50):
        mid = 0.5 * (lo + hi)
        if expected_distinct(mid, n) > v:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def exponents(mix: dict) -> List[float]:
    """Each column's exponent."""
    if "zipf_exponents" in mix:
        return [float(a) for a in mix["zipf_exponents"]]
    return [float(mix["zipf_exponent"])] * len(mix["column_counts"])


def _zipf_ranks(u: torch.Tensor, v: int, a: float, head: int) -> torch.Tensor:
    """Zero-based ranks in ``0..v-1`` for uniforms ``u`` in [0, 1)
    (float64), Zipf(a) truncated at ``v``."""
    h = min(head, v)
    k = torch.arange(1, h + 1, dtype=torch.float64, device=u.device)
    w = k ** -a
    head_mass = float(w.sum())
    lo_p = (h + 0.5) ** (1.0 - a)
    tail_mass = 0.0 if h == v else (lo_p - (v + 0.5) ** (1.0 - a)) / (a - 1.0)
    t = u * (head_mass + tail_mass)
    cdf = torch.cumsum(w, 0)
    ranks = torch.searchsorted(cdf, t, right=True)  # 0-based head rank
    if h < v:
        tail = t >= head_mass
        x = (lo_p - (t - head_mass) * (a - 1.0)).clamp_min(1e-300) \
            ** (1.0 / (1.0 - a))
        kt = torch.floor(x + 0.5).clamp(h + 1, v).to(torch.int64) - 1
        ranks = torch.where(tail, kt, ranks)
    return ranks.clamp_max(v - 1)


def _hash_unit(x: torch.Tensor, salt: int) -> torch.Tensor:
    """A uniform in [-1, 1) from int64 ``x`` (32-bit mix, int64 math)."""
    h = (x * 0x9E3779B1 + salt) & _M32
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _M32
    h = h ^ (h >> 16)
    return (h >> 8).to(torch.float64) / float(1 << 23) - 1.0


def draw(mix: dict, n: int, seed: int, device) -> tuple:
    """``(ids [C, n] int64, dense [D, n] float32, label [n] float32)`` on
    ``device`` from ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & (2 ** 63 - 1))
    counts, head = mix["column_counts"], int(mix["zipf_head"])
    nd = len(mix["dense_names"])
    u = torch.rand((len(counts), n), generator=g, dtype=torch.float64,
                   device=device)
    z = torch.randn((nd + 1, n), generator=g, dtype=torch.float64,
                    device=device)
    ub = torch.rand((n,), generator=g, dtype=torch.float64, device=device)
    mu, sigma = float(mix["dense_log_mu"]), float(mix["dense_log_sigma"])
    dense = torch.floor(torch.exp(mu + sigma * z[:nd]))
    sign = torch.tensor([1.0 if j % 2 == 0 else -1.0 for j in range(nd)],
                        dtype=torch.float64, device=device)[:, None]
    logit = float(mix["label_bias"]) + float(mix["label_dense_weight"]) * (
        sign * (torch.log1p(dense) - mu)).sum(0)
    logit = logit + float(mix["label_noise"]) * z[nd]
    ids = torch.empty((len(counts), n), dtype=torch.int64, device=device)
    wid = float(mix["label_id_weight"])
    for c, (v, a) in enumerate(zip(counts, exponents(mix))):
        r = _zipf_ranks(u[c], int(v), a, head)
        logit = logit + wid * _hash_unit(r, 7919 * (c + 1))
        ids[c] = (r * multiplier(int(v)) + int(v) // 3) % int(v)
    label = (ub < torch.sigmoid(logit)).to(torch.float32)
    return ids, dense.to(torch.float32), label


def distinct_per_batch(ids: torch.Tensor, batch: int) -> List[int]:
    """Distinct (column, id) pairs in each batch of ``ids [C, n]``."""
    out = []
    for s in range(0, ids.shape[1], batch):
        srt = torch.sort(ids[:, s:s + batch], dim=1).values
        out.append(int((srt[:, 1:] != srt[:, :-1]).sum()) + srt.shape[0])
    return out


def make_pool(mix: dict, n: int, batch: int, seed: int, device) -> Pool:
    """The pool of ``n`` examples (a multiple of ``batch``) from ``seed``,
    by the mix's ``generator`` (``generators/<name>.py``) or, without
    one, by :func:`criteo_pool`."""
    if n % batch:
        raise ValueError(f"pool of {n} examples is not whole batches of "
                         f"{batch}")
    if "generator" in mix:
        return generator(mix["generator"]).make_pool(mix, n, batch, seed,
                                                     device)
    return criteo_pool(mix, n, batch, seed, device)


def generator(name: str):
    """The module ``generators/<name>.py``."""
    return importlib.import_module(f"perfbench.generators.{name}")


def criteo_pool(mix: dict, n: int, batch: int, seed: int, device) -> Pool:
    """One-id columns, dense counts and labels (:func:`draw`), each column
    its own space. The device arrays are freed before it returns."""
    ids, dense, label = draw(mix, n, seed, device)
    uniq = distinct_per_batch(ids, batch)
    ids_h, dense_h, label_h = ids.cpu().numpy(), dense.cpu().numpy(), \
        label.cpu().numpy()
    del ids, dense, label
    batches = []
    for s in range(0, n, batch):
        b = {"label": label_h[s:s + batch]}
        for j, nm in enumerate(mix["dense_names"]):
            b[nm] = dense_h[j, s:s + batch]
        for c, nm in enumerate(mix["columns"]):
            b[nm] = ids_h[c, s:s + batch]
        batches.append(b)
    ends = np.arange(0, n + 1, batch)
    spaces = [Space(nm, [nm], int(v), ids_h[c], ends) for c, (nm, v) in
              enumerate(zip(mix["columns"], mix["column_counts"]))]
    width = len(mix["columns"])
    return Pool(batches, uniq, batch, [width * batch] * len(batches), width,
                spaces)


if __name__ == "__main__":
    import sys
    m = load_mix(sys.argv[1])
    print(json.dumps([round(fit_exponent(int(v), int(m["rows"])), 6)
                      for v in m["column_counts"]]))
