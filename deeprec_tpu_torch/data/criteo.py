"""Criteo-format input: the file readers and a synthetic stream.

A framework-free copy of ``deeprec_tpu/data/criteo.py`` (the port cannot
import the JAX package): :func:`read_criteo` (a streaming Python reader of
Criteo TSV: label, 13 ints, 26 hex categoricals, into fixed-size numpy
batches), :func:`read_criteo_native` (the same through the C++
``criteo_parse`` of the shared ``native/deeprec_native.cc``, bound in
``utils/native.py``), their FNV-1a + splitmix64 token hash
(:func:`_hash_token`, :func:`_mix64`: Python integers masked to 64 bits,
bit-equal to the native hash), the column names and
:class:`SyntheticCriteo`. ``tests/test_torch_imports.py`` holds the copy
to its source and ``tests/test_torch_keys.py`` the batches.
"""
from __future__ import annotations

import itertools
from typing import Dict, Iterator, Optional, Sequence

import numpy as np

NUM_DENSE = 13
NUM_CAT = 26
DENSE_NAMES = [f"I{i}" for i in range(1, 14)]
CAT_NAMES = [f"C{i}" for i in range(1, 27)]

_M64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64 finalizer — byte-for-byte the native mix64
    (native/deeprec_native.cc:30)."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def _hash_token(tok: str) -> np.int64:
    """Stable 64-bit id for a categorical token (the reference hashes the
    hex strings via string_to_hash_bucket; we keep full 64-bit fidelity).

    IDENTICAL to the native parser's FNV-1a + splitmix hash
    (native/deeprec_native.cc:39 hash_token), so a run may switch between
    :func:`read_criteo` and :func:`read_criteo_native` freely — same bytes,
    same ids (tests/test_criteo_fidelity.py fuzzes the equality)."""
    if not tok:
        return np.int64(-2)  # dedicated "missing" id (must not be -1 = EMPTY)
    h = 1469598103934665603  # FNV-1a offset basis
    for b in tok.encode():
        h = ((h ^ b) * 1099511628211) & _M64
    h = _mix64(h)
    v = h - (1 << 64) if h >= (1 << 63) else h
    return np.int64(-2 if v == -1 else v)


def read_criteo_native(
    path: str,
    batch_size: int,
    num_epochs: int = 1,
    chunk_bytes: int = 8 << 20,
) -> Iterator[Dict[str, np.ndarray]]:
    """Stream batches through the native C++ parser
    (native/deeprec_native.cc criteo_parse — the input-pipeline hot path;
    ~20x the python reader). Falls back to :func:`read_criteo` when the
    toolchain is unavailable; both readers produce IDENTICAL ids (shared
    FNV-1a + splitmix hash; fuzz-checked byte-for-byte in
    tests/test_criteo_fidelity.py), so the fallback is transparent."""
    from ..utils.native import criteo_parse_chunk, get_lib
    if get_lib() is None:
        yield from read_criteo(path, batch_size, num_epochs)
        return
    for _epoch in range(num_epochs):
        acc_l, acc_d, acc_c = [], [], []
        n_acc = 0
        with open(path, "rb") as f:
            rest = b""
            while True:
                chunk = f.read(chunk_bytes)
                if not chunk and not rest:
                    break
                buf = rest + chunk
                if not chunk and buf and not buf.endswith(b"\n"):
                    buf += b"\n"  # final unterminated line
                labels, dense, cats, consumed = criteo_parse_chunk(
                    buf, max_rows=1 << 20)
                rest = buf[consumed:]
                if labels.shape[0] == 0 and not chunk:
                    break
                acc_l.append(labels); acc_d.append(dense); acc_c.append(cats)
                n_acc += labels.shape[0]
                while n_acc >= batch_size:
                    L = np.concatenate(acc_l); D = np.concatenate(acc_d)
                    C = np.concatenate(acc_c)
                    yield _pack_arrays(L[:batch_size], D[:batch_size],
                                       C[:batch_size])
                    acc_l, acc_d, acc_c = [L[batch_size:]], [D[batch_size:]], [C[batch_size:]]
                    n_acc -= batch_size
                if not chunk:
                    break


def _pack_arrays(labels: np.ndarray, dense: np.ndarray, cats: np.ndarray):
    out = {"label": labels}
    for i, nm in enumerate(DENSE_NAMES):
        out[nm] = dense[:, i]
    for i, nm in enumerate(CAT_NAMES):
        out[nm] = cats[:, i]
    return out


def read_criteo(
    path: str,
    batch_size: int,
    num_epochs: int = 1,
    sep: str = "\t",
    drop_remainder: bool = True,
) -> Iterator[Dict[str, np.ndarray]]:
    """Stream batches from a Criteo-format file.

    Yields dicts: label f32 [B], I1..I13 f32 [B], C1..C26 int64 [B].
    """
    for _epoch in range(num_epochs):
        labels, dense, cats = [], [], []
        with open(path, "r") as f:
            for line in f:
                parts = line.rstrip("\n").split(sep)
                if len(parts) < 1 + NUM_DENSE + NUM_CAT:
                    parts = parts + [""] * (1 + NUM_DENSE + NUM_CAT - len(parts))
                labels.append(float(parts[0] or 0))
                dense.append([float(x) if x else 0.0 for x in parts[1:1 + NUM_DENSE]])
                cats.append([_hash_token(t) for t in parts[1 + NUM_DENSE:1 + NUM_DENSE + NUM_CAT]])
                if len(labels) == batch_size:
                    yield _pack(labels, dense, cats)
                    labels, dense, cats = [], [], []
        if labels and not drop_remainder:
            pad = batch_size - len(labels)
            labels += [0.0] * pad
            dense += [[0.0] * NUM_DENSE] * pad
            cats += [[-2] * NUM_CAT] * pad
            yield _pack(labels, dense, cats)


def _pack(labels, dense, cats) -> Dict[str, np.ndarray]:
    out = {"label": np.asarray(labels, np.float32)}
    d = np.asarray(dense, np.float32)
    c = np.asarray(cats, np.int64)
    for i, nm in enumerate(DENSE_NAMES):
        out[nm] = d[:, i]
    for i, nm in enumerate(CAT_NAMES):
        out[nm] = c[:, i]
    return out


class SyntheticCriteo:
    """Synthetic Criteo-like stream with real learnable structure.

    Each categorical feature draws ids from a Zipf-ish distribution over its
    own vocab; the label is a logistic function of hidden per-id weights +
    dense effects + noise, so a good model genuinely lifts AUC above 0.5 and
    bad sparse plumbing shows up as no-lift.
    """

    def __init__(
        self,
        batch_size: int,
        vocab_sizes: Optional[Sequence[int]] = None,
        seed: int = 0,
        noise: float = 1.0,
        zipf_a: float = 1.2,
        weight_seed: int = 1234,
        active_features: Optional[Sequence[int]] = None,
    ):
        self.batch_size = batch_size
        self.vocab_sizes = list(vocab_sizes or [int(x) for x in
                               np.geomspace(100, 200_000, NUM_CAT)])
        self.rng = np.random.default_rng(seed)
        self.noise = noise
        self.zipf_a = zipf_a
        # hidden ground-truth weights: hash-derived (O(1) memory) and seeded
        # INDEPENDENTLY of the data seed, so train/eval streams with
        # different seeds share the same label function.
        self._wseed = weight_seed
        # which categorical features carry label signal (None = all); tests
        # restrict this to the features the model actually consumes so the
        # achievable AUC is high and plumbing bugs are unmissable.
        self.active_features = set(active_features) if active_features is not None else None
        self._cdfs: list = [None] * len(self.vocab_sizes)

    _ZIPF_HEAD = 2048  # atoms drawn exactly; deeper ids use the analytic tail

    def _zipf_tables(self, fi: int):
        """Sampler tables for the TRUNCATED Zipf the stream draws:
        ``min(zipf(a) - 1, v - 1)`` puts all tail mass (k >= v) on the
        last id. Rejection-sampled ``rng.zipf`` costs ~0.6 ms per feature
        per batch on one core (the soak's dominant datagen cost). Here the
        first ``_ZIPF_HEAD`` atoms (>= 80% of the mass at a=1.2) come from
        an exact L1-resident inverse-CDF table; deeper ids use the
        continuous-Pareto analytic inverse with midpoint correction
        (per-atom pmf error O(a/k) < 0.03% at k > 2048 — ids whose
        individual draw probability is ~1e-6). ~20x faster than
        ``rng.zipf`` at an indistinguishable distribution."""
        if self._cdfs[fi] is None:
            a = self.zipf_a
            v = self.vocab_sizes[fi]
            H = min(self._ZIPF_HEAD, v - 1)
            k = np.arange(1, H + 1, dtype=np.float64)
            w = k ** -a
            # tail via the midpoint rule: sum_{k>H} k^-a ~ int_{H+.5} x^-a
            # (relative error O(a/H^2)); using the same form for the mass
            # and the inverse keeps head/tail consistent
            lo_p = (H + 0.5) ** (1 - a)
            total = w.sum() + lo_p / (a - 1)
            head_cdf = np.cumsum(w) / total
            # guide table: per-cell lower bound of searchsorted(cdf, u,
            # 'right'), making the head draw a direct lookup + a few
            # vectorized advances instead of a 4096-wide binary search
            # (the remaining datagen hot spot on a 1-core host)
            G = 16384
            guide = np.searchsorted(head_cdf, np.arange(G) / G,
                                    side="right").astype(np.int32)
            bound = np.concatenate([guide[1:], [H]])
            span = int((bound - guide).max()) + 1
            self._cdfs[fi] = (head_cdf, lo_p, guide, span)
        return self._cdfs[fi]

    def _zipf_draw(self, fi: int, u: np.ndarray) -> np.ndarray:
        head_cdf, lo_p, guide, span = self._zipf_tables(fi)
        v = self.vocab_sizes[fi]
        H = head_cdf.shape[0]
        G = guide.shape[0]
        ids = guide[(u * G).astype(np.int32)].astype(np.int64)
        for _ in range(span):
            adv = (ids < H) & (u >= head_cdf[np.minimum(ids, H - 1)])
            if not adv.any():
                break
            ids += adv
        pm = head_cdf[-1]
        tail = u >= pm
        if tail.any():
            ut = (u[tail] - pm) / max(1.0 - pm, 1e-300)
            # UNNORMALIZED Pareto-tail inverse on [H+0.5, inf): the mass
            # beyond v lands on id v-1 via the same min() clip the
            # rejection sampler applied (7.8% of draws at v=200k, a=1.2).
            # Clamp BEFORE the int cast: ut ~ 1 gives x = inf.
            x = (lo_p * (1.0 - ut)) ** (1.0 / (1.0 - self.zipf_a))
            x = np.minimum(x, float(v))
            ids[tail] = np.minimum(np.floor(x + 0.5).astype(np.int64) - 1,
                                   v - 1)
        return ids

    def _hidden_weight(self, ids: np.ndarray, fi: int) -> np.ndarray:
        h = (ids.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
             + np.uint64(self._wseed + fi * 7919))
        h ^= h >> np.uint64(29)
        h *= np.uint64(0xBF58476D1CE4E5B9)
        h ^= h >> np.uint64(32)
        u = (h >> np.uint64(40)).astype(np.float64) / float(1 << 24)
        return (u - 0.5) * 2.0

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        B = self.batch_size
        out = {}
        logit = np.zeros(B, np.float64)
        nd = len(DENSE_NAMES)
        dense = np.exp(self.rng.standard_normal((nd, B)))
        sign = np.where(np.arange(nd) % 2 == 0, 1.0, -1.0)[:, None]
        logit += (0.05 * sign * (np.log1p(dense) - 0.5)).sum(axis=0)
        for i, nm in enumerate(DENSE_NAMES):
            out[nm] = dense[i].astype(np.float32)
        u = self.rng.random((len(CAT_NAMES), B))
        for fi, nm in enumerate(CAT_NAMES):
            ids = self._zipf_draw(fi, u[fi])
            # spread ids across the 64-bit space per feature
            spread = ids * np.int64(2654435761) + np.int64(fi) * np.int64(1 << 33)
            out[nm] = spread
            if self.active_features is None or fi in self.active_features:
                logit += 0.35 * self._hidden_weight(ids, fi)
        logit += self.rng.normal(0, self.noise, size=B)
        p = 1.0 / (1.0 + np.exp(-logit))
        out["label"] = (self.rng.random(B) < p).astype(np.float32)
        return out

    def take(self, n: int):
        return itertools.islice(self, n)
