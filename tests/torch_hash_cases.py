"""Contention cases of the hash index, shared by the CPU parity tests
(``test_torch_hashtable.py``) and the card tests of kernels K4 and K5
(``test_torch_kernels_cuda.py``). Imports no JAX.

Each case inserts batches of deduplicated keys found by search to share
one home bucket, so that claims collide, losers retry, full buckets
advance, the probe bound drops keys and the ``max_probes + w`` round
bound leaves keys failed."""
import numpy as np
import torch

from deeprec_tpu_torch.sparse import keys as TK
from deeprec_tpu_torch.sparse.hashtable import WINDOW


def colliding_keys(cap, n, seed, bucket=0):
    """``n`` distinct int64 keys (negative and > 2^32 ones included, no
    EMPTY) whose home bucket in a ``cap``-slot table is ``bucket``, in a
    random order."""
    rng = np.random.default_rng(seed)
    bmask = cap // min(WINDOW, cap) - 1
    found = np.zeros((0,), np.int64)
    while found.shape[0] < n:
        cand = rng.integers(-2 ** 62, 2 ** 62, 4096 * (bmask + 1))
        home = TK.hash32(torch.from_numpy(cand)).numpy() & bmask
        found = np.unique(np.concatenate([found, cand[home == bucket]]))
        found = found[found != -1]
    rng.shuffle(found)
    return found[:n]


def _pad(keys, rng, n_empty=3):
    """EMPTY padding lanes spread among ``keys`` (ranks count them)."""
    out = np.concatenate([keys, np.full(n_empty, -1, np.int64)])
    rng.shuffle(out)
    return out


def batches(cap, seed, sizes, spread=0):
    """Deduplicated insert batches for a ``cap``-slot table: each batch
    ``sizes[i]`` keys of one home bucket plus ``spread`` keys anywhere,
    EMPTY padding among them; the second and later batches also present
    half of the keys stored by the first."""
    rng = np.random.default_rng(seed)
    out, first = [], None
    for i, n in enumerate(sizes):
        ks = colliding_keys(cap, n, seed * 7 + i)
        if spread:
            ks = np.concatenate([ks, rng.integers(-2 ** 40, 2 ** 40, spread)])
        if first is not None:
            ks = np.concatenate([ks, first[: first.shape[0] // 2]])
        ks = np.unique(ks[ks != -1])
        rng.shuffle(ks)
        first = ks if first is None else first
        out.append(_pad(ks, rng))
    return out


# name: (cap, max_probes, batch sizes, spread keys a batch). cap 8 is one
# bucket of 8 lanes (w = cap): 12 keys fill it a claim a round, and the
# four left advance on the one bucket until the probe bound; cap 64 and
# 256 overfill a home bucket of 16 lanes, so keys advance to buckets of
# their own strides; probe bounds of 1 and 2 drop keys at the bound, and
# 64 keys on one bucket of a 64-slot table at max_probes 4 outlast the
# 4 + 16 rounds.
CONTENTION = {
    "cap8_one_bucket": (8, 32, [12, 6], 0),
    "cap8_probe1": (8, 1, [12], 0),
    "cap64_overfull": (64, 32, [40, 20], 4),
    "cap64_round_bound": (64, 4, [64], 0),
    "cap64_probe1": (64, 1, [30, 10], 6),
    "cap256_probe2": (256, 2, [40, 40], 30),
    "cap256_spread": (256, 32, [24, 24], 80),
}
