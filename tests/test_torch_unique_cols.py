"""Port parity: ``ops.unique.unique_cols``, the column-parallel dedup of a
feature-major ``[W, B]`` batch, against the JAX package's, bit-equal:
unique keys (row-major group order), inverse, counts, n_unique and
n_overflow, on the four cases of ``tests/test_unique_cols.py`` (random
columns, EMPTY lanes, a cap far below the uniques, a row of one key), each
with and without a ``max_unique`` cap."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeprec_tpu.ops.unique import unique_cols as junique_cols
from deeprec_tpu.sparse import keys as JK

from deeprec_tpu_torch.ops.unique import unique as tunique
from deeprec_tpu_torch.ops.unique import unique_cols as tunique_cols

torch.set_num_threads(1)


def _random(rng):
    # per-column disjoint spaces, negative keys and keys past 2^32 among them
    return np.stack([rng.integers(-40, 50, 64) + (c << 33) - (c % 2 << 40)
                     for c in range(6)]).astype(np.int64)


def _with_empty(rng):
    arr = np.stack([rng.integers(1, 30, 32) + (c << 33)
                    for c in range(4)]).astype(np.int64)
    arr[arr % 5 == 0] = -1  # EMPTY padding scattered through
    return arr


def _overflow(rng):
    return np.stack([rng.integers(0, 1 << 40, 128) + (c << 50)
                     for c in range(4)]).astype(np.int64)  # ~all unique


def _one_key_rows(rng):
    arr = np.stack([np.full(16, 7 + (c << 33)) for c in range(3)])
    arr[1] = rng.integers(0, 5, 16) + (1 << 33)
    return arr.astype(np.int64)


CASES = {"random": (_random, 40), "empty": (_with_empty, 20),
         "overflow": (_overflow, 64), "one_key_rows": (_one_key_rows, 3)}


@pytest.mark.parametrize("capped", [False, True], ids=["exact", "capped"])
@pytest.mark.parametrize("case", list(CASES))
def test_unique_cols_bit_equal(case, capped):
    make, cap = CASES[case]
    arr = make(np.random.default_rng(len(case)))
    mu = cap if capped else None
    hi, lo = JK.split_np(arr)
    ref = junique_cols(JK.Keys(jnp.asarray(hi), jnp.asarray(lo)), mu)
    got = tunique_cols(torch.from_numpy(arr), mu)
    np.testing.assert_array_equal(got.ukeys.numpy(),
                                  JK.to_numpy(ref.ukeys))
    np.testing.assert_array_equal(got.inverse.numpy(),
                                  np.asarray(ref.inverse))
    np.testing.assert_array_equal(got.counts.numpy(),
                                  np.asarray(ref.counts))
    assert int(got.n_unique) == int(ref.n_unique)
    assert int(got.n_overflow) == int(ref.n_overflow)
    if capped and case == "overflow":
        assert int(got.n_overflow) > 0
    # the flat dedup finds the same key -> count map
    flat = tunique(torch.from_numpy(arr.reshape(-1)))
    live = got.ukeys != -1
    if not capped:
        assert dict(zip(got.ukeys[live].tolist(),
                        got.counts[live].tolist())) == \
            {k: c for k, c in zip(flat.ukeys.tolist(), flat.counts.tolist())
             if k != -1}
