"""Port parity: the hash index and the dedup against the JAX package.
Integer state must be bit-equal: key planes, slots, created, size,
overflow, unique keys, inverse, counts."""
import numpy as np
import pytest
import torch

from deeprec_tpu.ops import unique as junique
from deeprec_tpu.sparse import hashtable as JH
from deeprec_tpu.sparse import keys as JK

from deeprec_tpu_torch.ops.unique import unique as tunique
from deeprec_tpu_torch.sparse import hashtable as TH
from deeprec_tpu_torch.sparse import keys as TK

torch.set_num_threads(1)


def _distinct_keys(rng, n, hi_range=2**40):
    """n distinct int64 keys (negatives and > 2^32 included, no -1), in a
    random order, plus some EMPTY padding."""
    ks = np.unique(rng.integers(-hi_range, hi_range, 3 * n))
    ks = ks[ks != -1][:n]
    rng.shuffle(ks)
    return np.concatenate([ks, np.full(7, -1, np.int64)])


def _assert_tables_equal(jt, tt):
    np.testing.assert_array_equal(TK.to_numpy(tt.keys),
                                  JK.to_numpy(jt.stored_keys))
    assert int(tt.size.sum()) == int(np.asarray(jt.size).sum())
    assert int(tt.overflow.sum()) == int(np.asarray(jt.overflow).sum())


def _insert_both(jt, tt, keys, max_probes):
    jt, js, jc = JH.lookup_or_insert(jt, JK.from_numpy(keys), max_probes)
    tt, ts, tc = TH.lookup_or_insert(tt, torch.from_numpy(keys), max_probes)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    _assert_tables_equal(jt, tt)
    return jt, tt


@pytest.mark.parametrize("cap,n_first,n_second,max_probes", [
    (1024, 300, 417, 32),   # empty table, then load ~0.7 with re-finds
    (64, 40, 40, 32),       # full buckets: overflow and failed claims
    (256, 150, 100, 2),     # short probe bound: keys dropped at the bound
])
def test_lookup_or_insert_bit_equal(cap, n_first, n_second, max_probes):
    rng = np.random.default_rng(cap + n_first)
    first = _distinct_keys(rng, n_first)
    # the second batch re-presents some stored keys next to new ones
    new = _distinct_keys(rng, n_second, hi_range=2**62)
    second = np.concatenate([first[: n_first // 3], new])
    second = np.unique(second)  # deduplicated, as callers guarantee
    rng.shuffle(second)
    jt, tt = JH.create(cap), TH.create(cap, "cpu")
    jt, tt = _insert_both(jt, tt, first, max_probes)
    jt, tt = _insert_both(jt, tt, second, max_probes)

    probe = np.concatenate([second, _distinct_keys(rng, 50), [-1, -1]])
    js, jf = JH.lookup(jt, JK.from_numpy(probe), max_probes)
    ts, tf = TH.lookup(tt, torch.from_numpy(probe), max_probes)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))


def test_rebuild_bit_equal():
    rng = np.random.default_rng(5)
    keys = _distinct_keys(rng, 180)
    jt, tt = _insert_both(JH.create(256), TH.create(256, "cpu"), keys, 32)
    keep = rng.random(256) < 0.5
    jn, jmap = JH.rebuild(jt, np.asarray(keep), 512)
    tn, tmap = TH.rebuild(tt, torch.from_numpy(keep), 512)
    np.testing.assert_array_equal(tmap.numpy(), np.asarray(jmap))
    _assert_tables_equal(jn, tn)


def _batch_ids(rng, n):
    """Heavy-tailed ids with repeats, EMPTY padding, negatives and keys
    whose lo half has bit 31 set (they sort differently as int64)."""
    base = np.concatenate([rng.integers(-50, 50, 20),
                           rng.integers(0, 2**40, 30),
                           rng.integers(2**31, 2**32, 10),
                           [-1]])
    return base[rng.zipf(1.3, n) % base.shape[0]].astype(np.int64)


@pytest.mark.parametrize("max_unique", [None, 8, 40])
def test_unique_matches_jax(max_unique):
    rng = np.random.default_rng(3)
    ids = _batch_ids(rng, 400)
    j = junique.unique(JK.from_numpy(ids), max_unique)
    t = tunique(torch.from_numpy(ids), max_unique)
    # the port sorts in the JAX (hi, lo) signed-plane order, so even the
    # order of the unique keys is equal
    np.testing.assert_array_equal(TK.to_numpy(t.ukeys), JK.to_numpy(j.ukeys))
    np.testing.assert_array_equal(t.inverse.numpy(), np.asarray(j.inverse))
    np.testing.assert_array_equal(t.counts.numpy(), np.asarray(j.counts))
    assert int(t.n_unique) == int(j.n_unique)
    assert int(t.n_overflow) == int(j.n_overflow)
    ukeys = TK.to_numpy(t.ukeys)
    kept = ~TK.is_empty(t.ukeys)[t.inverse].numpy()
    np.testing.assert_array_equal(ukeys[t.inverse.numpy()][kept], ids[kept])
    if max_unique is not None and max_unique < 60:
        assert int(t.n_overflow) > 0  # the cap really bites
