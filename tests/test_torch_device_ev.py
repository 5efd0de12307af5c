"""Port parity: the device-index EmbeddingVariable against the JAX
package's ``sparse/embedding_var.py``. ``lookup_or_create`` over a few
steps of skewed id batches (repeats, EMPTY padding, negative keys and keys
past 2^32) under lazy init, CounterFilter, CBF, GlobalStepEvict, a
``max_unique`` cap and eager uniform and normal init: slots, created and
admitted flags, key planes, size, overflow, metadata planes and CBF
counters bit-equal; rows (the store and ``gather``) within ROW_ATOL. Then
``shrink`` (policy and ``keep_mask``), ``grow``, ``export`` /
``import_snapshot``, ``lookup_dense``, ``pooled_lookup`` and
``pooled_lookup_multi_dim`` on the same state."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeprec_tpu import config as jcfg
from deeprec_tpu.sparse import embedding_var as jev
from deeprec_tpu.sparse import keys as JK

from deeprec_tpu_torch import config as tcfg
from deeprec_tpu_torch.sparse import embedding_var as tev

torch.set_num_threads(1)

CAP, DIM, N, STEPS = 256, 4, 96, 4
# uniform init and the optimizer-free rows are bit-equal; normal init goes
# through log/cos, which agree to the last ulps
ROW_ATOL = 1e-6
POOL_ATOL = 1e-6  # sums of a few rows in another order

CONFIGS = {
    "lazy": lambda m: {},
    "counter": lambda m: dict(counter_filter=m.CounterFilter(2)),
    "cbf": lambda m: dict(cbf_filter=m.CBFFilter(filter_freq=3,
                                                 max_element_size=500)),
    "evict": lambda m: dict(evict=m.GlobalStepEvict(2)),
    "capped": lambda m: dict(max_unique=16, track_freq=True,
                             track_version=True),
    "uniform": lambda m: dict(lazy_init=False, initializer=m.Initializer(
        "uniform", scale=0.1, seed=3), fused_slot_columns=2,
        fused_slot_init=0.5),
    "normal": lambda m: dict(lazy_init=False,
                             initializer=m.Initializer("normal", seed=5)),
}


def _configs(kind):
    return tuple(m.EmbeddingVariableConfig(
        name="t", embedding_dim=DIM, capacity=CAP, **CONFIGS[kind](m))
        for m in (jcfg, tcfg))


def _batches(seed, steps=STEPS):
    rng = np.random.default_rng(seed)
    pool = np.concatenate([rng.integers(-(1 << 40), 1 << 40, 60),
                           np.arange(10)])
    pool = pool[pool != -1]
    out = []
    for _ in range(steps):
        ids = pool[np.minimum(rng.zipf(1.3, N) - 1, len(pool) - 1)]
        ids[rng.random(N) < 0.1] = -1
        out.append(ids.astype(np.int64))
    return out


def _same_state(js, ts):
    np.testing.assert_array_equal(ts.index.keys.numpy(),
                                  JK.to_numpy(js.index.stored_keys))
    assert int(ts.index.size.sum()) == int(np.asarray(js.index.size).sum())
    assert int(ts.index.overflow.sum()) == \
        int(np.asarray(js.index.overflow).sum())
    for f in ("freqs", "versions", "create_steps"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), f)
    if js.cbf is None:
        assert ts.cbf is None
    else:
        np.testing.assert_array_equal(ts.cbf.numpy(), np.asarray(js.cbf))
    np.testing.assert_allclose(ts.values.numpy(), np.asarray(js.values),
                               rtol=0, atol=ROW_ATOL)


def _run(kind, steps=STEPS):
    jc, tc = _configs(kind)
    js, ts = jev.create(jc), tev.create(tc, "cpu")
    for step, ids in enumerate(_batches(len(kind), steps)):
        js, ja = jev.lookup_or_create(js, jc, JK.from_numpy(ids),
                                      jnp.asarray(step, jnp.int32))
        ts, ta = tev.lookup_or_create(ts, tc, torch.from_numpy(ids), step)
        np.testing.assert_array_equal(ta.uniq.ukeys.numpy(),
                                      JK.to_numpy(ja.uniq.ukeys))
        for f in ("slots", "admitted", "created"):
            np.testing.assert_array_equal(getattr(ta, f).numpy(),
                                          np.asarray(getattr(ja, f)), f)
        _same_state(js, ts)
        np.testing.assert_allclose(
            tev.gather(ts.values, ta, tc).numpy(),
            np.asarray(jev.gather(js.values, ja, jc)), rtol=0,
            atol=ROW_ATOL)
    return (jc, js, ja), (tc, ts, ta)


@pytest.mark.parametrize("kind", list(CONFIGS))
def test_lookup_or_create_matches_jax(kind):
    (jc, js, ja), (tc, ts, ta) = _run(kind)
    assert int(ts.index.size.sum()) > 0
    if kind in ("counter", "cbf"):  # some keys wait for admission
        assert not bool(ta.admitted[ta.uniq.ukeys != -1].all())
    if kind == "capped":
        assert int(ta.uniq.n_overflow) > 0


@pytest.mark.parametrize("how", ["policy", "keep_mask", "grow"])
def test_shrink_and_grow_match_jax(how):
    (jc, js, _), (tc, ts, _) = _run("evict")
    if how == "grow":
        js, jperm = jev.grow(js, jc, 2 * CAP)
        ts, tperm = tev.grow(ts, tc, 2 * CAP)
    elif how == "policy":
        js, jperm = jev.shrink(js, jc, jnp.asarray(STEPS, jnp.int32))
        ts, tperm = tev.shrink(ts, tc, STEPS)
    else:
        keep = np.random.default_rng(0).random(CAP) < 0.5
        js, jperm = jev.shrink(js, jc, jnp.asarray(STEPS, jnp.int32),
                               keep_mask=jnp.asarray(keep))
        ts, tperm = tev.shrink(ts, tc, STEPS,
                               keep_mask=torch.from_numpy(keep))
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(jperm))
    _same_state(js, ts)
    assert ts.capacity == js.capacity
    # a vacated slot holds zeros: a reused slot reads no stale row
    free = ts.index.keys == -1
    assert bool((ts.values[:-1][free] == 0).all())
    assert float(tev.load_factor(ts)) == float(jev.load_factor(js))


def test_export_and_import_snapshot_match_jax():
    (jc, js, _), (tc, ts, _) = _run("uniform")
    jsnap, tsnap = jev.export(js), tev.export(ts)
    np.testing.assert_array_equal(
        tsnap.keys.numpy(),
        JK.to_numpy(JK.Keys(jsnap.keys_hi, jsnap.keys_lo)))
    np.testing.assert_array_equal(tsnap.live.numpy(), np.asarray(jsnap.live))
    for f in ("values", "versions", "freqs"):
        np.testing.assert_array_equal(getattr(tsnap, f).numpy(),
                                      np.asarray(getattr(jsnap, f)), f)
    # re-import the live rows, shuffled, EMPTY-padded
    live = tsnap.live.numpy()
    order = np.random.default_rng(1).permutation(int(live.sum()))
    keys = np.concatenate([tsnap.keys.numpy()[live][order], [-1, -1]])
    cols = {f: getattr(tsnap, f).numpy()[live][order]
            for f in ("values", "versions", "freqs")}
    cols = {f: np.concatenate([v, np.zeros((2,) + v.shape[1:], v.dtype)])
            for f, v in cols.items()}
    ji = jev.import_snapshot(jc, JK.from_numpy(keys),
                             jnp.asarray(cols["values"]),
                             jnp.asarray(cols["versions"]),
                             jnp.asarray(cols["freqs"]))
    ti = tev.import_snapshot(tc, torch.from_numpy(keys),
                             torch.from_numpy(cols["values"]),
                             torch.from_numpy(cols["versions"]),
                             torch.from_numpy(cols["freqs"]))
    _same_state(ji, ti)


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
def test_dense_and_pooled_lookups_match_jax(combiner):
    jc, tc = _configs("uniform")
    js, ts = jev.create(jc), tev.create(tc, "cpu")
    B, L1, L2 = 4, 3, 8  # N = 96 ids as [B, L1, L2]
    ids = _batches(7, 1)[0]
    js, ja = jev.lookup_or_create(js, jc, JK.from_numpy(ids),
                                  jnp.asarray(0, jnp.int32))
    ts, ta = tev.lookup_or_create(ts, tc, torch.from_numpy(ids), 0)
    np.testing.assert_allclose(
        tev.lookup_dense(ts, tc, ta, (B, L1 * L2)).numpy(),
        np.asarray(jev.lookup_dense(js, jc, ja, (B, L1 * L2))), rtol=0,
        atol=ROW_ATOL)
    w = np.random.default_rng(2).random(N).astype(np.float32)
    sample = np.repeat(np.arange(B), N // B).astype(np.int32)
    for weights in (None, w):
        ref = jev.pooled_lookup(
            js.values, ja, jc, jnp.asarray(sample), B,
            None if weights is None else jnp.asarray(weights), combiner)
        got = tev.pooled_lookup(
            ts.values, ta, tc, torch.from_numpy(sample), B,
            None if weights is None else torch.from_numpy(weights),
            combiner)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=POOL_ATOL)
        ref = jev.pooled_lookup_multi_dim(
            js.values, ja, jc, (B, L1, L2), ("mean", combiner),
            None if weights is None else jnp.asarray(weights))
        got = tev.pooled_lookup_multi_dim(
            ts.values, ta, tc, (B, L1, L2), ("mean", combiner),
            None if weights is None else torch.from_numpy(weights))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=POOL_ATOL)
