"""Port parity: the embedding-variable variants against the JAX package,
module by module, on the same numpy inputs (the JAX side on the CPU).

- ``ops.unique.unique_int32``, the tail padding included: bit-equal.
- Multi-hash: sub-indices bit-equal (keys above 2^32, negative keys and
  EMPTY), ``lookup`` and ``apply_gradients`` for add, mult and concat.
- The JAX ``keys.mod`` fault (ROADMAP C8): the port's sub-index 0 and
  ``hash_bucket_size`` are the full 64-bit ``key % n``, at n = 99,991.
- Dynamic dimension: ``block_mask``, ``gather``, ``effective_dims``.
- Adaptive: ``lookup_or_create`` (warm seeding at admission),
  ``gather_from``, ``apply_gradients``; no admission without frequency
  tracking, as in the JAX package.
- HashTable / Tensible: ``gen_ids_unique`` with and without a CBF,
  ``lookup``, ``reinsert``, Tensible ``gather``/``scatter``/``grow``/
  ``apply_sparse``.

Integer state must be bit-equal; floats within OP_ATOL + OP_RTOL |x| per
operation.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import deeprec_tpu as dr
from deeprec_tpu.ops import unique as junique
from deeprec_tpu.optim import sparse as jsopt
from deeprec_tpu.sparse import adaptive as jad
from deeprec_tpu.sparse import dynamicdim as jdd
from deeprec_tpu.sparse import embedding_var as jev
from deeprec_tpu.sparse import hash_table_api as jhta
from deeprec_tpu.sparse import keys as jkeys
from deeprec_tpu.sparse import multihash as jmh

from deeprec_tpu_torch import config as tcfg
from deeprec_tpu_torch import feature_column as tfc
from deeprec_tpu_torch.ops import unique as tunique
from deeprec_tpu_torch.optim import sparse as tsopt
from deeprec_tpu_torch.sparse import adaptive as tad
from deeprec_tpu_torch.sparse import dynamicdim as tdd
from deeprec_tpu_torch.sparse import embedding_var as tev
from deeprec_tpu_torch.sparse import hash_table_api as thta
from deeprec_tpu_torch.sparse import multihash as tmh

from tests import torch_carry as carry

torch.set_num_threads(1)

# one operation's f32 result, summed in another order: 1e-6 absolute
# plus 1e-6 of the magnitude (an accumulator past 1 moves by ulps of 1e-7)
OP_ATOL = 1e-6
OP_RTOL = 1e-6
DIM = 8


def _ids(rng, n, n_distinct=40, empty_share=0.1):
    """int64 ids with repeats, keys above 2^32, negative keys and EMPTY."""
    pool = np.concatenate([
        rng.integers(0, 1000, n_distinct // 2),
        rng.integers(1 << 33, 1 << 40, n_distinct // 4),
        -rng.integers(2, 1 << 35, n_distinct - n_distinct // 2
                      - n_distinct // 4)]).astype(np.int64)
    ids = rng.choice(pool, n)
    ids[rng.random(n) < empty_share] = -1
    return ids


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@pytest.mark.parametrize("case", ["repeats", "distinct", "one_value"])
def test_unique_int32_matches_jax(case):
    rng = np.random.default_rng(3)
    n = 64
    idx = {"repeats": rng.integers(0, 20, n),
           "distinct": rng.permutation(1000)[:n],
           "one_value": np.full(n, 7)}[case].astype(np.int32)
    ju, ji, jc = junique.unique_int32(jnp.asarray(idx))
    tu, ti, tc = tunique.unique_int32(torch.from_numpy(idx))
    assert tu.dtype == torch.int32
    np.testing.assert_array_equal(_np(tu), np.asarray(ju))
    np.testing.assert_array_equal(_np(ti), np.asarray(ji))
    np.testing.assert_array_equal(_np(tc), np.asarray(jc))
    n_groups = len(np.unique(idx))
    assert (_np(tu)[n_groups:] == np.iinfo(np.int32).max).all()
    assert (_np(tc)[n_groups:] == 0).all() and int(tc.sum()) == n


def _mh_pair(combiner, table_sizes=(256, 64)):
    cfg = dict(name="mh", embedding_dim=DIM, table_sizes=table_sizes,
               combiner=combiner)
    jcfg, tcfg_ = jmh.MultiHashConfig(**cfg), tmh.MultiHashConfig(**cfg)
    js = jmh.create(jcfg)
    return jcfg, js, tcfg_, carry.multihash_state(js)


@pytest.mark.parametrize("table_sizes", [(256, 64), (1000, 37, 5)])
def test_multihash_sub_indices_bit_equal(table_sizes):
    jcfg, _, tcfg_, _ = _mh_pair("add", table_sizes)
    ids = _ids(np.random.default_rng(0), 300)
    jsub = jmh.sub_indices(jcfg, jkeys.from_numpy(ids))
    tsub = tmh.sub_indices(tcfg_, torch.from_numpy(ids))
    for j, tt in zip(jsub, tsub):
        np.testing.assert_array_equal(_np(tt), np.asarray(j))


@pytest.mark.parametrize("combiner", ["add", "mult", "concat"])
def test_multihash_lookup_and_apply_match_jax(combiner):
    jcfg, js, tcfg_, ts = _mh_pair(combiner)
    rng = np.random.default_rng(1)
    jopt = jsopt.sparse_adagrad(0.5, initial_accumulator_value=0.01)
    topt = tsopt.sparse_adagrad(0.5, initial_accumulator_value=0.01)
    jslot = jmh.init_slots(js, jopt)
    tslot = tmh.init_slots(ts, topt)
    for step in range(3):
        ids = _ids(rng, 200)
        jids, tids = jkeys.from_numpy(ids), torch.from_numpy(ids)
        jrows = jmh.lookup(js, jcfg, jids)
        trows = tmh.lookup(ts, tcfg_, tids)
        np.testing.assert_allclose(_np(trows), np.asarray(jrows), rtol=OP_RTOL,
                                   atol=OP_ATOL)
        assert (_np(trows)[ids == -1] == 0).all()
        grads = rng.standard_normal((len(ids), DIM)).astype(np.float32)
        js, jslot = jmh.apply_gradients(js, jcfg, jopt, jslot, jids,
                                        jnp.asarray(grads), jnp.int32(step))
        ts, tslot = tmh.apply_gradients(ts, tcfg_, topt, tslot, tids,
                                        torch.from_numpy(grads), step)
        for jt, tt, jsl, tsl in zip(js.tables, ts.tables, jslot, tslot):
            np.testing.assert_allclose(_np(tt)[:-1], np.asarray(jt),
                                       rtol=OP_RTOL, atol=OP_ATOL)
            assert (_np(tt)[-1] == 0).all()  # the null row stays zero
            np.testing.assert_allclose(_np(tsl["acc"]),
                                       np.asarray(jsl["acc"]), rtol=OP_RTOL,
                                       atol=OP_ATOL)


def test_mod_is_the_full_64bit_key_mod():
    """ROADMAP C8: the JAX ``keys.mod`` overflows int32 for a size that is
    not a power of two and is at least 46,341. The port's multi-hash
    sub-index 0 and ``hash_bucket_size`` map keys above 2^32 and negative
    keys to Python's ``%`` at n = 99,991."""
    n = 99_991
    keys = np.array([(40000 << 32) + 5, -5, (1 << 62) + 12345, -(1 << 40),
                     7, n, -1 - n], np.int64)
    want = np.array([int(k) % n for k in keys], np.int64)
    assert want[0] == 13_964 and want[1] == 99_986
    cfg = tmh.MultiHashConfig("mh", DIM, (n, 64))
    got = tmh.sub_indices(cfg, torch.from_numpy(keys))[0]
    np.testing.assert_array_equal(_np(got), want)
    # the reference disagrees on the first two (the fault this pins down)
    jgot = np.asarray(jkeys.mod(jkeys.from_numpy(keys), n))
    assert jgot[0] == 60_082 and jgot[1] == 46_113
    coll = tfc.EmbeddingCollection(
        [tfc.EmbeddingColumn(tfc.CategoricalColumn("c", hash_bucket_size=n),
                             DIM)], capacity=64)
    batch = {"c": keys}
    np.testing.assert_array_equal(_np(coll._flatten_ids(batch, "cpu")),
                                  want)
    np.testing.assert_array_equal(coll.pack_ids_np(batch)[0], want)


def _ev_runs(jcfg, tcfg_, batches, lookup_j, lookup_t, js, ts):
    """Run the same id batches through both packages' lookups."""
    out = []
    for step, ids in enumerate(batches):
        js, jaux = lookup_j(js, jcfg, jkeys.from_numpy(ids),
                            jnp.int32(step))
        ts, taux = lookup_t(ts, tcfg_, torch.from_numpy(ids), step)
        out.append((jaux, taux))
    return js, ts, out


def _same_ev(jevs, tevs):
    np.testing.assert_array_equal(_np(tevs.index.keys),
                                  carry.keys_np(jevs.index.stored_keys))
    for f in ("freqs", "versions", "create_steps"):
        np.testing.assert_array_equal(_np(getattr(tevs, f)),
                                      np.asarray(getattr(jevs, f)), f)
    np.testing.assert_allclose(_np(tevs.values), np.asarray(jevs.values),
                               rtol=OP_RTOL, atol=OP_ATOL)


def _same_aux(jaux, taux):
    np.testing.assert_array_equal(_np(taux.uniq.ukeys),
                                  carry.keys_np(jaux.uniq.ukeys))
    for f in ("slots", "admitted", "created"):
        np.testing.assert_array_equal(_np(getattr(taux, f)),
                                      np.asarray(getattr(jaux, f)), f)


def test_dynamicdim_mask_gather_and_widths_match_jax():
    dd_args = dict(block_num=2, block_dim=4, freq_thresholds=(0, 3))
    jd, td = jdd.DynamicDimConfig(**dd_args), tdd.DynamicDimConfig(**dd_args)
    jcfg = jdd.ev_config("dd", jd, capacity=256,
                         initializer=dr.Initializer("uniform", scale=0.1))
    tcfg_ = tdd.ev_config("dd", td, capacity=256,
                          initializer=tcfg.Initializer("uniform", scale=0.1))
    assert tcfg_.track_freq is True
    rng = np.random.default_rng(2)
    batches = [_ids(rng, 120, n_distinct=30) for _ in range(4)]
    js, ts, auxs = _ev_runs(jcfg, tcfg_, batches, jev.lookup_or_create,
                            tev.lookup_or_create, jev.create(jcfg),
                            tev.create(tcfg_, "cpu"))
    _same_ev(js, ts)
    jaux, taux = auxs[-1]
    _same_aux(jaux, taux)
    freqs = np.array(js.freqs)
    np.testing.assert_array_equal(
        _np(tdd.block_mask(td, torch.from_numpy(freqs))),
        np.asarray(jdd.block_mask(jd, jnp.asarray(freqs))))
    for cfg_j, cfg_t in ((jcfg, tcfg_), (None, None)):
        np.testing.assert_allclose(
            _np(tdd.gather(ts, td, taux, cfg_t)),
            np.asarray(jdd.gather(js, jd, jaux, cfg_j)), rtol=OP_RTOL,
            atol=OP_ATOL)
    widths = _np(tdd.effective_dims(ts, td, taux))
    np.testing.assert_array_equal(widths,
                                  np.asarray(jdd.effective_dims(js, jd, jaux)))
    assert set(widths.tolist()) == {4, 8}


def _adaptive_pair(buckets=16, filter_freq=3, **kw):
    common = dict(name="ad", embedding_dim=DIM, capacity=256, **kw)
    jcfg = dr.EmbeddingVariableConfig(
        counter_filter=dr.CounterFilter(filter_freq),
        initializer=dr.Initializer("uniform", scale=0.1), **common)
    tcfg_ = tcfg.EmbeddingVariableConfig(
        counter_filter=tcfg.CounterFilter(filter_freq),
        initializer=tcfg.Initializer("uniform", scale=0.1), **common)
    js = jad.create(jcfg, buckets)
    ts = tad.create(tcfg_, buckets, device="cpu")
    assert ts.static.shape == js.static.shape and (_np(ts.static)[-1] == 0).all()
    return jcfg, js, tcfg_, carry.adaptive_state(js)


def test_adaptive_lookup_gather_apply_match_jax():
    jcfg, js, tcfg_, ts = _adaptive_pair()
    rng = np.random.default_rng(4)
    jopt = jsopt.sparse_adagrad(0.5, initial_accumulator_value=0.01)
    topt = tsopt.sparse_adagrad(0.5, initial_accumulator_value=0.01)
    jslot, jst_slot = jopt.init(js.ev.values), jopt.init(js.static)
    tslot, tst_slot = topt.init(ts.ev.values), topt.init(ts.static)
    seeded = 0
    for step in range(6):
        ids = _ids(rng, 150, n_distinct=40)
        js, jaux = jad.lookup_or_create(js, jcfg, jkeys.from_numpy(ids),
                                        jnp.int32(step))
        ts, taux = tad.lookup_or_create(ts, tcfg_, torch.from_numpy(ids),
                                        step)
        _same_aux(jaux, taux)
        _same_ev(js.ev, ts.ev)
        # warm seeding: each newly admitted row holds its bucket's row
        prev = _np(ts.ev.freqs)[_np(taux.slots)] - _np(taux.uniq.counts)
        newly = _np(taux.admitted) & (prev < 3)
        b = _np(tad.bucket_of(taux.uniq.ukeys, 16))
        np.testing.assert_array_equal(
            _np(ts.ev.values)[_np(taux.slots)[newly]],
            _np(ts.static)[b[newly]])
        seeded += int(newly.sum())
        jrows = jad.gather(js, jcfg, jaux)
        trows = tad.gather(ts, tcfg_, taux)
        np.testing.assert_allclose(_np(trows), np.asarray(jrows), rtol=OP_RTOL,
                                   atol=OP_ATOL)
        g = rng.standard_normal(trows.shape).astype(np.float32)
        js, jslot, jst_slot = jad.apply_gradients(
            js, jcfg, jopt, jslot, jopt, jst_slot, jaux, jnp.asarray(g),
            jnp.int32(step))
        ts, tslot, tst_slot = tad.apply_gradients(
            ts, tcfg_, topt, tslot, topt, tst_slot, taux,
            torch.from_numpy(g), step)
        _same_ev(js.ev, ts.ev)
        np.testing.assert_allclose(_np(ts.static), np.asarray(js.static),
                                   rtol=OP_RTOL, atol=OP_ATOL)
        for a, c in ((tslot, jslot), (tst_slot, jst_slot)):
            np.testing.assert_allclose(_np(a["acc"]), np.asarray(c["acc"]),
                                       rtol=OP_RTOL, atol=OP_ATOL)
    assert seeded > 0


def test_adaptive_without_frequency_tracking_admits_nothing():
    """A CounterFilter table without frequency tracking never admits a
    key, in both packages (the frequencies it would test stay 0)."""
    jcfg, js, tcfg_, ts = _adaptive_pair(filter_freq=2, track_freq=False)
    ids = np.array([1, 2, 2, 3, 3, 3] * 4, np.int64)
    for step in range(3):
        js, jaux = jad.lookup_or_create(js, jcfg, jkeys.from_numpy(ids),
                                        jnp.int32(step))
        ts, taux = tad.lookup_or_create(ts, tcfg_, torch.from_numpy(ids),
                                        step)
        _same_aux(jaux, taux)
        assert not bool(taux.admitted.any())


def _ht_keys(rng, n):
    ids = rng.choice(np.concatenate([
        rng.integers(0, 500, 30), rng.integers(1 << 33, 1 << 36, 10),
        -rng.integers(2, 1 << 20, 10)]).astype(np.int64), n)
    ids[rng.random(n) < 0.1] = -1
    return ids


def _same_alloc(ja, ta):
    np.testing.assert_array_equal(_np(ta.index.keys),
                                  carry.keys_np(ja.index.stored_keys))
    np.testing.assert_array_equal(_np(ta.ids), np.asarray(ja.ids))
    assert int(ta.next_id) == int(ja.next_id)
    assert int(ta.index.size.sum()) == int(np.asarray(ja.index.size).sum())
    if ja.cbf is not None:
        np.testing.assert_array_equal(_np(ta.cbf), np.asarray(ja.cbf))


@pytest.mark.parametrize("cbf", [False, True], ids=["plain", "cbf"])
def test_hash_table_ids_match_jax(cbf):
    jadmit = dr.CBFFilter(filter_freq=2, max_element_size=256) if cbf \
        else None
    tadmit = tcfg.CBFFilter(filter_freq=2, max_element_size=256) if cbf \
        else None
    ja, ta = jhta.create(64, jadmit), thta.create(64, tadmit, "cpu")
    rng = np.random.default_rng(5)
    for _ in range(4):
        keys = _ht_keys(rng, 80)
        ja, jids = jhta.lookup_or_create(ja, jkeys.from_numpy(keys), jadmit)
        ta, tids = thta.lookup_or_create(ta, torch.from_numpy(keys), tadmit)
        np.testing.assert_array_equal(_np(tids), np.asarray(jids))
        _same_alloc(ja, ta)
        assert (_np(tids)[keys == -1] == -1).all()
    # ids are dense in allocation order
    live = _np(ta.ids)[_np(ta.ids) >= 0]
    np.testing.assert_array_equal(np.sort(live), np.arange(int(ta.next_id)))
    assert int(thta.size(ta)) == int(jhta.size(ja)) > 0
    probe = _ht_keys(rng, 60)
    np.testing.assert_array_equal(
        _np(thta.lookup(ta, torch.from_numpy(probe))),
        np.asarray(jhta.lookup(ja, jkeys.from_numpy(probe))))
    # gen_ids_unique over already-unique keys with their counts
    uk = np.unique(_ht_keys(rng, 50))
    counts = rng.integers(1, 4, uk.shape[0])
    ja, ju, jc = jhta.gen_ids_unique(ja, jkeys.from_numpy(uk),
                                     jnp.asarray(counts, jnp.int32), jadmit)
    ta, tu, tc = thta.gen_ids_unique(ta, torch.from_numpy(uk),
                                     torch.from_numpy(counts), tadmit)
    np.testing.assert_array_equal(_np(tu), np.asarray(ju))
    np.testing.assert_array_equal(_np(tc), np.asarray(jc))
    _same_alloc(ja, ta)


def test_hash_table_reinsert_matches_jax():
    rng = np.random.default_rng(6)
    keys = _ht_keys(rng, 70)
    ja, ta = jhta.create(32), thta.create(32, None, "cpu")
    jres = jhta.reinsert(ja, jkeys.from_numpy(keys))
    tres = thta.reinsert(ta, torch.from_numpy(keys))
    np.testing.assert_array_equal(_np(tres[0].keys),
                                  carry.keys_np(jres[0].stored_keys))
    for j, tt in zip(jres[1:], tres[1:]):
        np.testing.assert_array_equal(_np(tt), np.asarray(j))
    assert int(tres[2]) == int(_np(tres[3]).sum()) > 0


def test_tensible_gather_scatter_grow_apply_match_jax():
    rng = np.random.default_rng(7)
    jt = jhta.tensible(8, (DIM,), init=0.5)
    tt = thta.tensible(8, (DIM,), init=0.5, device="cpu")
    np.testing.assert_array_equal(_np(tt.rows), np.asarray(jt.rows))
    ids = np.array([3, -1, 7, 0, 11, 5], np.int64)
    rows = rng.standard_normal((6, DIM)).astype(np.float32)
    jt = jhta.scatter(jt, jnp.asarray(ids, jnp.int32), jnp.asarray(rows))
    tt = thta.scatter(tt, torch.from_numpy(ids), torch.from_numpy(rows))
    np.testing.assert_array_equal(_np(tt.rows), np.asarray(jt.rows))
    probe = np.array([0, 3, -1, 8, 7, 2], np.int64)
    np.testing.assert_array_equal(
        _np(thta.gather(tt, torch.from_numpy(probe))),
        np.asarray(jhta.gather(jt, jnp.asarray(probe, jnp.int32))))
    jt, tt = jhta.grow(jt, 16, init=0.25), thta.grow(tt, 16, init=0.25)
    assert tt.capacity == jt.capacity == 16
    np.testing.assert_array_equal(_np(tt.rows), np.asarray(jt.rows))
    jopt = jsopt.sparse_adagrad(0.5, initial_accumulator_value=0.1)
    topt = tsopt.sparse_adagrad(0.5, initial_accumulator_value=0.1)
    jslot, tslot = jopt.init(jt.rows), topt.init(tt.rows)
    uids = np.array([0, 3, -1, 12, 7], np.int64)
    g = rng.standard_normal((5, DIM)).astype(np.float32)
    jt, jslot = jhta.apply_sparse(jt, jopt, jslot,
                                  jnp.asarray(uids, jnp.int32),
                                  jnp.asarray(g), jnp.int32(0))
    tt, tslot = thta.apply_sparse(tt, topt, tslot, torch.from_numpy(uids),
                                  torch.from_numpy(g), 0)
    np.testing.assert_allclose(_np(tt.rows), np.asarray(jt.rows), rtol=OP_RTOL,
                               atol=OP_ATOL)
    np.testing.assert_allclose(_np(tslot["acc"]), np.asarray(jslot["acc"]),
                               rtol=OP_RTOL, atol=OP_ATOL)


def test_config_copies_are_the_source():
    """The framework-free config dataclasses of the variant modules are
    the JAX package's source."""
    import inspect
    assert inspect.getsource(tmh.MultiHashConfig) == \
        inspect.getsource(jmh.MultiHashConfig)
    assert inspect.getsource(tdd.DynamicDimConfig) == \
        inspect.getsource(jdd.DynamicDimConfig)
    assert inspect.getsource(tdd.ev_config) == \
        inspect.getsource(jdd.ev_config)
