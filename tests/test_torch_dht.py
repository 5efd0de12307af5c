"""Port parity of ``parallel.DistributedHashTable``: the port's table on
gloo ranks (``tests/torch_mesh_worker.py``, one partition per rank)
against the JAX ``DistributedHashTable`` on a virtual CPU mesh of the same
size, from the same ``[S, n]`` key planes (rank r takes row r), mirroring
the JAX package's ``tests/test_distributed_hashtable.py``.

Integer results are bit-equal: the global ids (``local * S + rank``),
validity, sizes, the health counters, snapshots and saved key sets. Rows,
row cotangents and trained rows are within ROW_ATOL (float sums in
another order).
"""
import jax.numpy as jnp
import numpy as np
import torch

from deeprec_tpu.config import CBFFilter
from deeprec_tpu.optim import sparse as jsopt
from deeprec_tpu.parallel.hash_table import DistributedHashTable as JDHT
from deeprec_tpu.parallel.trainer import make_mesh as jmesh
from deeprec_tpu.sparse import keys as jkeys

import torch_mesh_worker as W

torch.set_num_threads(1)

ROW_ATOL = 1e-6
KW = dict(capacity_per_shard=64, dim=8, bucket_cap=64)


def planes(ids, S=4, n=16):
    return np.resize(np.asarray(ids, np.int64), S * n).reshape(S, n)


def jplanes(arr):
    hi, lo = jkeys.split_np(arr)
    return jnp.asarray(hi), jnp.asarray(lo)


def jdht(S=4, **kw):
    kw = dict(KW, **kw)
    if kw.get("admit"):
        kw["admit"] = CBFFilter(**kw["admit"])
    return JDHT(jmesh(S), **kw)


def per_rank(x, S=4):
    """A JAX result stacked over the mesh, split per rank."""
    x = np.asarray(x)
    return x.reshape((S, -1) + x.shape[1:])


def ranks(ops, tmp_path, S=4, **kw):
    return W.run_ranks("dht", {"kw": dict(KW, **kw), "ops": ops}, S,
                       str(tmp_path / f"dht{S}"))


def test_gen_ids_match_jax_dense_and_stable(tmp_path):
    arr = planes(np.arange(1, 33))
    out = ranks([("gen", arr), ("gen", arr), ("size",)], tmp_path)
    d = jdht()
    st = d.init()
    st, ids1 = d.gen_ids(st, *jplanes(arr))
    st, ids2 = d.gen_ids(st, *jplanes(arr))
    ids1 = per_rank(ids1)
    for r, o in enumerate(out):
        np.testing.assert_array_equal(o[0], ids1[r])
        np.testing.assert_array_equal(o[1], o[0])  # stable
        assert o[2] == d.size(st) == len(np.unique(arr))
    got = np.concatenate([o[0] for o in out])
    assert (got >= 0).all()
    for s in range(4):  # dense per shard
        loc = np.unique(got[got % 4 == s]) // 4
        np.testing.assert_array_equal(loc, np.arange(len(loc)))


def test_snapshot_matches_jax(tmp_path):
    arr = planes(np.arange(100, 140))
    out = ranks([("gen", arr), ("snapshot",)], tmp_path)
    d = jdht()
    st, _ = d.gen_ids(d.init(), *jplanes(arr))
    jk, ji = d.snapshot(st)
    for o in out:
        k, i = o[1]
        np.testing.assert_array_equal(np.sort(k), np.sort(jk))
        assert dict(zip(k.tolist(), i.tolist())) == \
            dict(zip(jk.tolist(), np.asarray(ji).tolist()))


def test_admission_gate_matches_jax(tmp_path):
    """Each rank sights each key once a batch: 4 occurrences over the
    global batch; filter_freq 8 admits at the second batch."""
    admit = dict(filter_freq=8, max_element_size=1000)
    arr = planes(np.arange(1, 9), n=8)
    out = ranks([("gen", arr), ("gen", arr)], tmp_path, admit=admit)
    d = jdht(admit=admit)
    st, ids1 = d.gen_ids(d.init(), *jplanes(arr))
    st, ids2 = d.gen_ids(st, *jplanes(arr))
    for r, o in enumerate(out):
        np.testing.assert_array_equal(o[0], per_rank(ids1)[r])
        np.testing.assert_array_equal(o[1], per_rank(ids2)[r])
        assert (o[0] == -1).all() and (o[1] >= 0).all()


def test_gradient_exchange_matches_jax(tmp_path):
    """Every rank asks for the same key: its row's cotangent is the sum
    over the 4 requesters, on its owner only."""
    arr = np.full((4, 8), 7, np.int64)
    ct = np.ones((4, 8, 8), np.float32)
    out = ranks([("gen", arr), ("grads", arr, ct)], tmp_path)
    d = jdht()
    st, ids = d.gen_ids(d.init(), *jplanes(arr))
    _, rows, valid, d_rows = d.lookup_and_grads(st, *jplanes(arr),
                                                jnp.asarray(ct))
    jd = np.asarray(d_rows).reshape(4, 65, 8)
    for r, o in enumerate(out):
        rows_r, valid_r, d_r = o[1]
        np.testing.assert_allclose(rows_r, per_rank(rows)[r], atol=ROW_ATOL)
        np.testing.assert_array_equal(valid_r, per_rank(valid)[r])
        np.testing.assert_allclose(d_r, jd[r], atol=ROW_ATOL)
    total = np.stack([o[1][2] for o in out])
    assert np.count_nonzero(total.sum(-1)) == 1
    np.testing.assert_allclose(total.sum(), 4 * 8 * 8.0)


def test_apply_cotangent_matches_jax(tmp_path):
    arr = planes(np.arange(1, 17))
    ct = np.ones((4, 16, 8), np.float32)
    out = ranks([("gen", arr), ("apply", arr, ct, 0)], tmp_path)
    d = jdht()
    opt = jsopt.sparse_sgd(0.5)
    st = d.init()
    slot = d.init_slot(opt, st)
    st, _ = d.gen_ids(st, *jplanes(arr))
    before = np.asarray(st.table.rows).reshape(4, 65, 8).copy()
    st, slot, rows, valid = d.apply_cotangent(
        st, opt, slot, *jplanes(arr), jnp.asarray(ct),
        jnp.zeros((), jnp.int32))
    after = np.asarray(st.table.rows).reshape(4, 65, 8)
    moved = 0
    for r, o in enumerate(out):
        rows_r, valid_r, table_r = o[1]
        np.testing.assert_allclose(rows_r, per_rank(rows)[r], atol=ROW_ATOL)
        assert valid_r.all()
        np.testing.assert_allclose(table_r, after[r], atol=ROW_ATOL)
        moved += np.count_nonzero(np.abs(table_r - before[r]).sum(-1))
    assert moved == 16  # exactly the touched ids


def test_health_and_grow_match_jax(tmp_path):
    arr = planes(np.arange(1, 101), n=32)
    out = ranks([("gen", arr), ("health",), ("grow",), ("gen", arr),
                 ("health",)], tmp_path, capacity_per_shard=32,
                bucket_cap=128)
    d = jdht(capacity_per_shard=32, bucket_cap=128)
    st, ids1 = d.gen_ids(d.init(), *jplanes(arr))
    h1 = d.health(st)
    st = d.maybe_grow(st)
    st, ids2 = d.gen_ids(st, *jplanes(arr))
    for r, o in enumerate(out):
        assert o[1] == h1 and h1["size"] == 100
        assert o[2] == d.cap == 64
        np.testing.assert_array_equal(o[3], per_rank(ids2)[r])
        np.testing.assert_array_equal(o[3], o[0])  # ids stable
        assert o[4] == d.health(st)


def test_checkpoint_reshards_4_to_2(tmp_path):
    """Four ranks' parts restore at 2 ranks, as a JAX save at 4 shards
    does: every key's row intact, the size kept."""
    arr = planes(np.arange(50, 120), n=32)
    ct = np.ones((4, 32, 4), np.float32)
    out = ranks([("gen", arr), ("apply", arr, ct, 0), ("ckpt",)], tmp_path,
                dim=4)
    parts = [o[2] for o in out]
    saved = {"keys": np.concatenate([p["keys"] for p in parts]),
             "values": np.concatenate([p["values"] for p in parts])}
    assert set(saved["keys"].tolist()) == set(arr.reshape(-1).tolist())
    d = jdht(dim=4)
    opt = jsopt.sparse_sgd(0.5)
    st = d.init()
    slot = d.init_slot(opt, st)
    st, _ = d.gen_ids(st, *jplanes(arr))
    st, slot, _, _ = d.apply_cotangent(st, opt, slot, *jplanes(arr),
                                       jnp.asarray(ct),
                                       jnp.zeros((), jnp.int32))
    jarr = d.checkpoint_arrays(st)

    def rows(a):
        return dict(zip(a["keys"].tolist(), np.asarray(a["values"])))
    want = rows(jarr)
    got = rows(saved)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=ROW_ATOL)
    for src in (saved, {k: np.asarray(v) for k, v in jarr.items()}):
        back = ranks([("restore", src)], tmp_path, S=2, dim=4)
        assert all(o[0][0] == len(want) for o in back)
        again = {}
        for o in back:
            again.update(rows(o[0][1]))
        assert again.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(again[k], rows(src)[k])
