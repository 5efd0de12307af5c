"""Port parity: the hash index and the dedup against the JAX package.
Integer state must be bit-equal: key planes, slots, created, size,
overflow, unique keys, inverse, counts. Every insert case runs in both
forms: ``lookup_or_insert_`` (in place: the table's own tensors are
written) and ``lookup_or_insert`` (functional: the input stays as it
was)."""
import numpy as np
import pytest
import torch

from deeprec_tpu.ops import unique as junique
from deeprec_tpu.sparse import hashtable as JH
from deeprec_tpu.sparse import keys as JK

from deeprec_tpu_torch.ops.unique import unique as tunique
from deeprec_tpu_torch.sparse import hashtable as TH
from deeprec_tpu_torch.sparse import keys as TK

import torch_hash_cases as HC

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


FORMS = ["in_place", "functional"]


def _insert(tt, keys, max_probes, form):
    """The port's insert in ``form``: the in-place one must return the
    table's own tensors, written where they lie; the functional one new
    tensors, the input left as it was."""
    before = TH.clone(tt)
    ptrs = [t.data_ptr() for t in tt]
    if form == "in_place":
        out = TH.lookup_or_insert_(tt, keys, max_probes)
        assert all(a is b for a, b in zip(out[0], tt))
        assert [t.data_ptr() for t in out[0]] == ptrs
    else:
        out = TH.lookup_or_insert(tt, keys, max_probes)
        assert all(torch.equal(a, b) for a, b in zip(tt, before))
        assert not any(t.data_ptr() in ptrs for t in out[0])
    return out


def _insert_both(jt, tt, keys, max_probes, form="in_place"):
    jt, js, jc = JH.lookup_or_insert(jt, JK.from_numpy(keys), max_probes)
    tt, ts, tc = _insert(tt, torch.from_numpy(keys), max_probes, form)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    _assert_tables_equal(jt, tt)
    return jt, tt


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("cap,n_first,n_second,max_probes", [
    (1024, 300, 417, 32),   # empty table, then load ~0.7 with re-finds
    (64, 40, 40, 32),       # full buckets: overflow and failed claims
    (256, 150, 100, 2),     # short probe bound: keys dropped at the bound
])
def test_lookup_or_insert_bit_equal(cap, n_first, n_second, max_probes,
                                    form):
    rng = np.random.default_rng(cap + n_first)
    first = _distinct_keys(rng, n_first)
    # the second batch re-presents some stored keys next to new ones
    new = _distinct_keys(rng, n_second, hi_range=2**62)
    second = np.concatenate([first[: n_first // 3], new])
    second = np.unique(second)  # deduplicated, as callers guarantee
    rng.shuffle(second)
    jt, tt = JH.create(cap), TH.create(cap, "cpu")
    jt, tt = _insert_both(jt, tt, first, max_probes, form)
    jt, tt = _insert_both(jt, tt, second, max_probes, form)

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


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("case", list(HC.CONTENTION))
def test_contention_bit_equal(case, form):
    """Keys that share a home bucket, so that claims collide, losers retry,
    full buckets advance and both bounds bite: slots, created, key planes,
    size and overflow bit-equal to the JAX table after every batch, and a
    lookup of every key (stored, failed, absent, EMPTY) too."""
    cap, max_probes, sizes, spread = HC.CONTENTION[case]
    jt, tt = JH.create(cap), TH.create(cap, "cpu")
    seen = []
    for keys in HC.batches(cap, len(case), sizes, spread):
        jt, tt = _insert_both(jt, tt, keys, max_probes, form)
        seen.append(keys)
    probe = np.concatenate(seen + [HC.colliding_keys(cap, 5, 99)])
    js, jf = JH.lookup(jt, JK.from_numpy(probe), max_probes)
    ts, tf = TH.lookup(tt, torch.from_numpy(probe), max_probes)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    if sum(sizes) > cap or max_probes < 4:
        assert int(tt.overflow) > 0  # the bounds really bite


@pytest.mark.parametrize("form", FORMS)
def test_max_probes_one_bit_equal(form):
    """max_probes = 1 at a load where home buckets fill: keys that find
    their home bucket full fail at once, lookups stop after one bucket."""
    rng = np.random.default_rng(11)
    jt, tt = JH.create(128), TH.create(128, "cpu")
    for n in (100, 60):
        jt, tt = _insert_both(jt, tt, _distinct_keys(rng, n), 1, form)
    assert int(tt.overflow) > 0
    probe = _distinct_keys(rng, 40)
    js, jf = JH.lookup(jt, JK.from_numpy(probe), 1)
    ts, tf = TH.lookup(tt, torch.from_numpy(probe), 1)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))


def test_cpu_tensors_run_the_plain_versions(monkeypatch):
    """On CPU tensors lookup and lookup_or_insert are their plain versions
    and never reach the kernels' wrappers."""
    from deeprec_tpu_torch.ops import hash_probe

    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached a kernel wrapper")
    monkeypatch.setattr(hash_probe, "hash_lookup", refuse)
    monkeypatch.setattr(hash_probe, "hash_lookup_or_insert_", refuse)
    keys = torch.from_numpy(_distinct_keys(np.random.default_rng(2), 50))
    t0 = TH.create(64, "cpu")
    got, ref = TH.lookup_or_insert(t0, keys), TH.lookup_or_insert_plain(
        t0, keys)
    for a, b in zip([*got[0], *got[1:]], [*ref[0], *ref[1:]]):
        assert torch.equal(a, b)
    assert bool(TK.is_empty(t0.keys).all())  # the input table as it was
    inplace = TH.lookup_or_insert_(t0, keys)
    for a, b in zip([*inplace[0], *inplace[1:]], [*ref[0], *ref[1:]]):
        assert torch.equal(a, b)
    for a, b in zip(TH.lookup(got[0], keys), TH.lookup_plain(got[0], keys)):
        assert torch.equal(a, b)


def test_other_devices_raise():
    """A table or keys on a device that is neither CPU nor CUDA raise, and
    so do keys on another device than the table."""
    meta = TH.create(16, "meta")
    keys = torch.zeros((4,), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        TH.lookup(meta, keys)
    with pytest.raises(ValueError, match="unsupported device"):
        TH.lookup_or_insert(meta, keys)
    with pytest.raises(ValueError, match="table on"):
        TH.lookup(TH.create(16, "cpu"), keys)


def test_in_place_insert_keeps_the_storage():
    """``lookup_or_insert_`` writes into the tensors it was given (the same
    storage, key plane, size and overflow), three batches in a row, and
    equals the functional form's result each time; the plain in-place
    version equals both."""
    rng = np.random.default_rng(17)
    table = TH.create(128, "cpu")
    plain = TH.create(128, "cpu")
    ptrs = [t.data_ptr() for t in table]
    for n in (90, 70, 60):
        keys = torch.from_numpy(_distinct_keys(rng, n, hi_range=2**62))
        ref, rslots, rcreated = TH.lookup_or_insert(table, keys)
        got, slots, created = TH.lookup_or_insert_(table, keys)
        _, pslots, pcreated = TH.lookup_or_insert_plain_(plain, keys)
        assert got is table
        assert [t.data_ptr() for t in table] == ptrs
        for a, b, c in zip(table, ref, plain):
            assert torch.equal(a, b) and torch.equal(a, c)
        assert torch.equal(slots, rslots) and torch.equal(slots, pslots)
        assert torch.equal(created, rcreated) and \
            torch.equal(created, pcreated)
    assert int(table.overflow) > 0  # the batches overfill the table


def test_device_index_step_updates_the_index_in_place():
    """The device-index step's insert (``embedding_var.lookup_or_create``:
    dedup, then the in-place ``lookup_or_insert_``) over four batches of
    skewed ids: the index's key plane, size and overflow stay the state's
    own tensors and equal the JAX step's after every batch."""
    from deeprec_tpu import config as jcfg
    from deeprec_tpu.sparse import embedding_var as jev
    from deeprec_tpu_torch import config as tcfg
    from deeprec_tpu_torch.sparse import embedding_var as tev
    jc, tc = (m.EmbeddingVariableConfig(
        name="t", embedding_dim=4, capacity=128, max_unique=48,
        counter_filter=m.CounterFilter(2)) for m in (jcfg, tcfg))
    js, ts = jev.create(jc), tev.create(tc, "cpu")
    ptrs = [t.data_ptr() for t in ts.index]
    rng = np.random.default_rng(23)
    pool = np.unique(rng.integers(-(1 << 40), 1 << 40, 150))
    pool = pool[pool != -1]
    for step in range(4):
        ids = pool[np.minimum(rng.zipf(1.2, 160) - 1, len(pool) - 1)]
        ids[rng.random(160) < 0.1] = -1
        js, ja = jev.lookup_or_create(js, jc, JK.from_numpy(ids), step)
        index = ts.index
        ts, ta = tev.lookup_or_create(ts, tc, torch.from_numpy(ids), step)
        assert ts.index is index
        assert [t.data_ptr() for t in ts.index] == ptrs
        _assert_tables_equal(js.index, ts.index)
        np.testing.assert_array_equal(ta.slots.numpy(),
                                      np.asarray(ja.slots))
        np.testing.assert_array_equal(ta.created.numpy(),
                                      np.asarray(ja.created))
        assert bool((ta.slots != tc.capacity).any())
    assert int(ts.index.size) > 48  # keys created over several steps
