"""The port's reference-name API (``deeprec_tpu_torch.api`` and the
top-level exports) mirrors ``tests/test_api_misc.py``: the same names and
arguments, the same configs and state shapes as the JAX package (the
multi-hash sub-tables here carry their zero null row), the HashTable /
Tensible cases, with ``device="cpu"``."""
import dataclasses
import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import deeprec_tpu as dr
from deeprec_tpu.sparse import hash_table_api as jhta
from deeprec_tpu.sparse import keys as jkeys

import deeprec_tpu_torch as tr
from deeprec_tpu_torch import api as tapi
from deeprec_tpu_torch.config import CBFFilter
from deeprec_tpu_torch.optim import sparse as tsopt
from deeprec_tpu_torch.sparse import hash_table_api as hta

API = ["get_embedding_variable", "get_multihash_variable",
       "get_dynamic_dimension_embedding_variable", "get_hash_table",
       "categorical_column_with_embedding",
       "categorical_column_with_hash_bucket",
       "categorical_column_with_adaptive_embedding", "embedding_column",
       "shared_embedding_columns"]
CREATES_STATE = {"get_embedding_variable", "get_multihash_variable",
                 "get_dynamic_dimension_embedding_variable",
                 "get_hash_table"}


def ids_of(*vals):
    return torch.tensor(vals, dtype=torch.int64)


def test_top_level_exports_match_jax():
    """Everything ``deeprec_tpu/__init__.py`` exports."""
    names = {n for n in dir(dr) if not n.startswith("_")}
    skip = {"api", "feature_column", "host_index",
            "parallel", "ops", "sparse", "checkpoint", "data", "models",
            "optim", "serving", "train", "utils", "feature_column_variants"}
    missing = {n for n in names - skip if not hasattr(tr, n)}
    assert not missing, missing
    assert tr.__version__ == dr.__version__
    for name in API:
        assert getattr(tr, name) is getattr(tapi, name)


@pytest.mark.parametrize("name", API)
def test_api_signatures_match_jax(name):
    """The same parameters in the same order and with the same defaults;
    a function that creates a state adds ``device`` (default the card)."""
    from deeprec_tpu import api as japi
    jsig = inspect.signature(getattr(japi, name)).parameters
    tsig = dict(inspect.signature(getattr(tapi, name)).parameters)
    if name in CREATES_STATE:
        assert tsig.pop("device").default == "cuda"
    assert list(tsig) == list(jsig)
    for p in jsig:
        assert repr(tsig[p].default) == repr(jsig[p].default), p


def test_api_facade_names():
    cfg, st = tr.get_embedding_variable("e", 8, capacity=256, device="cpu")
    assert st.values.shape == (257, 8) and cfg.capacity == 256
    mcfg, mst = tr.get_multihash_variable("m", dims=(16, 8),
                                          operation="concat",
                                          embedding_dim=8, device="cpu")
    assert mcfg.sub_dim == 4
    assert sum(t.shape[0] - 1 for t in mst.tables) == 24  # + null rows
    (dcfg, dd), dst = tr.get_dynamic_dimension_embedding_variable(
        "d", embedding_block_dimension=4, embedding_block_num=2,
        freq_thresholds=(0, 5), capacity=64, device="cpu")
    assert dst.values.shape == (65, 8) and dcfg.track_freq is True
    (_, jdd), _ = dr.get_dynamic_dimension_embedding_variable(
        "d", embedding_block_dimension=4, embedding_block_num=3)
    (_, tdd), _ = tr.get_dynamic_dimension_embedding_variable(
        "d", embedding_block_dimension=4, embedding_block_num=3,
        device="cpu")
    assert tdd.freq_thresholds == jdd.freq_thresholds == (0, 10, 100)
    ht_state = tr.get_hash_table(128, device="cpu")
    assert int(hta.size(ht_state)) == 0
    cols = tr.shared_embedding_columns(["item", "hist"], 8, "item_space",
                                       max_lengths=[1, 16])
    assert cols[0].categorical.shared_embedding == "item_space"
    assert cols[1].categorical.max_length == 16
    c = tr.categorical_column_with_embedding("C1")
    assert c.hash_bucket_size is None
    e = tr.embedding_column(c, 16)
    assert e.dimension == 16 and e.combiner == "mean"
    ac, buckets = tr.categorical_column_with_adaptive_embedding("A", 1000)
    assert buckets == 1000 and ac.hash_bucket_size is None
    hb = tr.categorical_column_with_hash_bucket("H", 77)
    assert dataclasses.asdict(hb) == dataclasses.asdict(
        dr.categorical_column_with_hash_bucket("H", 77))
    with pytest.raises(ValueError):
        tr.get_multihash_variable("m", (4, 4), complementary_strategy="mod",
                                  device="cpu")


def test_api_states_match_jax():
    """The states the API creates hold the JAX package's shapes and
    values (the random multi-hash sub-tables only by shape)."""
    jcfg, jst = dr.get_embedding_variable("e", 8, capacity=64)
    tcfg_, tst = tr.get_embedding_variable("e", 8, capacity=64, device="cpu")
    assert repr(tcfg_) == repr(jcfg)
    for f in ("values", "freqs", "versions", "create_steps"):
        np.testing.assert_array_equal(getattr(tst, f).numpy(),
                                      np.asarray(getattr(jst, f)))
    _, jm = dr.get_multihash_variable("m", dims=(16, 8), embedding_dim=8)
    _, tm = tr.get_multihash_variable("m", dims=(16, 8), embedding_dim=8,
                                      device="cpu")
    assert [tuple(t.shape) for t in tm.tables] == \
        [(s + 1, 8) for s in (16, 8)]
    assert [t.shape for t in jm.tables] == [(16, 8), (8, 8)]
    jh = dr.get_hash_table(32, dr.CBFFilter(2, max_element_size=100))
    th = tr.get_hash_table(32, tr.CBFFilter(2, max_element_size=100),
                           device="cpu")
    np.testing.assert_array_equal(th.ids.numpy(), np.asarray(jh.ids))
    assert th.cbf.shape == jh.cbf.shape


def test_hash_table_dense_id_allocation():
    st = hta.create(256, device="cpu")
    st, ids1 = hta.lookup_or_create(st, ids_of(100, 200, 100, 300, -1))
    a = ids1.numpy()
    assert a[0] == a[2]                      # same key -> same id
    assert a[4] == -1                        # padding
    assert set(a[:4]) <= {0, 1, 2}           # dense ids in allocation order
    assert int(hta.size(st)) == 3
    # second batch: existing keys keep ids, new keys extend
    st, ids2 = hta.lookup_or_create(st, ids_of(300, 400))
    b = ids2.numpy()
    assert b[0] == a[3]
    assert b[1] == 3
    assert int(hta.size(st)) == 4
    # read-only lookup
    assert hta.lookup(st, ids_of(200, 999)).numpy()[1] == -1
    # the JAX package allocates the same ids
    jst = jhta.create(256)
    jst, jids = jhta.lookup_or_create(
        jst, jkeys.from_numpy(np.array([100, 200, 100, 300, -1])))
    np.testing.assert_array_equal(a, np.asarray(jids))


def test_hash_table_admission():
    admit = CBFFilter(filter_freq=2, max_element_size=1000)
    st = hta.create(256, admit=admit, device="cpu")
    st, ids = hta.lookup_or_create(st, ids_of(7), admit=admit)
    assert int(ids[0]) == -1                 # first sighting: not admitted
    st, ids = hta.lookup_or_create(st, ids_of(7), admit=admit)
    assert int(ids[0]) >= 0                  # second: admitted


def test_tensible_gather_scatter_grow_apply():
    st = hta.create(64, device="cpu")
    st, ids = hta.lookup_or_create(st, ids_of(5, 6, 7))
    t = hta.tensible(8, (4,), init=0.0, device="cpu")
    rows = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    t = hta.scatter(t, ids, rows)
    np.testing.assert_allclose(hta.gather(t, ids).numpy(), rows.numpy())
    # -1 reads null row
    np.testing.assert_allclose(
        hta.gather(t, torch.tensor([-1], dtype=torch.int32)).numpy()[0],
        np.zeros(4))
    # growth keeps rows
    t2 = hta.grow(t, 32)
    np.testing.assert_allclose(hta.gather(t2, ids).numpy(), rows.numpy())
    # sparse apply (SGD lr 1: rows -= grads)
    opt = tsopt.sparse_sgd(1.0)
    slot = opt.init(t2.rows)
    g = torch.ones((3, 4), dtype=torch.float32)
    t3, _ = hta.apply_sparse(t2, opt, slot, ids, g, 0)
    np.testing.assert_allclose(hta.gather(t3, ids).numpy(),
                               rows.numpy() - 1.0)
    # the same sequence in the JAX package gives the same rows
    jt = jhta.scatter(jhta.tensible(8, (4,)), jnp.asarray(ids.numpy()),
                      jnp.asarray(rows.numpy()))
    np.testing.assert_array_equal(t.rows.numpy()[:8], np.asarray(jt.rows)[:8])


def test_state_creating_calls_need_the_card():
    """Without ``device`` a state lands on the card, which this CPU
    checkout lacks: the call raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        tr.get_hash_table(16)
