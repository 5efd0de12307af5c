"""Port parity: the four variant collections through the port's Trainer
against the JAX package's Trainer, at the JAX tests' small size (4 Criteo
columns at dim 8, B 256, DCN with one cross layer and a 32-unit tower,
sparse Adagrad(0.5, initial accumulator 0.01), dense Adam(3e-3)).

- Each collection (multi-hash add, adaptive, hash table with a CBF gate,
  dynamic dimension) in lockstep for STEPS steps from carried weights and
  tables: the per-step loss within LOSS_ATOL; integer state (index keys,
  the id plane, next_id, CBF counters, freqs, versions) bit-equal; rows,
  slot leaves and dense leaves within STATE_ATOL; ``table_health`` equal;
  an ``eval_step``'s AUC, accuracy and loss within EVAL_ATOL.
- Growth: ``maybe_grow`` after every step from small tables (hash table,
  adaptive): the same capacities, the same state.
- Checkpoints both ways: a JAX save restored by the port's
  ``CheckpointManager`` and a port save restored by the JAX one, for each
  collection (``__dense__`` leaves, ``__ht__`` with its CBF, the adaptive
  ``static__`` arrays, the dynamic-dimension EV table).
"""
import numpy as np
import pytest
import torch

import jax
import optax

import deeprec_tpu as dr
from deeprec_tpu import feature_column as jfc
from deeprec_tpu import feature_column_variants as jfv
from deeprec_tpu.checkpoint import CheckpointManager as JManager
from deeprec_tpu.data.criteo import CAT_NAMES, DENSE_NAMES, SyntheticCriteo
from deeprec_tpu.models import ctr as jctr
from deeprec_tpu.optim import sparse as jsopt
from deeprec_tpu.sparse import dynamicdim as jdd
from deeprec_tpu.sparse import keys as jkeys
from deeprec_tpu.train import metrics as jmetrics
from deeprec_tpu.train.trainer import Trainer as JTrainer

from deeprec_tpu_torch import config as tcfg
from deeprec_tpu_torch import feature_column as tfc
from deeprec_tpu_torch import feature_column_variants as tfv
from deeprec_tpu_torch.checkpoint import CheckpointManager as TManager
from deeprec_tpu_torch.checkpoint import saver as tsaver
from deeprec_tpu_torch.models import ctr as tctr
from deeprec_tpu_torch.optim import dense as tdense
from deeprec_tpu_torch.optim import sparse as tsopt
from deeprec_tpu_torch.sparse import dynamicdim as tdd
from deeprec_tpu_torch.sparse import hashtable as tht
from deeprec_tpu_torch.sparse import multihash as tmh
from deeprec_tpu_torch.train import metrics as tmetrics
from deeprec_tpu_torch.train.trainer import Trainer as TTrainer
from deeprec_tpu_torch.utils.tree import leaves_with_paths

from tests import torch_carry as carry

torch.set_num_threads(1)

N_CAT, N_DENSE, DIM, B, STEPS = 4, 3, 8, 256, 5
LOSS_ATOL = 1e-4   # per-step loss (f32 sums and products in another order)
STATE_ATOL = 1e-4  # rows, slot leaves and dense leaves after a window
EVAL_ATOL = 1e-4   # an eval step's AUC, accuracy and loss
KINDS = ["multihash", "adaptive", "hashtable", "dyndim"]


def _cols(fcm):
    return [fcm.EmbeddingColumn(fcm.CategoricalColumn(n), DIM)
            for n in CAT_NAMES[:N_CAT]]


def _coll(kind, fcm, fvm, cfgm, ddm, capacity=1 << 10):
    init = cfgm.Initializer("normal", scale=0.05)
    if kind == "multihash":
        return fvm.MultiHashCollection(_cols(fcm), name="emb",
                                       table_sizes=(256, 64),
                                       combiner_op="add")
    if kind == "adaptive":
        return fvm.AdaptiveCollection(_cols(fcm), name="emb", buckets=128,
                                      capacity=capacity,
                                      counter_filter=cfgm.CounterFilter(2),
                                      initializer=init)
    if kind == "hashtable":
        return fvm.HashTableCollection(
            _cols(fcm), name="emb", capacity=capacity, initializer=init,
            admit=cfgm.CBFFilter(filter_freq=2, max_element_size=1 << 12))
    dd = ddm.DynamicDimConfig(block_num=2, block_dim=4,
                              freq_thresholds=(0, 20))
    return fvm.DynamicDimCollection(_cols(fcm), name="emb", dynamic_dim=dd,
                                    capacity=capacity, initializer=init)


def _pair(kind, capacity=1 << 10):
    names = list(CAT_NAMES[:N_CAT])
    jt = JTrainer(
        model=jctr.DCN(emb_names=names, cross_layers=1, deep_units=(32,)),
        numeric_columns=[jfc.NumericColumn(n, log_normalize=True)
                         for n in DENSE_NAMES[:N_DENSE]],
        collections={"emb": _coll(kind, jfc, jfv, dr, jdd, capacity)},
        sparse_optimizers={"emb": jsopt.sparse_adagrad(
            0.5, initial_accumulator_value=0.01)},
        dense_optimizer=optax.adam(3e-3))
    tt = TTrainer(
        tctr.DCN(names, DIM, cross_layers=1, deep_units=(32,),
                 dense_dim=N_DENSE),
        [tfc.NumericColumn(n, log_normalize=True)
         for n in DENSE_NAMES[:N_DENSE]],
        {"emb": _coll(kind, tfc, tfv, tcfg, tdd, capacity)},
        {"emb": tsopt.sparse_adagrad(0.5, initial_accumulator_value=0.01)},
        tdense.Adam(3e-3), device="cpu")
    return jt, tt


def _batches(n, seed=0):
    return list(SyntheticCriteo(
        batch_size=B, seed=seed, active_features=set(range(N_CAT)),
        noise=0.3, vocab_sizes=[100] * 26).take(n))


def _carry_tables(js, ts):
    """The JAX tables' random draws (multi-hash sub-tables, the adaptive
    static table) carried into the port's fresh state."""
    jb, tb = js.tables["emb"], ts.tables["emb"]
    if isinstance(tb.ev, tmh.MultiHashState):
        tb = tb._replace(ev=carry.multihash_state(jb.ev))
    elif isinstance(tb.ev, tfv.ad.AdaptiveState):
        tb = tb._replace(ev=tb.ev._replace(static=carry.t(jb.ev.static)))
    return ts._replace(tables={"emb": tb})


def _carried(jt, tt, batch):
    js, ts = jt.init(jax.random.key(0), batch), tt.init(batch)
    tctr.load_flax_params(tt.model, [np.asarray(x) for x in
                                     jax.tree_util.tree_leaves(js.params)])
    ts = ts._replace(opt_state=tt.dense_optimizer.load_flax_state(
        tt.model, [np.asarray(x)
                   for x in jax.tree_util.tree_leaves(js.opt_state)]))
    return js, _carry_tables(js, ts)


def _lockstep(jt, tt, batches, after_step=None):
    js, ts = _carried(jt, tt, batches[0])
    for i, b in enumerate(batches):
        jd, jc, jl = jt.prepare_batch(b)
        td, tc, tl = tt.prepare_batch(b)
        j0, t0 = float(js.metrics.loss_sum), float(ts.metrics.loss_sum)
        js = jt._jit_train(js, jd, jc, jl)
        ts = tt._train_step(ts, td, tc, tl)
        jloss = (float(js.metrics.loss_sum) - j0) / B
        tloss = (float(ts.metrics.loss_sum) - t0) / B
        assert np.isfinite(tloss) and abs(jloss - tloss) <= LOSS_ATOL, \
            (i, jloss, tloss)
        if after_step is not None:
            js, ts = after_step(js, ts)
    return js, ts


def _jax_leaves(state):
    """A port table state's leaves as numpy, in the JAX state's flatten
    order and shapes: a hash index as its (hi, lo, size, overflow) planes,
    multi-hash sub-tables without their null row."""
    if isinstance(state, tht.HashTable):
        hi, lo = jkeys.split_np(state.keys.numpy())
        return [hi, lo, state.size.numpy(), state.overflow.numpy()]
    if isinstance(state, tmh.MultiHashState):
        return [t[:-1].numpy() for t in state.tables]
    if isinstance(state, tuple):
        return [x for f in state if f is not None for x in _jax_leaves(f)]
    return [state.detach().numpy()]


def _assert_same_tables(js, ts):
    jb, tb = js.tables["emb"], ts.tables["emb"]
    ref = [np.asarray(x) for x in jax.tree_util.tree_leaves(jb.ev)]
    got = _jax_leaves(tb.ev)
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape, i
        if np.issubdtype(r.dtype, np.floating):
            np.testing.assert_allclose(g, r, rtol=0, atol=STATE_ATOL,
                                       err_msg=str(i))
        else:
            np.testing.assert_array_equal(g, r, err_msg=str(i))
    jslot = jax.tree_util.tree_leaves(jb.slot)
    tslot = leaves_with_paths(tb.slot)
    assert len(jslot) == len(tslot)
    for (p, g), r in zip(tslot, jslot):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=STATE_ATOL, err_msg=p)


def _assert_same(jt, js, tt, ts):
    _assert_same_tables(js, ts)
    assert tt.table_health(ts) == jt.table_health(js)
    ref = [np.asarray(x) for x in jax.tree_util.tree_leaves(
        (js.params, js.opt_state, js.step))]
    got = tsaver._dense_leaves(tt, ts)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(np.asarray(g), r, rtol=0,
                                   atol=STATE_ATOL)


def _eval_both(jt, js, tt, ts, seed=77):
    held = _batches(2, seed=seed)
    jm, tm = jmetrics.create(), tmetrics.create(device="cpu")
    for b in held:
        jm, tm = jt.eval_step(js, jm, b), tt.eval_step(ts, tm, b)
    jm, tm = jmetrics.summarize(jm), tmetrics.summarize(tm)
    for k in ("auc", "accuracy", "loss"):
        assert abs(tm[k] - jm[k]) <= EVAL_ATOL, (k, tm, jm)
    return tm


@pytest.mark.parametrize("kind", KINDS)
def test_variant_trainer_matches_jax(kind):
    jt, tt = _pair(kind)
    js, ts = _lockstep(jt, tt, _batches(STEPS))
    _assert_same(jt, js, tt, ts)
    tm = _eval_both(jt, js, tt, ts)
    assert tm["examples"] == 2 * B and 0.0 < tm["auc"] < 1.0
    health = tt.table_health(ts)
    if kind == "multihash":
        assert health == {}
    else:
        assert health["emb"]["size"] > 0
    if kind == "adaptive":  # hot keys own admitted EV rows
        ev = ts.tables["emb"].ev.ev
        assert int((ev.freqs >= 2).sum()) > 0
    if kind == "hashtable":  # the CBF held keys seen once back
        alloc = ts.tables["emb"].ev.alloc
        assert 0 < int(alloc.next_id) == int(alloc.index.size)
        assert int(alloc.cbf.sum()) > int(alloc.next_id)


@pytest.mark.parametrize("kind", ["hashtable", "adaptive"])
def test_growth_matches_jax(kind):
    jt, tt = _pair(kind, capacity=64)
    caps = []

    def grow(js, ts):
        js, ts = jt.maybe_grow(js), tt.maybe_grow(ts)
        caps.append((tt.collections["emb"].config.capacity,
                     jt.collections["emb"].config.capacity))
        return js, ts
    js, ts = _lockstep(jt, tt, _batches(4, seed=3), after_step=grow)
    assert all(a == b for a, b in caps) and caps[-1][0] > 64, caps
    _assert_same(jt, js, tt, ts)


def _saved_by_key(directory):
    """The newest save's table ``emb``, rows ordered by key."""
    from deeprec_tpu_torch.checkpoint import format as tformat
    arrays = tformat.read_table(tformat.list_saves(directory)[-1]["path"],
                                "emb")
    if "keys" not in arrays:
        return arrays
    n = arrays["keys"].shape[0]
    order = np.argsort(arrays["keys"], kind="stable")
    return {k: (np.asarray(v)[order] if np.ndim(v) and len(v) == n
                and not k.startswith(("cbf", "static__")) else np.asarray(v))
            for k, v in arrays.items()}


@pytest.mark.parametrize("kind", KINDS)
def test_variant_saves_restore_both_ways(kind, tmp_path):
    jt, tt = _pair(kind)
    js, ts = _lockstep(jt, tt, _batches(3, seed=5))
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    JManager(jdir).save(jt, js)
    TManager(tdir).save(tt, ts)
    # the two saves hold the same arrays (rows by key)
    ja, ta = _saved_by_key(jdir), _saved_by_key(tdir)
    assert sorted(ja) == sorted(ta)
    for k in ja:
        if np.issubdtype(ja[k].dtype, np.floating):
            np.testing.assert_allclose(ta[k], ja[k], rtol=0,
                                       atol=STATE_ATOL, err_msg=k)
        else:
            np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)

    # each save restores alike into both packages: a JAX save into the
    # port, a port save into the JAX package
    batch0 = _batches(1, seed=9)[0]
    restored = {}
    for d in (jdir, tdir):
        jt2, tt2 = _pair(kind)
        js2, ok = JManager(d).restore(jt2, jt2.init(jax.random.key(1),
                                                    batch0))
        assert ok and int(js2.step) == 3
        ts2, ok = TManager(d).restore(tt2, tt2.init(batch0))
        assert ok and ts2.step == 3
        _assert_same_tables(js2, ts2)
        restored[d] = (jt2, js2, tt2, ts2)
    if kind != "hashtable":  # hash-table ids re-allocate at restore
        _assert_same_tables(js, restored[jdir][3])
        _assert_same_tables(restored[tdir][1], ts)
    # the port trainer restored from the port's save keeps training in
    # step with the JAX trainer restored from it
    jt2, js2, tt2, ts2 = restored[tdir]
    b = _batches(1, seed=11)[0]
    js2, ts2 = jt2.train_step(js2, b), tt2.train_step(ts2, b)
    _assert_same_tables(js2, ts2)
