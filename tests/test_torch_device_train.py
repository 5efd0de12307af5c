"""Port parity: the port's Trainer on device-index tables
(``EmbeddingCollection``) against the JAX package's Trainer, at small
widths, weights carried from flax.

- A DLRM over SyntheticCriteo for 5 steps in the light layout (fused
  Adagrad columns, lazy init, the CLI's defaults) and the ``--metadata``
  layout (CounterFilter + GlobalStepEvict, so kernel K3a's function): the
  per-step loss within LOSS_ATOL; key planes, metadata planes and health
  counters bit-equal; rows, slot leaves and dense leaves within
  STATE_ATOL; an eval step.
- ``microbatches=2`` on the DLRM and on DIN (Dice running statistics: each
  microbatch starts from the step's, the last one's update is kept).
- Growth mid-training (``maybe_grow`` after every step): the same
  capacities at the same steps, and the same tables.
- Multivalent, hash-bucket and shared-embedding columns, which take the
  flat ``unique`` (not ``unique_cols``).
- DIEN (its auxiliary loss through ``dien_forward``) for 3 steps.
"""
import numpy as np
import pytest
import torch

import jax
import optax

import deeprec_tpu as dr
from deeprec_tpu import feature_column as jfc
from deeprec_tpu.data.behavior import SyntheticBehavior
from deeprec_tpu.data.criteo import CAT_NAMES, DENSE_NAMES, SyntheticCriteo
from deeprec_tpu.models import ctr as jctr
from deeprec_tpu.models import sequence as jseq
from deeprec_tpu.optim import sparse as jsopt
from deeprec_tpu.train import metrics as jmetrics
from deeprec_tpu.train.trainer import Trainer as JTrainer

from deeprec_tpu_torch import config as tcfg
from deeprec_tpu_torch import feature_column as tfc
from deeprec_tpu_torch.checkpoint import saver as tsaver
from deeprec_tpu_torch.models import ctr as tctr
from deeprec_tpu_torch.models import sequence as tseq
from deeprec_tpu_torch.optim import dense as tdense
from deeprec_tpu_torch.optim import sparse as tsopt
from deeprec_tpu_torch.train import metrics as tmetrics
from deeprec_tpu_torch.train.trainer import Trainer as TTrainer
from deeprec_tpu_torch.utils.tree import leaves_with_paths

torch.set_num_threads(1)

B, CAP, DIM, STEPS = 128, 1 << 12, 8, 5
COLS = CAT_NAMES[:8]
LOSS_ATOL = 1e-4   # per-step loss: f32 products and sums in another order
STATE_ATOL = 1e-4  # rows, slot rows and dense leaves after the steps
HIST = 8


def _meta(m, metadata):
    return dict(counter_filter=m.CounterFilter(filter_freq=1),
                evict=m.GlobalStepEvict(steps_to_live=1 << 30)) \
        if metadata else {}


def _dlrm_pair(metadata=False, capacity=CAP, microbatches=1, **kw):
    """The JAX and the port's DLRM trainers on a device-index table with
    fused Adagrad columns, as the CLI builds them."""
    common = dict(name="emb", capacity=capacity,
                  max_unique=len(COLS) * B // 6, fused_slot_columns=DIM,
                  fused_slot_init=0.1, **kw)
    jcoll = jfc.EmbeddingCollection(
        [jfc.EmbeddingColumn(jfc.CategoricalColumn(n), DIM) for n in COLS],
        initializer=dr.Initializer("normal", scale=0.05), **common,
        **_meta(dr, metadata))
    tcoll = tfc.EmbeddingCollection(
        [tfc.EmbeddingColumn(tfc.CategoricalColumn(n), DIM) for n in COLS],
        initializer=tcfg.Initializer("normal", scale=0.05), **common,
        **_meta(tcfg, metadata))
    jt = JTrainer(
        model=jctr.DLRM(emb_names=COLS, emb_dim=DIM, bottom_units=(16,),
                        top_units=(32, 16)),
        numeric_columns=[jfc.NumericColumn(n, log_normalize=True)
                         for n in DENSE_NAMES],
        collections={"emb": jcoll},
        sparse_optimizers={"emb": jsopt.sparse_adagrad_fused(0.05)},
        dense_optimizer=optax.adagrad(0.05), microbatches=microbatches)
    tt = TTrainer(
        tctr.DLRM(COLS, DIM, bottom_units=(16,), top_units=(32, 16),
                  dense_dim=len(DENSE_NAMES)),
        [tfc.NumericColumn(n, log_normalize=True) for n in DENSE_NAMES],
        {"emb": tcoll}, {"emb": tsopt.sparse_adagrad_fused(0.05)},
        tdense.Adagrad(0.05), microbatches=microbatches, device="cpu")
    return jt, tt


def _carried(jt, tt, batch):
    js, ts = jt.init(jax.random.key(0), batch), tt.init(batch)
    tctr.load_flax_params(tt.model, [np.asarray(x) for x in
                                     jax.tree_util.tree_leaves(js.params)])
    return js, ts._replace(opt_state=tt.dense_optimizer.load_flax_state(
        tt.model, [np.asarray(x)
                   for x in jax.tree_util.tree_leaves(js.opt_state)]))


def _lockstep(jt, tt, batches, after_step=None):
    """Train both; hold each step's loss within LOSS_ATOL. ``after_step``
    runs on both states after each step (growth)."""
    js, ts = _carried(jt, tt, batches[0])
    n = len(batches[0]["label"])
    for i, b in enumerate(batches):
        jd, jc, jl = jt.prepare_batch(b)
        td, tc, tl = tt.prepare_batch(b)
        j0, t0 = float(js.metrics.loss_sum), float(ts.metrics.loss_sum)
        js = jt._jit_train(js, jd, jc, jl)
        ts = tt._train_step(ts, td, tc, tl)
        jloss = (float(js.metrics.loss_sum) - j0) / n
        tloss = (float(ts.metrics.loss_sum) - t0) / n
        assert abs(jloss - tloss) <= LOSS_ATOL, (i, jloss, tloss)
        if after_step is not None:
            js, ts = after_step(js, ts)
    assert ts.step == int(js.step) == len(batches)
    return js, ts


def _assert_same(jt, js, tt, ts):
    """Key and metadata planes and CBF bit-equal; rows, slot leaves and
    dense leaves within STATE_ATOL; health equal."""
    for name in tt.collections:
        jev, tev = js.tables[name].ev, ts.tables[name].ev
        np.testing.assert_array_equal(
            tev.index.keys.numpy(),
            dr.sparse.keys.to_numpy(jev.index.stored_keys))
        for f in ("freqs", "versions", "create_steps"):
            np.testing.assert_array_equal(getattr(tev, f).numpy(),
                                          np.asarray(getattr(jev, f)), f)
        np.testing.assert_allclose(tev.values.numpy(),
                                   np.asarray(jev.values), rtol=0,
                                   atol=STATE_ATOL)
        for (p, got), ref in zip(
                leaves_with_paths(ts.tables[name].slot),
                jax.tree_util.tree_leaves(js.tables[name].slot)):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       rtol=0, atol=STATE_ATOL, err_msg=p)
    assert tt.table_health(ts) == jt.table_health(js)
    ref = [np.asarray(x) for x in jax.tree_util.tree_leaves(
        (js.params, js.opt_state, js.step))]
    got = tsaver._dense_leaves(tt, ts)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(np.asarray(g), r, rtol=0,
                                   atol=STATE_ATOL)


def _criteo(seed, n, batch=B):
    return list(SyntheticCriteo(batch_size=batch, seed=seed).take(n))


@pytest.mark.parametrize("metadata", [False, True],
                         ids=["light", "metadata"])
def test_device_trainer_matches_jax(metadata):
    jt, tt = _dlrm_pair(metadata)
    js, ts = _lockstep(jt, tt, _criteo(21, STEPS))
    _assert_same(jt, js, tt, ts)
    h = tt.table_health(ts)["emb"]
    assert h["unique_saturated_steps"] > 0 and h["size"] > 0
    if metadata:
        assert int(ts.tables["emb"].ev.versions.max()) == STEPS - 1
    # one eval step: read-only, unseen keys read their init row
    held = _criteo(99, 1)[0]
    size = int(ts.tables["emb"].ev.index.size)
    jm = jmetrics.summarize(jt.eval_step(js, jmetrics.create(), held))
    tm = tmetrics.summarize(tt.eval_step(ts, tmetrics.create(device="cpu"),
                                         held))
    assert int(ts.tables["emb"].ev.index.size) == size
    for k in ("auc", "accuracy", "loss"):
        assert abs(tm[k] - jm[k]) <= 1e-4, (k, tm, jm)


def test_growth_mid_training_matches_jax():
    jt, tt = _dlrm_pair(capacity=256)
    caps = []

    def grow(js, ts):
        js, ts = jt.maybe_grow(js), tt.maybe_grow(ts)
        caps.append((ts.tables["emb"].ev.capacity,
                     js.tables["emb"].ev.capacity))
        return js, ts
    js, ts = _lockstep(jt, tt, _criteo(3, 4), after_step=grow)
    assert all(t == j for t, j in caps) and caps[-1][0] > 256, caps
    assert tt.collections["emb"].config.capacity == caps[-1][0]
    _assert_same(jt, js, tt, ts)


def _behavior(seed, n):
    return list(SyntheticBehavior(batch_size=B, max_len=HIST, seed=seed,
                                  n_items=300, n_users=40).take(n))


def _seq_pair(kind, microbatches=1):
    def cols(fcm):
        cat, emb = fcm.CategoricalColumn, fcm.EmbeddingColumn
        return [
            emb(cat("item", shared_embedding="item_space"), DIM),
            emb(cat("cate", shared_embedding="cate_space"), DIM),
            emb(cat("uid"), DIM),
            fcm.SequenceEmbeddingColumn(cat("hist_item", max_length=HIST,
                                            shared_embedding="item_space"),
                                        DIM),
            fcm.SequenceEmbeddingColumn(cat("hist_cate", max_length=HIST,
                                            shared_embedding="cate_space"),
                                        DIM)]
    kw = dict(name="emb", capacity=CAP, max_unique=int(B * 19 * 0.75))
    jcoll = jfc.EmbeddingCollection(
        cols(jfc), initializer=dr.Initializer("normal", scale=0.05), **kw)
    tcoll = tfc.EmbeddingCollection(
        cols(tfc), initializer=tcfg.Initializer("normal", scale=0.05), **kw)
    mk = dict(candidate_name="item", seq_name="hist_item",
              candidate_context_names=["cate"],
              seq_context_names=["hist_cate"], context_names=["uid"],
              hidden_units=(16, 8), att_units=(8, 4))
    if kind == "din":
        jm, tm, jf, tf = jseq.DIN(**mk), tseq.DIN(emb_dim=DIM, **mk), \
            None, None
    else:
        jm = jseq.DIEN(gru_units=2 * DIM, use_aux_loss=True, **mk)
        tm = tseq.DIEN(emb_dim=DIM, gru_units=2 * DIM, use_aux_loss=True,
                       **mk)

        def jf(apply_fn, dense, outputs, train):  # modelzoo dien_forward
            emb, seq = outputs["emb"]
            return apply_fn(dense, emb, seq=seq, train=train,
                            return_aux=train)
        tf = tseq.dien_forward
    jt = JTrainer(model=jm, numeric_columns=[], collections={"emb": jcoll},
                  sparse_optimizers={"emb": jsopt.sparse_adam(0.002)},
                  dense_optimizer=optax.adam(0.002), forward=jf,
                  aux_loss_weight=1.0, microbatches=microbatches)
    tt = TTrainer(tm, [], {"emb": tcoll}, {"emb": tsopt.sparse_adam(0.002)},
                  tdense.Adam(0.002), forward=tf, aux_loss_weight=1.0,
                  microbatches=microbatches, device="cpu")
    return jt, tt


@pytest.mark.parametrize("model", ["dlrm", "din"])
def test_microbatches_match_jax(model):
    if model == "dlrm":
        jt, tt = _dlrm_pair(True, microbatches=2)
        batches = _criteo(8, 3)
    else:
        jt, tt = _seq_pair("din", microbatches=2)
        batches = _behavior(8, 3)
    js, ts = _lockstep(jt, tt, batches)
    _assert_same(jt, js, tt, ts)
    if model == "din":  # the Dice statistics moved, as the last slice's
        assert any(float(b.abs().sum()) > 0 for b in tt.model.buffers())


def test_dien_trains_like_jax():
    jt, tt = _seq_pair("dien")
    js, ts = _lockstep(jt, tt, _behavior(4, 3))
    _assert_same(jt, js, tt, ts)


def _flat_pair():
    """Columns that take the flat dedup: a 3-wide multivalent mean and
    sqrtn pair, a hash-bucket column and two columns sharing rows."""
    def cols(fcm):
        cat, emb = fcm.CategoricalColumn, fcm.EmbeddingColumn
        return [emb(cat("multi", max_length=3), DIM, combiner="mean"),
                emb(cat("multi2", max_length=3), DIM, combiner="sqrtn"),
                emb(cat("bucket", hash_bucket_size=50), DIM),
                emb(cat("a", shared_embedding="s"), DIM),
                emb(cat("b", shared_embedding="s"), DIM)]
    names = ["multi", "multi2", "bucket", "a", "b"]
    kw = dict(name="emb", capacity=CAP, max_unique=200,
              counter_filter=None)
    jcoll = jfc.EmbeddingCollection(cols(jfc), **kw)
    tcoll = tfc.EmbeddingCollection(cols(tfc), **kw)
    assert not tcoll._column_dedup_ok
    jt = JTrainer(model=jctr.DLRM(emb_names=names, emb_dim=DIM,
                                  bottom_units=(16,), top_units=(16,)),
                  numeric_columns=[jfc.NumericColumn("x", shape=2)],
                  collections={"emb": jcoll},
                  sparse_optimizers={"emb": jsopt.sparse_adagrad(0.05)},
                  dense_optimizer=optax.adagrad(0.05))
    tt = TTrainer(tctr.DLRM(names, DIM, bottom_units=(16,),
                            top_units=(16,), dense_dim=2),
                  [tfc.NumericColumn("x", shape=2)], {"emb": tcoll},
                  {"emb": tsopt.sparse_adagrad(0.05)}, tdense.Adagrad(0.05),
                  device="cpu")
    return jt, tt


def _flat_batches(seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        multi = rng.integers(0, 40, (B, 3))
        multi[rng.random((B, 3)) < 0.3] = -1  # ragged: -1 pads
        out.append({"multi": multi, "multi2": rng.integers(0, 40, (B, 3)),
                    "bucket": rng.integers(-(1 << 40), 1 << 40, B),
                    "a": rng.integers(0, 30, B), "b": rng.integers(0, 30, B),
                    "x": rng.random((B, 2)).astype(np.float32),
                    "label": (rng.random(B) < 0.4).astype(np.float32)})
    return out


def test_flat_unique_columns_match_jax():
    jt, tt = _flat_pair()
    js, ts = _lockstep(jt, tt, _flat_batches(5, 4))
    _assert_same(jt, js, tt, ts)
    # a shared id keys one row: "a" and "b" salt alike
    coll = tt.collections["emb"]
    assert (coll.transform_raw_keys("a", np.array([7]))
            == coll.transform_raw_keys("b", np.array([7]))).all()
    jcoll = jt.collections["emb"]
    raw = np.array([5, -1, 123456789012], np.int64)
    for c in ("multi", "bucket", "b"):
        np.testing.assert_array_equal(coll.transform_raw_keys(c, raw),
                                      jcoll.transform_raw_keys(c, raw))
    # a raw per-column dict, salted and bucketed on the device
    # (``_flatten_ids``), looks up as the JAX package's; read-only too
    batch = {k: v for k, v in _flat_batches(6, 1)[0].items()
             if k not in ("x", "label")}
    jst, jaux = jcoll.lookup_or_create(jcoll.init(), batch, 0)
    tst, taux = coll.lookup_or_create(coll.init("cpu"), batch, 0)
    for f in ("slots", "created", "admitted"):
        np.testing.assert_array_equal(getattr(taux.ev_aux, f).numpy(),
                                      np.asarray(getattr(jaux.ev_aux, f)))
    jaux, jrows = jcoll.readonly_rows(jst, batch)
    taux, trows = coll.readonly_rows(tst, batch)
    np.testing.assert_array_equal(taux.ev_aux.uniq.inverse.numpy(),
                                  np.asarray(jaux.ev_aux.uniq.inverse))
    np.testing.assert_allclose(trows.numpy(), np.asarray(jrows), rtol=0,
                               atol=1e-6)
