"""Port parity for the CTR zoo's training: DCN, WDL, DeepFM and DSSM built
as their ``modelzoo/*/train.py`` ``build()`` does under ``--host_index``
(at small widths), with their zoo optimizers: ``sparse_adagrad`` and
``optax.adagrad`` (DCN), plus ``sparse_ftrl`` on the dim-1 ``"wide"`` table
(WDL, DeepFM), ``sparse_adam`` and ``optax.adam`` (DSSM, on
SyntheticBehavior with the shared item space and a mean-pooled, -1 padded
history). The port's Trainer runs in lockstep with the JAX Trainer:
resolver output bit-equal every step, losses, rows, slot leaves,
parameters, the dense optimizer's state and an eval step within the
tolerances below. Saves restore both ways (the FTRL slot columns, the
Adam dense state), and the port's Predictor serves both frameworks'
saves as the JAX Predictor does."""
import numpy as np
import pytest
import torch

import jax
import optax

import deeprec_tpu as dr
from deeprec_tpu import feature_column as jfc
from deeprec_tpu.checkpoint import saver as jsaver
from deeprec_tpu.data.behavior import SyntheticBehavior
from deeprec_tpu.data.criteo import CAT_NAMES, DENSE_NAMES, SyntheticCriteo
from deeprec_tpu.host_index import HostIndexEmbeddingCollection as JHost
from deeprec_tpu.models import ctr as jctr
from deeprec_tpu.optim import sparse as jsopt
from deeprec_tpu.serving import Predictor as JPredictor
from deeprec_tpu.train import metrics as jmetrics
from deeprec_tpu.train.trainer import Trainer as JTrainer

from deeprec_tpu_torch import config as tcfg
from deeprec_tpu_torch import feature_column as tfc
from deeprec_tpu_torch.checkpoint import saver as tsaver
from deeprec_tpu_torch.host_index import HostIndexEmbeddingCollection as THost
from deeprec_tpu_torch.models import ctr as tctr
from deeprec_tpu_torch.optim import dense as tdense
from deeprec_tpu_torch.optim import sparse as tsopt
from deeprec_tpu_torch.serving import Predictor as TPredictor
from deeprec_tpu_torch.train import metrics as tmetrics
from deeprec_tpu_torch.train.trainer import Trainer as TTrainer

torch.set_num_threads(1)

B, CAP, DIM, HIST, STEPS = 128, 1 << 12, 8, 8, 8
COLS = CAT_NAMES[:6]
LOSS_ATOL = 1e-4   # per-step loss: f32 products and sums in another order
STATE_ATOL = 1e-4  # rows, slot rows, parameters after STEPS of such drift
ROW_ATOL = 1e-6    # rows and dense leaves through a save
RTOL, ATOL = 2e-4, 2e-5  # served probabilities (test_torch_serving.py)
MODELS = ("dcn", "wdl", "deepfm", "dssm")


def _columns(fcm, kind):
    """Collection name -> columns, as the zoo's ``build()`` makes them."""
    cat, emb = fcm.CategoricalColumn, fcm.EmbeddingColumn
    if kind == "dssm":
        return {"emb": [
            emb(cat("uid"), DIM),
            emb(cat("item", shared_embedding="item_space"), DIM),
            emb(cat("cate"), DIM),
            emb(cat("hist_item", max_length=HIST,
                    shared_embedding="item_space"), DIM, combiner="mean")]}
    out = {"emb": [emb(cat(n), DIM) for n in COLS]}
    if kind in ("wdl", "deepfm"):
        out["wide"] = [emb(cat(n), 1) for n in COLS]
    return out


def _collections(kind, port):
    fcm, cfgm, host = (tfc, tcfg, THost) if port else (jfc, dr, JHost)
    ratio = 0.75 if kind == "dssm" else 0.25  # the CLI's max_unique_ratio
    out = {}
    for name, cols in _columns(fcm, kind).items():
        width = sum(c.categorical.max_length for c in cols)
        init = (cfgm.Initializer("zeros") if name == "wide"
                else cfgm.Initializer("normal", scale=0.05))
        # one hash group: the JAX side's C++ resolver and its Python
        # fallback assign slots in the same order, whichever it got
        out[name] = host(cols, name=name, capacity=CAP, initializer=init,
                         max_unique=max(256, int(width * B * ratio)),
                         n_groups=1)
    return out


def _models(kind):
    if kind == "dcn":
        return (jctr.DCN(emb_names=COLS, cross_layers=2, deep_units=(16, 8)),
                tctr.DCN(COLS, DIM, cross_layers=2, deep_units=(16, 8),
                         dense_dim=len(DENSE_NAMES)))
    if kind == "wdl":
        return (jctr.WDL(emb_names=COLS, wide_names=COLS, deep_units=(16, 8)),
                tctr.WDL(COLS, COLS, DIM, deep_units=(16, 8),
                         dense_dim=len(DENSE_NAMES)))
    if kind == "deepfm":
        return (jctr.DeepFM(emb_names=COLS, wide_names=COLS,
                            deep_units=(16, 16)),
                tctr.DeepFM(COLS, COLS, DIM, deep_units=(16, 16),
                            dense_dim=len(DENSE_NAMES)))
    user, item = ["uid", "hist_item"], ["item", "cate"]
    return (jctr.DSSM(user_emb_names=user, item_emb_names=item,
                      tower_units=(16,), out_dim=8),
            tctr.DSSM(user, item, DIM, tower_units=(16,), out_dim=8))


def _numeric(kind, fcm):
    if kind == "dssm":
        return []
    return [fcm.NumericColumn(n, log_normalize=True) for n in DENSE_NAMES]


def _sparse(kind, mod):
    if kind == "dssm":
        return {"emb": mod.sparse_adam(0.002)}
    out = {"emb": mod.sparse_adagrad(0.05)}
    if kind in ("wdl", "deepfm"):
        out["wide"] = mod.sparse_ftrl(0.05)
    return out


def _trainers(kind):
    jm, tm = _models(kind)
    jt = JTrainer(model=jm, numeric_columns=_numeric(kind, jfc),
                  collections=_collections(kind, False),
                  sparse_optimizers=_sparse(kind, jsopt),
                  dense_optimizer=(optax.adam(0.002) if kind == "dssm"
                                   else optax.adagrad(0.05)))
    tt = TTrainer(tm, _numeric(kind, tfc), _collections(kind, True),
                  _sparse(kind, tsopt),
                  tdense.Adam(0.002) if kind == "dssm"
                  else tdense.Adagrad(0.05), device="cpu")
    return jt, tt


def _batches(kind, seed, n):
    gen = (SyntheticBehavior(batch_size=B, max_len=HIST, seed=seed)
           if kind == "dssm" else SyntheticCriteo(batch_size=B, seed=seed))
    return list(gen.take(n))


def _carried(jt, tt, batch):
    """Both trainers' states, with the flax init's weights and optimizer
    state carried into the port's."""
    js, ts = jt.init(jax.random.key(0), batch), tt.init(batch)
    tctr.load_flax_params(tt.model, [np.asarray(x) for x in
                                     jax.tree_util.tree_leaves(js.params)])
    return js, ts._replace(opt_state=tt.dense_optimizer.load_flax_state(
        tt.model, [np.asarray(x)
                   for x in jax.tree_util.tree_leaves(js.opt_state)]))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _jkeys(k):
    return (np.asarray(k.hi).astype(np.int64) << 32) | \
        np.asarray(k.lo).astype(np.uint32).astype(np.int64)


def _table(coll, bundle):
    """The live table by key: sorted keys, the rows' planes and slot rows."""
    keys = coll._resolver.export_keys()
    n, order = keys.shape[0], np.argsort(keys)
    out = {f: _np(getattr(bundle.ev, f))[:n][order]
           for f in ("values", "freqs", "versions", "create_steps")}
    out.update({f"slot {k}": _np(v)[:n][order]
                for k, v in bundle.slot.items()})
    return keys[order], out


def _assert_same_table(got, ref, atol):
    (gk, g), (rk, r) = got, ref
    np.testing.assert_array_equal(gk, rk)  # key sets, bit-equal
    assert sorted(g) == sorted(r)
    for f in g:
        if f in ("freqs", "versions", "create_steps"):
            np.testing.assert_array_equal(g[f], r[f], f)
        else:
            np.testing.assert_allclose(g[f], r[f], rtol=0, atol=atol,
                                       err_msg=f)


def _dense(trainer, state):
    if isinstance(trainer, TTrainer):
        return tsaver._dense_leaves(trainer, state)
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(
        (state.params, state.opt_state, state.step))]


def _step(trainer, state, batch):
    """One train step; returns (state, {collection: wire bytes}, loss)."""
    d, c, lab = trainer.prepare_batch(batch)
    jaxy = isinstance(trainer, JTrainer)
    before = float(state.metrics.loss_sum)
    state = (trainer._jit_train if jaxy else trainer._train_step)(
        state, d, c, lab)
    wires = {name: _np(w.buf).tobytes() for name, w in c.items()}
    return state, wires, (float(state.metrics.loss_sum) - before) / B


def _predictors(kind, path, jt, tt):
    _, tm = _models(kind)
    jm, _ = _models(kind)
    return (TPredictor(tm, _numeric(kind, tfc), tt.collections, path,
                       device="cpu"),
            JPredictor(jm, _numeric(kind, jfc), jt.collections, path))


@pytest.mark.parametrize("kind", MODELS)
def test_zoo_trainer_matches_jax(kind, tmp_path):
    jt, tt = _trainers(kind)
    batches = _batches(kind, 21, STEPS)
    js, ts = _carried(jt, tt, batches[0])

    for step, batch in enumerate(batches):
        jd, jc, jl = jt.prepare_batch(batch)
        td, tc, tl = tt.prepare_batch(batch)
        assert sorted(jc) == sorted(tc)
        for name in jc:  # every collection's resolver output, bit-equal
            jr, tr = jc[name].decode(), tc[name].decode()
            np.testing.assert_array_equal(tr.uslots.numpy(),
                                          np.asarray(jr.uslots))
            np.testing.assert_array_equal(tr.ukeys.numpy(), _jkeys(jr.ukeys))
            np.testing.assert_array_equal(tr.inverse.numpy(),
                                          np.asarray(jr.inverse))
            assert int(tr.n_unique) == int(jr.n_unique)
        jloss0, tloss0 = float(js.metrics.loss_sum), \
            float(ts.metrics.loss_sum)
        js = jt._jit_train(js, jd, jc, jl)
        ts = tt._train_step(ts, td, tc, tl)
        jloss = (float(js.metrics.loss_sum) - jloss0) / B
        tloss = (float(ts.metrics.loss_sum) - tloss0) / B
        assert np.isfinite(tloss) and abs(jloss - tloss) <= LOSS_ATOL, \
            (step, jloss, tloss)
    assert ts.step == int(js.step) == STEPS

    for name in jt.collections:  # rows, metadata and slot rows
        _assert_same_table(_table(tt.collections[name], ts.tables[name]),
                           _table(jt.collections[name], js.tables[name]),
                           STATE_ATOL)
    got, ref = _dense(tt, ts), _dense(jt, js)  # params, opt state, step
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype
        np.testing.assert_allclose(g, r, rtol=0, atol=STATE_ATOL)
    jm, tm = jmetrics.summarize(js.metrics), tmetrics.summarize(ts.metrics)
    assert tm["examples"] == jm["examples"] == STEPS * B
    for k in ("auc", "accuracy", "loss"):
        assert abs(tm[k] - jm[k]) <= 1e-4, (k, tm, jm)

    # one eval step: read-only resolves, unseen keys read their init row
    held = _batches(kind, 99, 2)
    sizes = {n: c._resolver.size for n, c in tt.collections.items()}
    jm = jmetrics.summarize(jt.eval_step(js, jmetrics.create(), held[0]))
    tm = tmetrics.summarize(tt.eval_step(ts, tmetrics.create(device="cpu"),
                                         held[0]))
    assert sizes == {n: c._resolver.size for n, c in tt.collections.items()}
    for k in ("auc", "accuracy", "loss"):
        assert abs(tm[k] - jm[k]) <= 1e-4, (k, tm, jm)

    # each framework's save, served by the port's Predictor as by the JAX
    # one
    for writer, (t, s) in (("jax", (jt, js)), ("port", (tt, ts))):
        path = str(tmp_path / writer)
        (jsaver if writer == "jax" else tsaver).CheckpointManager(
            path).save(t, s)
        tp, jp = _predictors(kind, path, jt, tt)
        for b in held:
            p = tp.predict(b)
            assert p.shape == (B,) and np.isfinite(p).all()
            np.testing.assert_allclose(p, np.asarray(jp.predict(b)),
                                       rtol=RTOL, atol=ATOL, err_msg=writer)
    assert sizes == {n: c._resolver.size for n, c in tt.collections.items()}


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("kind", ["wdl", "dssm"])
def test_zoo_save_restores_into_both_trainers(kind, writer, tmp_path):
    """A full save and an incremental, from either framework: the FTRL
    slot columns of WDL's wide table and DSSM's Adam slot columns and
    dense state restore into fresh JAX and port trainers, which go on in
    lockstep."""
    batches = _batches(kind, 31, 9)
    jt, tt = _trainers(kind)
    js, ts = _carried(jt, tt, batches[0])
    wt, ws = (tt, ts) if writer == "port" else (jt, js)
    mgr = (tsaver if writer == "port" else jsaver).CheckpointManager(
        str(tmp_path))
    for b in batches[:4]:
        ws, _, _ = _step(wt, ws, b)
    mgr.save(wt, ws)
    for b in batches[4:6]:
        ws, _, _ = _step(wt, ws, b)
    mgr.save_incremental(wt, ws)
    live = {n: _table(c, ws.tables[n]) for n, c in wt.collections.items()}

    jt2, tt2 = _trainers(kind)
    js2, ok_j = jsaver.CheckpointManager(str(tmp_path)).restore(
        jt2, jt2.init(jax.random.key(1), batches[0]))
    ts2, ok_t = tsaver.CheckpointManager(str(tmp_path)).restore(
        tt2, tt2.init(batches[0]))
    assert ok_j and ok_t and int(js2.step) == ts2.step == int(ws.step)
    for name in live:
        assert any(f.startswith("slot ") for f in live[name][1])
        _assert_same_table(_table(jt2.collections[name], js2.tables[name]),
                           live[name], ROW_ATOL)
        _assert_same_table(_table(tt2.collections[name], ts2.tables[name]),
                           live[name], ROW_ATOL)
    ref = _dense(wt, ws)
    for restored in (_dense(jt2, js2), _dense(tt2, ts2)):
        assert len(restored) == len(ref)
        for g, r in zip(restored, ref):
            assert g.dtype == r.dtype
            np.testing.assert_allclose(g, r, rtol=0, atol=ROW_ATOL)

    for b in batches[6:]:  # both restored trainers go on together
        js2, jw, jl = _step(jt2, js2, b)
        ts2, tw, tl = _step(tt2, ts2, b)
        assert jw == tw and abs(jl - tl) <= LOSS_ATOL

    # a save whose dense state is another optimizer's does not restore
    other = (tdense.Adagrad(0.05) if kind == "dssm" else tdense.Adam(0.002))
    tt3 = TTrainer(_models(kind)[1], _numeric(kind, tfc),
                   _collections(kind, True), _sparse(kind, tsopt), other,
                   device="cpu")
    with pytest.raises(ValueError, match="dense leaves"):
        tsaver.CheckpointManager(str(tmp_path)).restore(
            tt3, tt3.init(batches[0]))
