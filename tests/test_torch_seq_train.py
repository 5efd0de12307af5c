"""Port parity for the sequence slice's training and serving: DIN and DIEN
built as ``modelzoo/DIN/train.py`` and ``modelzoo/DIEN/train.py``
``build()`` does under ``--host_index`` (the item and category spaces
shared between the candidate and the 8-long histories, ``sparse_adam`` +
``optax.adam``, DIEN through ``dien_forward`` with its auxiliary loss
weighted 1.0), at small widths on SyntheticBehavior.

- The sequence columns expand as the JAX package's: masks bit-equal,
  rows equal, in training (slot mask) and serving (EMPTY mask), with an
  int16 and an int32 ``inverse`` wire; their gradient lands on the same
  unique lanes.
- The port's Trainer runs in lockstep with the JAX one: wires bit-equal,
  losses, rows, Adam's slot leaves, the dense leaves (the Dice running
  statistics and Adam's zero leaves for them included) within the
  tolerances below, the null row zeros on both sides, an eval step.
- Full and incremental saves restore both ways and go on in lockstep; both
  frameworks' Predictors serve them; a save whose statistics' Adam leaves
  moved, or that lacks them, is refused.
- ``Trainer.init`` leaves the Dice statistics at their initial values.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import deeprec_tpu as dr
from deeprec_tpu import feature_column as jfc
from deeprec_tpu.checkpoint import saver as jsaver
from deeprec_tpu.data.behavior import SyntheticBehavior
from deeprec_tpu.host_index import HostIndexEmbeddingCollection as JHost
from deeprec_tpu.models import sequence as jseq
from deeprec_tpu.optim import sparse as jsopt
from deeprec_tpu.serving import Predictor as JPredictor
from deeprec_tpu.train import metrics as jmetrics
from deeprec_tpu.train.trainer import Trainer as JTrainer

from deeprec_tpu_torch import config as tcfg
from deeprec_tpu_torch import feature_column as tfc
from deeprec_tpu_torch.checkpoint import format as tformat
from deeprec_tpu_torch.checkpoint import saver as tsaver
from deeprec_tpu_torch.host_index import HostIndexEmbeddingCollection as THost
from deeprec_tpu_torch.models import ctr as tctr
from deeprec_tpu_torch.models import sequence as tseq
from deeprec_tpu_torch.optim import dense as tdense
from deeprec_tpu_torch.optim import sparse as tsopt
from deeprec_tpu_torch.serving import Predictor as TPredictor
from deeprec_tpu_torch.serving import TieredPredictor as TTieredPredictor
from deeprec_tpu_torch.train import metrics as tmetrics
from deeprec_tpu_torch.train.trainer import Trainer as TTrainer

torch.set_num_threads(1)

B, CAP, DIM, HIST, STEPS = 128, 1 << 12, 8, 8, 8
LOSS_ATOL = 1e-4   # per-step loss: f32 products and sums in another order
STATE_ATOL = 1e-4  # rows, slot rows, dense leaves after STEPS of such drift
ROW_ATOL = 1e-6    # rows and dense leaves through a save
RTOL, ATOL = 2e-4, 2e-5  # served probabilities (test_torch_serving.py)
MODEL_KW = dict(candidate_name="item", seq_name="hist_item",
                candidate_context_names=["cate"],
                seq_context_names=["hist_cate"], context_names=["uid"],
                hidden_units=(16, 8), att_units=(8, 4))
SEQ = ("hist_item", "hist_cate")


def _columns(fcm):
    """The columns of the zoo's DIN and DIEN ``build()``."""
    cat, emb = fcm.CategoricalColumn, fcm.EmbeddingColumn
    return [
        emb(cat("item", shared_embedding="item_space"), DIM),
        emb(cat("cate", shared_embedding="cate_space"), DIM),
        emb(cat("uid"), DIM),
        fcm.SequenceEmbeddingColumn(
            cat("hist_item", max_length=HIST, shared_embedding="item_space"),
            DIM),
        fcm.SequenceEmbeddingColumn(
            cat("hist_cate", max_length=HIST, shared_embedding="cate_space"),
            DIM)]


def _collection(port, max_unique=None):
    fcm, cfgm, host = (tfc, tcfg, THost) if port else (jfc, dr, JHost)
    cols = _columns(fcm)
    width = sum(c.categorical.max_length for c in cols)
    # the CLI's max_unique_ratio 0.75; one hash group, so the JAX side's
    # C++ resolver and its Python fallback order slots alike
    return host(cols, name="emb", capacity=CAP,
                initializer=cfgm.Initializer("normal", scale=0.05),
                max_unique=max_unique or max(256, int(width * B * 0.75)),
                n_groups=1)


def _jax_dien_forward(apply_fn, dense, outputs, train):
    # modelzoo/DIEN/train.py dien_forward (a script, not importable here)
    emb, seq = outputs["emb"]
    return apply_fn(dense, emb, seq=seq, train=train, return_aux=train)


def _jax_serve_dien(apply_fn, dense, outputs, train):
    """The JAX Predictor builds its parameter template from a model init
    through its forward with ``train=False``; with ``dien_forward`` that
    omits ``aux_proj``, and a DIEN save no longer fits (a fault of the
    reference, ROADMAP Queue C). This forward keeps the auxiliary head in
    the template; the Predictor serves the logits alone."""
    emb, seq = outputs["emb"]
    return apply_fn(dense, emb, seq=seq, train=train, return_aux=True)


def _models(kind):
    if kind == "din":
        return (jseq.DIN(**MODEL_KW), tseq.DIN(emb_dim=DIM, **MODEL_KW))
    return (jseq.DIEN(gru_units=2 * DIM, use_aux_loss=True, **MODEL_KW),
            tseq.DIEN(emb_dim=DIM, gru_units=2 * DIM, use_aux_loss=True,
                      **MODEL_KW))


def _forwards(kind):
    return ((None, None) if kind == "din"
            else (_jax_dien_forward, tseq.dien_forward))


def _trainers(kind, dense_opt="adam"):
    jm, tm = _models(kind)
    jf, tf = _forwards(kind)
    jt = JTrainer(model=jm, numeric_columns=[],
                  collections={"emb": _collection(False)},
                  sparse_optimizers={"emb": jsopt.sparse_adam(0.002)},
                  dense_optimizer=optax.adam(0.002), forward=jf,
                  aux_loss_weight=1.0)
    tt = TTrainer(tm, [], {"emb": _collection(True)},
                  {"emb": tsopt.sparse_adam(0.002)},
                  tdense.Adam(0.002) if dense_opt == "adam"
                  else tdense.Adagrad(0.05), forward=tf,
                  aux_loss_weight=1.0, device="cpu")
    return jt, tt


def _batches(seed, n, batch=B):
    return list(SyntheticBehavior(batch_size=batch, max_len=HIST,
                                  seed=seed).take(n))


def _carried(jt, tt, batch):
    """Both trainers' states, the flax init's variables and optimizer
    state carried into the port's."""
    js, ts = jt.init(jax.random.key(0), batch), tt.init(batch)
    tctr.load_flax_params(tt.model, [np.asarray(x) for x in
                                     jax.tree_util.tree_leaves(js.params)])
    return js, ts._replace(opt_state=tt.dense_optimizer.load_flax_state(
        tt.model, [np.asarray(x)
                   for x in jax.tree_util.tree_leaves(js.opt_state)]))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _table(coll, bundle):
    """The live table by key: sorted keys, the rows' planes, slot rows."""
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
    """One train step; returns (state, wire bytes, loss)."""
    d, c, lab = trainer.prepare_batch(batch)
    jaxy = isinstance(trainer, JTrainer)
    before = float(state.metrics.loss_sum)
    state = (trainer._jit_train if jaxy else trainer._train_step)(
        state, d, c, lab)
    return (state, _np(c["emb"].buf).tobytes(),
            (float(state.metrics.loss_sum) - before) / B)


def _predictors(kind, path, jt, tt):
    (jm, tm), (_, tf) = _models(kind), _forwards(kind)
    return (TPredictor(tm, [], tt.collections, path, device="cpu",
                       forward=tf),
            JPredictor(jm, [], jt.collections, path,
                       forward=None if kind == "din" else _jax_serve_dien))


def _null_rows(js, ts):
    """The null row (``values[capacity]``) of both tables: what a padded
    history position reads in the JAX package."""
    return (np.asarray(js.tables["emb"].ev.values)[CAP],
            ts.tables["emb"].ev.values[CAP].numpy())


@pytest.mark.parametrize("inverse", ["int16", "int32"])
def test_sequence_columns_match_jax(inverse):
    """Mirrors tests/test_host_index.py:201 at the collection: the port's
    sequence_embeddings (K2 over one-id bags) against the JAX gather
    ``urows[inverse]``, from one set of unique rows. Training masks by the
    slots, serving by EMPTY; the shared item and category spaces salt the
    histories like their candidates; with a max_unique past 32,767 the
    wire carries an int32 inverse."""
    mu = 40_000 if inverse == "int32" else None
    jc, tc = _collection(False, mu), _collection(True, mu)
    js, ts = jc.init(), tc.init("cpu")
    rng = np.random.default_rng(0)
    for step, batch in enumerate(_batches(5, 3)):
        jw, tw = jc.pack_ids(batch), tc.pack_ids(batch, "cpu")
        assert np.asarray(jw.buf).tobytes() == tw.buf.numpy().tobytes()
        assert tw.inv16 == (inverse == "int16")
        js, jaux = jc.lookup_or_create(js, jw, jnp.asarray(step, jnp.int32))
        ts, taux = tc.lookup_or_create(ts, tw, step)
        urows = np.asarray(jc.rows_for_training(js, jaux))
        turows = torch.from_numpy(urows.copy()).requires_grad_(True)
        jseqs = jc.sequence_embeddings(urows, jaux)
        tseqs = tc.sequence_embeddings(turows, taux)
        assert sorted(tseqs) == sorted(SEQ)
        for n in SEQ:
            (jr, jm), (tr, tm) = jseqs[n], tseqs[n]
            assert tr.shape == (B, HIST, DIM)
            np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
            # valid positions read their rows; the JAX package's padded
            # positions read the null row, zeros like the port's
            np.testing.assert_array_equal(_np(tr), np.asarray(jr))
            assert not _np(tr)[~tm.numpy()].any()
        # pooled columns are untouched by the sequence ones
        jp, tp = jc.embeddings(urows, jaux), tc.embeddings(turows, taux)
        assert sorted(tp) == ["cate", "item", "uid"]
        for n in tp:
            np.testing.assert_array_equal(_np(tp[n]), np.asarray(jp[n]))

        # gradient: K2's backward onto the unique lanes
        w = {n: rng.normal(size=(B, HIST, DIM)).astype(np.float32)
             for n in SEQ}
        sum(((tseqs[n][0] * torch.from_numpy(w[n])).sum() for n in SEQ)
            ).backward()
        _, vjp = jax.vjp(lambda u: {n: jc.sequence_embeddings(u, jaux)[n][0]
                                    for n in SEQ}, jnp.asarray(urows))
        (jgrad,) = vjp(w)
        live = taux.ev_aux.slots.numpy() != CAP
        np.testing.assert_allclose(turows.grad.numpy()[live],
                                   np.asarray(jgrad)[live], rtol=1e-6,
                                   atol=1e-6)
        # padded positions send nothing to the null lanes
        assert not turows.grad.numpy()[~live].any()

    # serving: find-only resolves, EMPTY keys masked, unknown keys read
    # their init rows
    held = _batches(99, 1)[0]
    jaux, jrows = jc.readonly_rows(js, held)
    taux, trows = tc.readonly_rows(ts, held)
    rows = np.asarray(jrows)
    np.testing.assert_allclose(trows.numpy(), rows, rtol=0, atol=1e-6)
    jpool, jseqs = jc.embeddings_readonly(rows, jaux)
    tpool, tseqs = tc.embeddings_readonly(torch.from_numpy(rows.copy()),
                                          taux)
    assert not taux.ev_aux.admitted.all()  # some keys were unseen
    for n in SEQ:
        (jr, jm), (tr, tm) = jseqs[n], tseqs[n]
        m = tm.numpy()
        np.testing.assert_array_equal(m, np.asarray(jm))
        np.testing.assert_array_equal(m, held[n] != -1)
        np.testing.assert_array_equal(tr.numpy()[m], np.asarray(jr)[m])
        assert not tr.numpy()[~m].any()
    for n in tpool:
        np.testing.assert_array_equal(tpool[n].numpy(), np.asarray(jpool[n]))


@pytest.mark.parametrize("kind", ["din", "dien"])
def test_sequence_trainer_matches_jax(kind, tmp_path):
    jt, tt = _trainers(kind)
    batches = _batches(21, STEPS)
    js, ts = _carried(jt, tt, batches[0])

    for step, batch in enumerate(batches):
        js, jw, jl = _step(jt, js, batch)
        ts, tw, tl = _step(tt, ts, batch)
        assert jw == tw, step  # the resolver's wire, bit-equal
        assert np.isfinite(tl) and abs(jl - tl) <= LOSS_ATOL, (step, jl, tl)
    assert ts.step == int(js.step) == STEPS

    _assert_same_table(_table(tt.collections["emb"], ts.tables["emb"]),
                       _table(jt.collections["emb"], js.tables["emb"]),
                       STATE_ATOL)
    # the null row, which JAX feeds a padded position, stayed zeros
    for row in _null_rows(js, ts):
        assert not row.any()
    got, ref = _dense(tt, ts), _dense(jt, js)  # variables, adam, step
    assert len(got) == len(ref)
    n_bs = len(jax.tree_util.tree_leaves(js.params["batch_stats"]))
    n_var = len(jax.tree_util.tree_leaves(js.params))
    assert n_bs == 4 and n_var == (18 if kind == "din" else 30)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape and g.dtype == r.dtype
        np.testing.assert_allclose(g, r, rtol=0, atol=STATE_ATOL, err_msg=i)
    # the statistics moved, and Adam's leaves for them stayed zeros
    assert not np.allclose(got[0], 0.0)
    for o in (n_var + 1, 2 * n_var + 1):
        for g in got[o:o + n_bs]:
            assert not g.any()
    jm, tm = jmetrics.summarize(js.metrics), tmetrics.summarize(ts.metrics)
    assert tm["examples"] == jm["examples"] == STEPS * B
    for k in ("auc", "accuracy", "loss"):
        assert abs(tm[k] - jm[k]) <= 1e-4, (k, tm, jm)

    # one eval step: read-only resolves, the running statistics, no
    # auxiliary loss
    held = _batches(99, 2)
    size = tt.collections["emb"]._resolver.size
    stats = [b.clone() for b in tt.model.buffers()]
    jm = jmetrics.summarize(jt.eval_step(js, jmetrics.create(), held[0]))
    tm = tmetrics.summarize(tt.eval_step(ts, tmetrics.create(device="cpu"),
                                         held[0]))
    assert size == tt.collections["emb"]._resolver.size
    assert all(torch.equal(a, b) for a, b in zip(stats, tt.model.buffers()))
    for k in ("auc", "accuracy", "loss"):
        assert abs(tm[k] - jm[k]) <= 1e-4, (k, tm, jm)

    # each framework's save, served by the port's Predictor as by the JAX
    # one, the running statistics loaded
    for writer, (t, s) in (("jax", (jt, js)), ("port", (tt, ts))):
        path = str(tmp_path / writer)
        (jsaver if writer == "jax" else tsaver).CheckpointManager(
            path).save(t, s)
        tp, jp = _predictors(kind, path, jt, tt)
        np.testing.assert_allclose(tctr.flax_leaves(tp.model)[0], got[0],
                                   rtol=0, atol=STATE_ATOL)
        for b in held:
            p = tp.predict(b)
            assert p.shape == (B,) and np.isfinite(p).all()
            np.testing.assert_allclose(p, np.asarray(jp.predict(b)),
                                       rtol=RTOL, atol=ATOL, err_msg=writer)
    assert size == tt.collections["emb"]._resolver.size


def _rewrite_dense(path, leaves):
    np.savez(os.path.join(path, tformat.DENSE),
             **{f"d{i:05d}": leaf for i, leaf in enumerate(leaves)})


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_din_save_restores_into_both_trainers(writer, tmp_path):
    """A DIN full save and an incremental, from either framework: rows,
    Adam's slot columns, the Dice statistics, Adam's dense state with its
    zero leaves for them, restored into fresh JAX and port trainers, which
    go on in lockstep; both Predictors serve the incremental, and a
    TieredPredictor too. A save whose statistics' Adam leaves moved, or
    that lacks them, is refused."""
    batches = _batches(31, 9)
    jt, tt = _trainers("din")
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
    live = _table(wt.collections["emb"], ws.tables["emb"])

    jt2, tt2 = _trainers("din")
    js2, ok_j = jsaver.CheckpointManager(str(tmp_path)).restore(
        jt2, jt2.init(jax.random.key(1), batches[0]))
    ts2, ok_t = tsaver.CheckpointManager(str(tmp_path)).restore(
        tt2, tt2.init(batches[0]))
    assert ok_j and ok_t and int(js2.step) == ts2.step == int(ws.step)
    assert sorted(live[1]) == ["create_steps", "freqs", "slot m", "slot v",
                               "values", "versions"]
    _assert_same_table(_table(jt2.collections["emb"], js2.tables["emb"]),
                       live, ROW_ATOL)
    _assert_same_table(_table(tt2.collections["emb"], ts2.tables["emb"]),
                       live, ROW_ATOL)
    ref = _dense(wt, ws)
    assert not np.allclose(ref[0], 0.0)  # dice_0's mean moved in training
    for restored in (_dense(jt2, js2), _dense(tt2, ts2)):
        assert len(restored) == len(ref)
        for g, r in zip(restored, ref):
            assert g.dtype == r.dtype
            np.testing.assert_allclose(g, r, rtol=0, atol=ROW_ATOL)

    held = _batches(77, 1)[0]
    tp, jp = _predictors("din", str(tmp_path), jt2, tt2)
    probs = tp.predict(held)
    np.testing.assert_allclose(probs, np.asarray(jp.predict(held)),
                               rtol=RTOL, atol=ATOL)
    # a TieredPredictor keeps part of the rows on the host: same answers
    budget = live[0].shape[0] // 2
    tiered = TTieredPredictor(_models("din")[1], [], tt2.collections,
                              str(tmp_path), device_row_budget=budget,
                              device="cpu")
    assert len(tiered.host_store["emb"]) > 0
    np.testing.assert_allclose(tiered.predict(held), probs, rtol=0,
                               atol=1e-6)

    for b in batches[6:]:  # both restored trainers go on together
        js2, jw, jl = _step(jt2, js2, b)
        ts2, tw, tl = _step(tt2, ts2, b)
        assert jw == tw and abs(jl - tl) <= LOSS_ATOL

    # the newest save's dense leaves: variables (18), count, mu, nu, step
    newest = tformat.list_saves(str(tmp_path))[-1]["path"]
    leaves = tformat.read_dense(newest)
    n_var = 18
    assert len(leaves) == 3 * n_var + 2
    for fault, what in (("moved", "running statistic"),
                        ("missing", "dense leaves")):
        bad = [np.array(x) for x in leaves]
        if fault == "moved":
            bad[n_var + 1] = bad[n_var + 1] + 0.5  # mu of dice_0's mean
        else:  # an optimizer state over the params alone
            bad = (bad[:n_var + 1] + bad[n_var + 5:2 * n_var + 1]
                   + bad[2 * n_var + 5:])
        _rewrite_dense(newest, bad)
        tt3 = _trainers("din")[1]
        with pytest.raises(ValueError, match=what):
            tsaver.CheckpointManager(str(tmp_path)).restore(
                tt3, tt3.init(batches[0]))


@pytest.mark.parametrize("kind", ["din", "dien"])
def test_init_leaves_dice_statistics(kind):
    """``Trainer.init``'s throwaway forward runs in training mode, as
    ``model.init`` does, and moves no running statistic: mean 0, var 1,
    as flax's init leaves its batch_stats."""
    jt, tt = _trainers(kind)
    batch = _batches(3, 1)[0]
    tt.init(batch)
    js = jt.init(jax.random.key(0), batch)
    for i in range(2):
        dice = tt.model.dice[i]
        assert torch.equal(dice.mean, torch.zeros_like(dice.mean))
        assert torch.equal(dice.var, torch.ones_like(dice.var))
        ref = js.params["batch_stats"][f"dice_{i}"]
        np.testing.assert_array_equal(dice.mean.numpy(),
                                      np.asarray(ref["mean"]))
        np.testing.assert_array_equal(dice.var.numpy(),
                                      np.asarray(ref["var"]))
