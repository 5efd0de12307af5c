"""Port parity for checkpoints of a host-index training job: the port's
``CheckpointManager`` and the JAX package's write and read one format.
A save from either framework, full or full + incremental, in the light and
``--metadata`` layouts, restores into both a fresh JAX ``Trainer`` and a
fresh port ``Trainer``: key sets and integer planes bit-equal to the
writer's live table, rows and dense leaves within 1e-6, and the two
restored trainers go on in lockstep. A port-trained save is served by the
port's ``Predictor`` and by the JAX one (rtol 2e-4, atol 2e-5, as in
``test_torch_serving.py``)."""
import json
import os
from typing import NamedTuple

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import deeprec_tpu as dr
from deeprec_tpu import feature_column as jfc
from deeprec_tpu.checkpoint import saver as jsaver
from deeprec_tpu.data.criteo import CAT_NAMES, DENSE_NAMES, SyntheticCriteo
from deeprec_tpu.host_index import HostIndexEmbeddingCollection as JHost
from deeprec_tpu.models import ctr as jctr
from deeprec_tpu.optim import sparse as jsopt
from deeprec_tpu.serving import Predictor as JPredictor
from deeprec_tpu.train.trainer import Trainer as JTrainer

from deeprec_tpu_torch import config as tcfg
from deeprec_tpu_torch import feature_column as tfc
from deeprec_tpu_torch.checkpoint import format as tformat
from deeprec_tpu_torch.checkpoint import saver as tsaver
from deeprec_tpu_torch.host_index import HostIndexEmbeddingCollection as THost
from deeprec_tpu_torch.models import ctr as tctr
from deeprec_tpu_torch.optim import dense as tdense
from deeprec_tpu_torch.optim import sparse as tsopt
from deeprec_tpu_torch.serving import Predictor as TPredictor
from deeprec_tpu_torch.train.trainer import Trainer as TTrainer

torch.set_num_threads(1)

B, DIM = 128, 8
COLS = CAT_NAMES[:6]
CAP = 1 << 10
ROW_ATOL = 1e-6    # rows and dense leaves through a save: f32, or init rows
LOSS_ATOL = 1e-4   # per-step loss of the two restored trainers
RTOL, ATOL = 2e-4, 2e-5  # served probabilities (test_torch_serving.py)
LAYOUTS = {
    "light": {},
    # bench.py --metadata
    "metadata": dict(counter_filter=("CounterFilter", 1),
                     evict=("GlobalStepEvict", 1 << 30)),
    # counting-bloom admission in the resolver: its counters are saved
    "cbf": dict(cbf_filter=("CBFFilter", 2)),
    # save-time eviction of rows untouched for 2 steps
    "evict2": dict(evict=("GlobalStepEvict", 2)),
}


def _kw(mod, layout):
    return {k: getattr(mod, cls)(arg)
            for k, (cls, arg) in LAYOUTS[layout].items()}


def _common():
    # one hash group: the JAX side's C++ resolver and its Python fallback
    # assign slots in the same order, whichever it got
    return dict(name="emb", capacity=CAP, max_unique=len(COLS) * B // 2,
                fused_slot_columns=DIM, fused_slot_init=0.1, n_groups=1)


def _jax_coll(layout):
    return JHost([jfc.EmbeddingColumn(jfc.CategoricalColumn(n), DIM)
                  for n in COLS],
                 initializer=dr.Initializer("normal", scale=0.05),
                 **_common(), **_kw(dr, layout))


def _port_coll(layout):
    return THost([tfc.EmbeddingColumn(tfc.CategoricalColumn(n), DIM)
                  for n in COLS],
                 initializer=tcfg.Initializer("normal", scale=0.05),
                 **_common(), **_kw(tcfg, layout))


def _jax_model():
    return jctr.DLRM(emb_names=COLS, emb_dim=DIM, bottom_units=(16,),
                     top_units=(16,))


def _port_model():
    return tctr.DLRM(COLS, DIM, bottom_units=(16,), top_units=(16,),
                     dense_dim=len(DENSE_NAMES))


def _jax_trainer(layout):
    return JTrainer(model=_jax_model(),
                    numeric_columns=[jfc.NumericColumn(n, log_normalize=True)
                                     for n in DENSE_NAMES],
                    collections={"emb": _jax_coll(layout)},
                    sparse_optimizers={"emb": jsopt.sparse_adagrad_fused(
                        0.05)},
                    dense_optimizer=optax.adagrad(0.05))


def _port_trainer(layout):
    return TTrainer(_port_model(),
                    [tfc.NumericColumn(n, log_normalize=True)
                     for n in DENSE_NAMES],
                    {"emb": _port_coll(layout)},
                    {"emb": tsopt.sparse_adagrad_fused(0.05)},
                    tdense.Adagrad(0.05), device="cpu")


def _carried(layout, batch):
    """A JAX and a port trainer with the same weights (the flax init)."""
    jt, tt = _jax_trainer(layout), _port_trainer(layout)
    js, ts = jt.init(jax.random.key(0), batch), tt.init(batch)
    tctr.load_flax_params(tt.model, [np.asarray(x) for x in
                                     jax.tree_util.tree_leaves(js.params)])
    ts = ts._replace(opt_state=tt.dense_optimizer.load_flax_state(
        tt.model, [np.asarray(x)
                   for x in jax.tree_util.tree_leaves(js.opt_state)]))
    return jt, tt, js, ts


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _table(coll, ev):
    """The live table by key: sorted keys and the rows' planes."""
    keys = coll._resolver.export_keys()
    order = np.argsort(keys)
    return keys[order], {f: _np(getattr(ev, f))[:keys.shape[0]][order]
                         for f in ("values", "freqs", "versions",
                                   "create_steps")}


def _assert_same_table(got, ref):
    (gk, g), (rk, r) = got, ref
    np.testing.assert_array_equal(gk, rk)  # key sets, bit-equal
    for f in ("freqs", "versions", "create_steps"):
        np.testing.assert_array_equal(g[f], r[f], f)
    np.testing.assert_allclose(g["values"], r["values"], rtol=0,
                               atol=ROW_ATOL)


def _dense(trainer, state):
    if isinstance(trainer, TTrainer):
        return tsaver._dense_leaves(trainer, state)
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(
        (state.params, state.opt_state, state.step))]


class _Bundle(NamedTuple):
    ev: object
    slot: tuple = ()


def _step(trainer, state, batch):
    """One train step; returns (state, wire bytes, mean loss)."""
    d, c, lab = trainer.prepare_batch(batch)
    jaxy = isinstance(trainer, JTrainer)
    before = float(state.metrics.loss_sum)
    state = (trainer._jit_train if jaxy else trainer._train_step)(
        state, d, c, lab)
    wire = _np(c["emb"].buf).tobytes()
    return state, wire, (float(state.metrics.loss_sum) - before) / B


@pytest.mark.parametrize("incr", [False, True], ids=["full", "full+incr"])
@pytest.mark.parametrize("layout", ["light", "metadata"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_save_restores_into_both_trainers(writer, layout, incr, tmp_path):
    batches = list(SyntheticCriteo(batch_size=B, seed=21).take(10))
    jt, tt, js, ts = _carried(layout, batches[0])
    wt, ws = (tt, ts) if writer == "port" else (jt, js)
    mgr = (tsaver.CheckpointManager if writer == "port"
           else jsaver.CheckpointManager)(str(tmp_path))
    for b in batches[:4]:
        ws, _, _ = _step(wt, ws, b)
    mgr.save(wt, ws)
    if incr:
        for b in batches[4:6]:
            ws, _, _ = _step(wt, ws, b)
        path = mgr.save_incremental(wt, ws)
        with open(os.path.join(path, "manifest.json")) as f:
            n_delta = json.load(f)["tables"]["emb"]
        # a true delta: fewer rows than the live table
        assert 0 < n_delta < wt.collections["emb"]._resolver.size
    live = _table(wt.collections["emb"], ws.tables["emb"].ev)

    jt2, tt2 = _jax_trainer(layout), _port_trainer(layout)
    js2, ok_j = jsaver.CheckpointManager(str(tmp_path)).restore(
        jt2, jt2.init(jax.random.key(1), batches[0]))
    ts2, ok_t = tsaver.CheckpointManager(str(tmp_path)).restore(
        tt2, tt2.init(batches[0]))
    assert ok_j and ok_t
    assert int(js2.step) == ts2.step == int(ws.step)
    _assert_same_table(_table(jt2.collections["emb"], js2.tables["emb"].ev),
                       live)
    _assert_same_table(_table(tt2.collections["emb"], ts2.tables["emb"].ev),
                       live)
    for restored in (_dense(jt2, js2), _dense(tt2, ts2)):
        assert len(restored) == len(_dense(wt, ws))
        for g, r in zip(restored, _dense(wt, ws)):
            np.testing.assert_allclose(g, r, rtol=0, atol=ROW_ATOL)

    # both restored trainers go on together
    for b in batches[6:]:
        js2, jw, jl = _step(jt2, js2, b)
        ts2, tw, tl = _step(tt2, ts2, b)
        assert jw == tw and abs(jl - tl) <= LOSS_ATOL


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_ckpt_arrays_match_jax(layout):
    """The collection hook that feeds a save, on one stream of lookups:
    a full save's arrays and an incremental's delta equal the JAX
    collection's (rows within 1e-6, the rest bit-equal)."""
    jc, tc = _jax_coll(layout), _port_coll(layout)
    js, ts = jc.init(), tc.init("cpu")
    jlookup = jax.jit(jc.lookup_or_create)
    saves = []
    for step, batch in enumerate(SyntheticCriteo(batch_size=B,
                                                 seed=5).take(7)):
        js, _ = jlookup(js, jc.pack_ids(batch), jnp.asarray(step, jnp.int32))
        ts, _ = tc.lookup_or_create(ts, tc.pack_ids(batch, "cpu"), step)
        if step == 3:
            saves.append((jc.ckpt_arrays(_Bundle(js), 1, None, True, 4),
                          tc.ckpt_arrays(_Bundle(ts), 1, None, True, 4)))
    saves.append((jc.ckpt_arrays(_Bundle(js), 1, 4, False, 7),
                  tc.ckpt_arrays(_Bundle(ts), 1, 4, False, 7)))
    for ref, got in saves:
        assert sorted(got) == sorted(ref)
        for k in ref:
            if k == "values":
                np.testing.assert_allclose(got[k], ref[k], rtol=0,
                                           atol=ROW_ATOL)
            else:
                np.testing.assert_array_equal(got[k], ref[k], k)
    full, delta = saves[0][1], saves[1][1]
    assert 0 < delta["keys"].shape[0]
    if layout == "evict2":  # rows untouched for 2 steps left the save
        assert full["keys"].shape[0] < tc._resolver.size
    if layout == "cbf":
        assert full["cbf"].any()


def test_port_trained_save_served_by_both_predictors(tmp_path):
    """A port-trained --metadata save served by the port's Predictor
    (given the training collection: it serves its device view and leaves
    the resolver alone) and by the JAX Predictor, before and after an
    incremental save and refresh."""
    batches = list(SyntheticCriteo(batch_size=B, seed=31).take(6))
    held = list(SyntheticCriteo(batch_size=B, seed=77).take(2))
    tt = _port_trainer("metadata")
    ts = tt.init(batches[0])
    for b in batches[:4]:
        ts = tt.train_step(ts, b)
    mgr = tsaver.CheckpointManager(str(tmp_path))
    mgr.save(tt, ts)
    coll = tt.collections["emb"]
    size = coll._resolver.size
    numeric_t = [tfc.NumericColumn(n, log_normalize=True)
                 for n in DENSE_NAMES]
    numeric_j = [jfc.NumericColumn(n, log_normalize=True)
                 for n in DENSE_NAMES]
    tp = TPredictor(_port_model(), numeric_t, {"emb": coll}, str(tmp_path),
                    device="cpu")
    jp = JPredictor(_jax_model(), numeric_j, {"emb": _jax_coll("metadata")},
                    str(tmp_path))

    def same():
        assert coll._resolver.size == size  # serving resolves nothing
        for b in held:
            np.testing.assert_allclose(tp.predict(b), np.asarray(
                jp.predict(b)), rtol=RTOL, atol=ATOL)
    same()
    before = tp.predict(held[0])
    for b in batches[4:]:
        ts = tt.train_step(ts, b)
    mgr.save_incremental(tt, ts)
    assert tp.refresh() and jp.refresh()
    assert tp.step == jp.step == 6
    size = coll._resolver.size
    assert not np.allclose(before, tp.predict(held[0]))
    same()
    assert tp.collections["emb"] is not coll
    assert not hasattr(tp.collections["emb"], "_resolver")


def test_dense_leaves_follow_the_jax_tree():
    """(params, opt_state, step) as the port writes them equal the JAX
    tree's leaves; the Adagrad accumulators go there and back."""
    b = next(SyntheticCriteo(batch_size=B, seed=2).take(1))
    jt, tt, js, ts = _carried("light", b)
    got, ref = _dense(tt, ts), _dense(jt, js)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
    opt = tt.dense_optimizer
    back = opt.load_flax_state(tt.model,
                               opt.flax_state_leaves(tt.model, ts.opt_state))
    for a, c in zip(back, ts.opt_state):
        assert torch.equal(a, c)


@pytest.mark.parametrize("case", ["same_shards", "fold", "blocks"])
def test_cbf_for_shard_matches_jax(case):
    rng = np.random.default_rng(6)
    full = rng.integers(0, 9, size=4096).astype(np.int32)
    arrays = {
        "same_shards": {"cbf": full, "cbf_shards": np.int32(1)},
        "fold": {"cbf": full, "cbf_shards": np.int32(4)},
        "blocks": {f"cbf__shard{s:03d}": full[s * 1024:(s + 1) * 1024]
                   for s in range(4)} | {"cbf_shards": np.int32(4)},
    }[case]
    np.testing.assert_array_equal(tsaver._cbf_for_shard(arrays, 0, 1),
                                  jsaver._cbf_for_shard(arrays, 0, 1))


def test_last_wins_and_capacity_match_jax():
    rng = np.random.default_rng(7)
    keys = rng.integers(0, 50, size=300).astype(np.int64)
    np.testing.assert_array_equal(tsaver.last_wins_sel(keys),
                                  jsaver.last_wins_sel(keys))
    assert tsaver.last_wins_sel(keys[:0]).shape == (0,)
    for n, cap, load in ((10, 16, 0.6), (1000, 16, 0.9), (15, 16, 0.9)):
        assert tsaver.needed_capacity(n, cap, load) == \
            jsaver.needed_capacity(n, cap, load)


def test_manager_keeps_saves_and_aux(tmp_path):
    """``maybe_save`` on its clocks, ``keep`` newest fulls (older
    incrementals go with them), the aux state saved and handed back."""
    batches = list(SyntheticCriteo(batch_size=B, seed=41).take(6))
    tt = _port_trainer("light")
    box = [tt.init(batches[0])]
    mgr = tsaver.CheckpointManager(str(tmp_path), full_secs=0.0, keep=2)
    mgr.attach_aux("pos", lambda: {"step": box[0].step}, None)
    for i, b in enumerate(batches[:5]):
        box[0] = tt.train_step(box[0], b)
        if i == 0:  # no save yet: an incremental is a full one
            assert mgr.save_incremental(tt, box[0]).endswith(
                "full-0000000001")
        elif i == 2:
            assert mgr.save_incremental(tt, box[0]).endswith(
                "incr-0000000003")
        else:
            assert mgr.maybe_save(tt, box[0]) is not None
    saves = [(m["kind"], m["step"]) for m in tformat.list_saves(
        str(tmp_path))]
    # full 1 and 2 went, and incr 3 with them
    assert saves == [("full", 4), ("full", 5)]
    lazy = tsaver.CheckpointManager(str(tmp_path), incr_secs=1e9)
    assert lazy.maybe_save(tt, box[0]) is None

    seen = []
    tt2 = _port_trainer("light")
    mgr2 = tsaver.CheckpointManager(str(tmp_path))
    mgr2.attach_aux("pos", lambda: {}, seen.append)
    ts2, ok = mgr2.restore(tt2, tt2.init(batches[0]))
    assert ok and ts2.step == 5 and seen == [{"step": 5}]
    assert not tsaver.CheckpointManager(str(tmp_path / "none")).restore(
        tt2, ts2)[1]


def test_tiered_save_restores(tmp_path):
    """A tiered table's save (its ``__tier__emb`` table beside ``emb``)
    restores into a fresh port trainer: the same device keys, the same
    tier keys and bit-exact tier rows."""
    batches = list(SyntheticCriteo(batch_size=B, seed=51).take(6))
    cfg = dict(_common(), storage=tcfg.StorageOption(
        tcfg.StorageType.HBM_DRAM), evict=tcfg.GlobalStepEvict(2))

    def trainer():
        return TTrainer(_port_model(), [tfc.NumericColumn(
            n, log_normalize=True) for n in DENSE_NAMES],
            {"emb": THost([tfc.EmbeddingColumn(tfc.CategoricalColumn(n), DIM)
                           for n in COLS], **cfg)},
            {"emb": tsopt.sparse_adagrad_fused(0.05)}, tdense.Adagrad(0.05),
            device="cpu")
    tt = trainer()
    ts = tt.init(batches[0])
    for b in batches:
        ts = tt.train_step(ts, b)
    ts = tt.maybe_demote(ts)
    path = tsaver.CheckpointManager(str(tmp_path)).save(tt, ts)
    assert os.path.exists(os.path.join(path, "table-__tier__emb.npz"))
    tt2 = trainer()
    ts2, ok = tsaver.CheckpointManager(str(tmp_path)).restore(
        tt2, tt2.init(batches[0]))
    c, c2 = tt.collections["emb"], tt2.collections["emb"]
    assert ok and c.host_tier_rows() == c2.host_tier_rows() > 0
    np.testing.assert_array_equal(np.sort(c2._resolver.export_keys()),
                                  np.sort(c._resolver.export_keys()))
    (k, r), (k2, r2) = c.tier_store.export(), c2.tier_store.export()
    o, o2 = np.argsort(k), np.argsort(k2)
    np.testing.assert_array_equal(k[o], k2[o2])
    np.testing.assert_array_equal(r[o].view(np.int32), r2[o2].view(np.int32))


def test_bfloat16_table_through_a_save(tmp_path):
    """A bfloat16 row store goes through ckpt_arrays, the file format and
    ckpt_restore bit-exact (npz has no bfloat16: raw bits travel)."""
    import types
    cfg = dict(_common(), value_dtype="bfloat16",
               **_kw(tcfg, "metadata"))
    cols = [tfc.EmbeddingColumn(tfc.CategoricalColumn(n), DIM)
            for n in COLS]
    init = tcfg.Initializer("normal", scale=0.05)
    tc, tc2 = THost(cols, initializer=init, **cfg), \
        THost(cols, initializer=init, **cfg)
    ts = tc.init("cpu")
    for step, b in enumerate(SyntheticCriteo(batch_size=B, seed=9).take(3)):
        ts, _ = tc.lookup_or_create(ts, tc.pack_ids(b, "cpu"), step)
    assert ts.values.dtype == torch.bfloat16
    arrays = tc.ckpt_arrays(_Bundle(ts), 1, None, False, 3)
    path = str(tmp_path / "full-0000000003")
    tformat.write_save(path, {"kind": "full", "step": 3, "tables": {}}, [],
                       {"emb": arrays})
    opt = tsopt.sparse_adagrad_fused()
    trainer = types.SimpleNamespace(collections={"emb": tc2},
                                    sparse_optimizers={"emb": opt},
                                    rejit=lambda: None)
    got = tc2.ckpt_restore(trainer, _Bundle(tc2.init("cpu")),
                           [tformat.read_table(path, "emb")], 1).ev
    n = tc._resolver.size
    assert tc2._resolver.size == n > 0
    assert torch.equal(got.values[:n].view(torch.int16),
                       ts.values[:n].view(torch.int16))
    for f in ("freqs", "versions", "create_steps"):
        assert torch.equal(getattr(got, f), getattr(ts, f)), f
