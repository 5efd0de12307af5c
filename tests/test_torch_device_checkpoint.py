"""Port parity: checkpoints of device-index tables (``EmbeddingCollection``
through ``checkpoint.saver.table_snapshot_host`` and the saver's generic EV
restore) against the JAX package's.

Two layouts of the small DLRM of ``test_torch_device_train.py``:
``metadata`` (CBF admission, GlobalStepEvict(2) and fused Adagrad
columns: save-time eviction drops the rows untouched for 2 steps, the CBF
sketch is saved) and ``light`` (no filter, no eviction, plain sparse
Adagrad slot rows: the incremental save falls back to all live rows, with
the JAX package's warning). Both frameworks train in lockstep, save a full
and then an incremental checkpoint; every saved table is equal by key
(integer columns bit-equal, float ones within ROW_ATOL), the CBF too.
Each directory restores into fresh trainers of both frameworks: key
planes, metadata planes and CBF bit-equal, rows and slot rows within
ROW_ATOL, dense leaves equal. The port's Predictor serves the port's
saves as the JAX Predictor does, before and after a refresh onto the
incremental."""
import contextlib
import json
import os

import numpy as np
import pytest
import torch

import jax
import optax

import deeprec_tpu as dr
from deeprec_tpu import feature_column as jfc
from deeprec_tpu.checkpoint import saver as jsaver
from deeprec_tpu.data.criteo import DENSE_NAMES
from deeprec_tpu.models import ctr as jctr
from deeprec_tpu.optim import sparse as jsopt
from deeprec_tpu.serving import Predictor as JPredictor
from deeprec_tpu.train.trainer import Trainer as JTrainer

from deeprec_tpu_torch import config as tcfg
from deeprec_tpu_torch import feature_column as tfc
from deeprec_tpu_torch.checkpoint import format as tformat
from deeprec_tpu_torch.checkpoint import saver as tsaver
from deeprec_tpu_torch.models import ctr as tctr
from deeprec_tpu_torch.optim import dense as tdense
from deeprec_tpu_torch.optim import sparse as tsopt
from deeprec_tpu_torch.serving import Predictor as TPredictor
from deeprec_tpu_torch.train.trainer import Trainer as TTrainer

from test_torch_device_train import (B, COLS, DIM, _assert_same, _criteo,
                                     _lockstep)

torch.set_num_threads(1)

ROW_ATOL = 1e-4        # rows after the lockstep steps (f32 order drift)
RTOL, ATOL = 2e-4, 2e-5  # served probabilities (test_torch_serving.py)


def _coll(fcm, cfgm, layout):
    kw = dict(name="emb", capacity=1 << 12, max_unique=len(COLS) * B // 4,
              initializer=cfgm.Initializer("normal", scale=0.05))
    if layout == "metadata":
        kw.update(cbf_filter=cfgm.CBFFilter(filter_freq=2,
                                            max_element_size=2000),
                  evict=cfgm.GlobalStepEvict(steps_to_live=2),
                  fused_slot_columns=DIM, fused_slot_init=0.1)
    return fcm.EmbeddingCollection(
        [fcm.EmbeddingColumn(fcm.CategoricalColumn(n), DIM) for n in COLS],
        **kw)


def _models():
    return (jctr.DLRM(emb_names=COLS, emb_dim=DIM, bottom_units=(16,),
                      top_units=(32, 16)),
            tctr.DLRM(COLS, DIM, bottom_units=(16,), top_units=(32, 16),
                      dense_dim=len(DENSE_NAMES)))


def _pair(layout):
    jopt, topt = ((jsopt.sparse_adagrad_fused(0.05),
                   tsopt.sparse_adagrad_fused(0.05))
                  if layout == "metadata" else
                  (jsopt.sparse_adagrad(0.05), tsopt.sparse_adagrad(0.05)))
    jm, tm = _models()
    jt = JTrainer(model=jm,
                  numeric_columns=[jfc.NumericColumn(n, log_normalize=True)
                                   for n in DENSE_NAMES],
                  collections={"emb": _coll(jfc, dr, layout)},
                  sparse_optimizers={"emb": jopt},
                  dense_optimizer=optax.adagrad(0.05))
    tt = TTrainer(tm, [tfc.NumericColumn(n, log_normalize=True)
                       for n in DENSE_NAMES],
                  {"emb": _coll(tfc, tcfg, layout)}, {"emb": topt},
                  tdense.Adagrad(0.05), device="cpu")
    return jt, tt


def _by_key(table):
    order = np.argsort(table["keys"], kind="stable")
    n = len(order)
    return {k: (np.asarray(v)[order] if np.ndim(v) and len(v) == n
                and k != "cbf" else np.asarray(v))
            for k, v in table.items()}


def _assert_same_saves(ja, ta):
    """Each save of two directories: the same tables and columns, integer
    columns bit-equal by key, float ones within ROW_ATOL."""
    js, ts = tformat.list_saves(ja), tformat.list_saves(ta)
    assert [(m["kind"], m["step"]) for m in ts] == \
        [(m["kind"], m["step"]) for m in js]
    for jm, tm in zip(js, ts):
        with open(os.path.join(tm["path"], "manifest.json")) as f:
            tman = json.load(f)
        with open(os.path.join(jm["path"], "manifest.json")) as f:
            assert json.load(f)["tables"] == tman["tables"]
        ref = _by_key(tformat.read_table(jm["path"], "emb"))
        got = _by_key(tformat.read_table(tm["path"], "emb"))
        assert sorted(got) == sorted(ref)
        for col, r in ref.items():
            g = got[col]
            assert g.dtype == r.dtype and g.shape == r.shape, col
            if r.dtype.kind in "iu":
                np.testing.assert_array_equal(g, r, err_msg=col)
            else:
                np.testing.assert_allclose(g, r, rtol=0, atol=ROW_ATOL,
                                           err_msg=col)


def _train_and_save(layout, tmp_path):
    """Lockstep 3 steps, a full save each, 2 more, an incremental each."""
    jt, tt = _pair(layout)
    batches = _criteo(17, 5)
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    jmgr, tmgr = jsaver.CheckpointManager(jd), tsaver.CheckpointManager(td)

    def saves(js, ts):
        if ts.step == 3:
            jmgr.save(jt, js)
            tmgr.save(tt, ts)
        elif ts.step == 5:
            for mgr, tr, st in ((jmgr, jt, js), (tmgr, tt, ts)):
                with (pytest.warns(UserWarning, match="falls back")
                      if layout == "light" else contextlib.nullcontext()):
                    mgr.save_incremental(tr, st)
        return js, ts
    js, ts = _lockstep(jt, tt, batches, after_step=saves)
    return jt, tt, js, ts, jd, td


def _restored(layout, path):
    jt, tt = _pair(layout)
    b = _criteo(17, 1)[0]
    js, ok_j = jsaver.CheckpointManager(path).restore(
        jt, jt.init(jax.random.key(0), b))
    ts, ok_t = tsaver.CheckpointManager(path).restore(tt, tt.init(b))
    assert ok_j and ok_t
    return jt, js, tt, ts


@pytest.mark.parametrize("layout", ["metadata", "light"])
def test_device_saves_restore_both_ways(layout, tmp_path):
    jt, tt, js, ts, jd, td = _train_and_save(layout, tmp_path)
    _assert_same_saves(jd, td)
    base = tformat.read_table(tformat.list_saves(td)[0]["path"], "emb")
    live = int(ts.tables["emb"].ev.index.size)
    if layout == "metadata":
        assert "cbf" in base and int(base["cbf_shards"]) == 1
        # save-time eviction left out the rows untouched for 2 steps
        assert 0 < base["keys"].shape[0] < live
        assert (base["versions"] >= 3 - 2).all()
    else:  # plain Adagrad: its accumulator rows are saved
        assert any(k.startswith("slot__") for k in base)
    for path in (jd, td):
        rjt, rjs, rtt, rts = _restored(layout, path)
        assert rts.step == int(rjs.step) == 5
        _assert_same(rjt, rjs, rtt, rts)


def test_port_predictor_serves_a_device_index_save(tmp_path):
    jt, tt, js, ts, jd, td = _train_and_save("metadata", tmp_path)
    held = _criteo(77, 2)
    jm, tm = _models()
    numeric = [tfc.NumericColumn(n, log_normalize=True) for n in DENSE_NAMES]
    # the full save alone first; the incremental comes back for refresh()
    saves = tformat.list_saves(td)
    os.rename(saves[1]["path"], os.path.join(str(tmp_path), "later"))
    tp = TPredictor(tm, numeric, {"emb": _coll(tfc, tcfg, "metadata")}, td,
                    device="cpu")
    jp = JPredictor(jm, [jfc.NumericColumn(n, log_normalize=True)
                         for n in DENSE_NAMES],
                    {"emb": _coll(jfc, dr, "metadata")}, td)

    def same():
        for b in held:
            np.testing.assert_allclose(tp.predict(b),
                                       np.asarray(jp.predict(b)),
                                       rtol=RTOL, atol=ATOL)
    same()
    assert tp.step == 3
    os.rename(os.path.join(str(tmp_path), "later"), saves[1]["path"])
    assert tp.refresh() and jp.refresh()
    assert tp.step == jp.step == 5
    same()
