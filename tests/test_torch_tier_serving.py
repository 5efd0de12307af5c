"""Port parity for serving a tiered save: the port's ``TieredPredictor``
(hot rows on the device under ``device_row_budget``, the cold tail in a
host ``HostKV``), the JAX ``TieredPredictor`` and the port's
``Predictor`` (every row on the device, the ``__tier__`` rows included)
serve one port-trained tiered save alike (rtol 2e-4, atol 2e-5, as in
``test_torch_serving.py``): on held-out batches, on keys never trained
(their default rows), and after an incremental save and ``refresh()``."""
import numpy as np
import pytest

from deeprec_tpu import feature_column as jfc
from deeprec_tpu.models import ctr as jctr
from deeprec_tpu.serving import TieredPredictor as JTiered

from deeprec_tpu_torch import feature_column as tfc
from deeprec_tpu_torch.checkpoint import saver as tsaver
from deeprec_tpu_torch.models import ctr as tctr
from deeprec_tpu_torch.serving import Predictor, TieredPredictor

from test_torch_tier_trainer import CATS, DIM, colls, port_trainer, stream

RTOL, ATOL = 2e-4, 2e-5


def _train(ckpt, steps=12):
    """A tiered port trainer over a stream, demoting every 4 steps; a full
    save at the end."""
    tt = port_trainer(steps_to_live=4)
    batches = stream(steps + 6, seed=3, vocab=200)
    ts = tt.init(batches[0])
    for i, b in enumerate(batches[:steps]):
        ts = tt.train_step(ts, b)
        if i % 4 == 3:
            ts = tt.maybe_demote(ts)
    tsaver.CheckpointManager(ckpt).save(tt, ts, evict=False)
    assert tt.host_tier_rows("emb") > 0
    return tt, ts, batches[steps:]


def _predictors(ckpt, tt, budget):
    jc, tc = colls(steps_to_live=4)
    numeric_t = [tfc.NumericColumn("I1")]
    full = Predictor(tctr.DLRM(CATS, DIM, (16,), (16,), dense_dim=1),
                     numeric_t, {"emb": tt.collections["emb"]}, ckpt,
                     device="cpu")
    tiered = TieredPredictor(tctr.DLRM(CATS, DIM, (16,), (16,), dense_dim=1),
                             numeric_t, {"emb": tc}, ckpt,
                             device_row_budget=budget, device="cpu")
    jtiered = JTiered(jctr.DLRM(emb_names=CATS, emb_dim=DIM,
                                bottom_units=(16,), top_units=(16,)),
                      [jfc.NumericColumn("I1")], {"emb": jc}, ckpt,
                      device_row_budget=budget)
    return full, tiered, jtiered


def _same(preds, batches):
    for b in batches:
        ref = preds[0].predict(b)
        assert ref.shape == (len(b["label"]),) and np.isfinite(ref).all()
        for p in preds[1:]:
            np.testing.assert_allclose(np.asarray(p.predict(b)), ref,
                                       rtol=RTOL, atol=ATOL)


@pytest.fixture
def trained(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    return (ckpt,) + _train(ckpt)


def test_tiered_predictor_matches_jax_and_full(trained):
    ckpt, tt, ts, held = trained
    full, tiered, jtiered = _predictors(ckpt, tt, budget=1 << 20)
    n_rows = len(tiered._device_keys["emb"])
    assert tiered.host_rows("emb") == 0  # the budget holds every row
    budget = max(n_rows // 4, 1)
    full, tiered, jtiered = _predictors(ckpt, tt, budget)
    assert len(tiered._device_keys["emb"]) == budget
    assert tiered.host_rows("emb") == jtiered.host_rows("emb") == \
        n_rows - budget
    # the requests read rows from the host store
    cold = tiered.host_store["emb"].export()[0]
    assert np.isin(tiered.collections["emb"].pack_ids_np(held[0]), cold).any()
    _same((full, tiered, jtiered), held[:3])


def test_tiered_unknown_keys_read_default(trained):
    ckpt, tt, ts, held = trained
    preds = _predictors(ckpt, tt, budget=64)
    b = dict(held[0])
    b["C1"] = b["C1"] + 10_000_000   # never trained: default rows
    _same(preds, [b])


def test_tiered_incremental_refresh(trained):
    """Training goes on (rows promoted, new keys, another demotion) and an
    incremental save lands: every predictor refreshes onto it."""
    ckpt, tt, ts, held = trained
    preds = _predictors(ckpt, tt, budget=128)
    before = preds[1].predict(held[0])
    for i, b in enumerate(held[3:]):
        ts = tt.train_step(ts, b)
    ts = tt.maybe_demote(ts)
    tsaver.CheckpointManager(ckpt).save_incremental(tt, ts)
    assert all(p.refresh() for p in preds)
    assert preds[1].step == int(ts.step)
    assert not np.allclose(before, preds[1].predict(held[0]))
    _same(preds, held[:3])
