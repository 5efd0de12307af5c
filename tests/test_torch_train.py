"""Port parity: the port's Trainer and the JAX package's Trainer train the
same DLRM (weights carried from flax) on the same SyntheticCriteo stream,
on host-index tables in the light and the ``bench.py --metadata``
layouts, with ``sparse_adagrad_fused(0.05)`` and ``optax.adagrad(0.05)``
(the port: ``optim.dense.Adagrad(0.05)``)."""
import numpy as np
import pytest
import torch

import jax
import optax

import deeprec_tpu as dr
from deeprec_tpu import feature_column as jfc
from deeprec_tpu.data.criteo import CAT_NAMES, DENSE_NAMES, SyntheticCriteo
from deeprec_tpu.host_index import HostIndexEmbeddingCollection as JHost
from deeprec_tpu.models import ctr as jctr
from deeprec_tpu.optim import sparse as jsopt
from deeprec_tpu.train import metrics as jmetrics
from deeprec_tpu.train.trainer import Trainer as JTrainer

from deeprec_tpu_torch import config as tcfg
from deeprec_tpu_torch import feature_column as tfc
from deeprec_tpu_torch.host_index import HostIndexEmbeddingCollection as THost
from deeprec_tpu_torch.models import ctr as tctr
from deeprec_tpu_torch.optim import dense as tdense
from deeprec_tpu_torch.optim import sparse as tsopt
from deeprec_tpu_torch.train import metrics as tmetrics
from deeprec_tpu_torch.train.trainer import Trainer as TTrainer

torch.set_num_threads(1)

B, CAP, DIM, STEPS = 256, 1 << 14, 8, 50
COLS = CAT_NAMES[:10]
LOSS_ATOL = 1e-4   # per-step loss: f32 products and sums in another order
STATE_ATOL = 1e-4  # tables and parameters after 50 steps of such drift


def _meta(mod, metadata):
    if not metadata:
        return {}
    return dict(counter_filter=mod.CounterFilter(filter_freq=1),
                evict=mod.GlobalStepEvict(steps_to_live=1 << 30))


def _trainers(metadata):
    # one hash group: the JAX side's native resolver and its Python
    # fallback assign slots in the same order, whichever it got
    common = dict(name="emb", capacity=CAP, max_unique=len(COLS) * B // 6,
                  fused_slot_columns=DIM, fused_slot_init=0.1, n_groups=1)
    jcoll = JHost([jfc.EmbeddingColumn(jfc.CategoricalColumn(n), DIM)
                   for n in COLS],
                  initializer=dr.Initializer("normal", scale=0.05),
                  **common, **_meta(dr, metadata))
    tcoll = THost([tfc.EmbeddingColumn(tfc.CategoricalColumn(n), DIM)
                   for n in COLS],
                  initializer=tcfg.Initializer("normal", scale=0.05),
                  **common, **_meta(tcfg, metadata))
    jt = JTrainer(
        model=jctr.DLRM(emb_names=COLS, emb_dim=DIM, bottom_units=(32,),
                        top_units=(64, 32)),
        numeric_columns=[jfc.NumericColumn(n, log_normalize=True)
                         for n in DENSE_NAMES],
        collections={"emb": jcoll},
        sparse_optimizers={"emb": jsopt.sparse_adagrad_fused(0.05)},
        dense_optimizer=optax.adagrad(0.05))
    tt = TTrainer(
        tctr.DLRM(COLS, DIM, bottom_units=(32,), top_units=(64, 32),
                  dense_dim=len(DENSE_NAMES)),
        [tfc.NumericColumn(n, log_normalize=True) for n in DENSE_NAMES],
        {"emb": tcoll}, {"emb": tsopt.sparse_adagrad_fused(0.05)},
        tdense.Adagrad(0.05), device="cpu")
    return jt, tt


def _jkeys(k):
    return (np.asarray(k.hi).astype(np.int64) << 32) | \
        np.asarray(k.lo).astype(np.uint32).astype(np.int64)


@pytest.mark.parametrize("metadata", [False, True],
                         ids=["light", "metadata"])
def test_trainer_matches_jax(metadata):
    jt, tt = _trainers(metadata)
    batches = list(SyntheticCriteo(batch_size=B, seed=21).take(STEPS))
    js = jt.init(jax.random.key(0), batches[0])
    ts = tt.init(batches[0])
    tctr.load_flax_params(tt.model, [np.asarray(x) for x in
                                     jax.tree_util.tree_leaves(js.params)])
    ts = ts._replace(opt_state=tt.dense_optimizer.load_flax_state(
        tt.model, [np.asarray(x)
                   for x in jax.tree_util.tree_leaves(js.opt_state)]))

    for step, batch in enumerate(batches):
        jd, jc, jl = jt.prepare_batch(batch)
        td, tc, tl = tt.prepare_batch(batch)
        jr, tr = jc["emb"].decode(), tc["emb"].decode()
        # the resolver's output: bit-equal every step
        np.testing.assert_array_equal(tr.uslots.numpy(),
                                      np.asarray(jr.uslots))
        np.testing.assert_array_equal(tr.ukeys.numpy(), _jkeys(jr.ukeys))
        assert int(tr.n_unique) == int(jr.n_unique)
        jloss0 = float(js.metrics.loss_sum)
        tloss0 = float(ts.metrics.loss_sum)
        js = jt._jit_train(js, jd, jc, jl)
        ts = tt._train_step(ts, td, tc, tl)
        jloss = (float(js.metrics.loss_sum) - jloss0) / B
        tloss = (float(ts.metrics.loss_sum) - tloss0) / B
        assert abs(jloss - tloss) <= LOSS_ATOL, (step, jloss, tloss)
    assert ts.step == int(js.step) == STEPS

    jev, tev = js.tables["emb"].ev, ts.tables["emb"].ev
    for f in ("freqs", "versions", "create_steps"):  # bit-equal
        np.testing.assert_array_equal(getattr(tev, f).numpy(),
                                      np.asarray(getattr(jev, f)), f)
    if metadata:
        assert int(tev.versions.max()) == STEPS - 1
    np.testing.assert_allclose(tev.values.numpy(), np.asarray(jev.values),
                               rtol=0, atol=STATE_ATOL)
    for got, ref in zip(tctr.flax_leaves(tt.model),
                        jax.tree_util.tree_leaves(js.params)):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=0,
                                   atol=STATE_ATOL)
    jm, tm = jmetrics.summarize(js.metrics), tmetrics.summarize(ts.metrics)
    assert tm["examples"] == jm["examples"] == STEPS * B
    for k in ("auc", "accuracy", "loss"):
        assert abs(tm[k] - jm[k]) <= 1e-4, (k, tm, jm)

    # one eval step: read-only resolve, unseen keys read their init row
    held = next(SyntheticCriteo(batch_size=B, seed=99).take(1))
    size = tt.collections["emb"]._resolver.size
    jm = jmetrics.summarize(jt.eval_step(js, jmetrics.create(), held))
    tm = tmetrics.summarize(tt.eval_step(ts, tmetrics.create(device="cpu"),
                                         held))
    assert tt.collections["emb"]._resolver.size == size
    for k in ("auc", "accuracy", "loss"):
        assert abs(tm[k] - jm[k]) <= 1e-4, (k, tm, jm)


def test_dense_adagrad_matches_optax():
    rng = np.random.default_rng(2)
    params = [rng.normal(size=(5, 3)).astype(np.float32),
              rng.normal(size=(3,)).astype(np.float32)]
    opt = optax.adagrad(0.05)
    jp = [jax.numpy.asarray(p) for p in params]
    jstate = opt.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    tadam = tdense.Adagrad(0.05)
    tstate = tadam.init(tp)
    for _ in range(5):
        grads = [rng.normal(size=p.shape).astype(np.float32) for p in params]
        upd, jstate = opt.update([jax.numpy.asarray(g) for g in grads],
                                 jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for p, g in zip(tp, grads):
            p.grad = torch.from_numpy(g)
        tadam.step(tp, tstate)
    for a, b in zip(tp, jp):  # rsqrt and the update in f32, another order
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)
