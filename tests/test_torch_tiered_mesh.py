"""Port parity of ``TieredShardedTrainer``: the port's trainer on gloo
ranks (``tests/torch_mesh_worker.py``, one host tier per rank) against the
JAX ``TieredShardedTrainer`` on a virtual CPU mesh of the same size, from
the same batches and the JAX init's weights (DCN over two columns at dim
8, as the JAX tests).

After every operation (a step, a demotion, a promotion alone) the ranks'
device rows together and their tiers together hold the keys the JAX
trainer's table and tier hold: the key sets equal, rows and payload rows
within ROW_ATOL (the payload's bit-cast metadata and slot rows included).

- Budget pressure (``hbm_capacity`` 8 over the mesh, no eviction policy):
  every shard demotes past its share, the rows come back intact.
- An eviction policy: the cold keys leave every shard and come back
  intact through their promotion and a step.
- A tiered 2-rank save restores into the JAX trainer at 4 shards and
  into the port's one-device ``TieredTrainer``: the tier rows re-route by
  owner and arrive intact, each key in one tier (the JAX package's
  ``tests/test_tier_checkpoint.py`` resharded tier restore).
"""
import jax
import numpy as np
import optax
import torch

import deeprec_tpu as dr
from deeprec_tpu import feature_column as jfc
from deeprec_tpu.checkpoint import CheckpointManager as JCkpt
from deeprec_tpu.models import ctr as jctr
from deeprec_tpu.models import sequence as jseq
from deeprec_tpu.optim import sparse as jsopt
from deeprec_tpu.parallel.tiered import TieredShardedTrainer as JTiered
from deeprec_tpu.parallel.trainer import make_mesh as jmesh

import torch_mesh_worker as W
from test_torch_mesh import JAX_ENGINES, jax_init

torch.set_num_threads(1)

ROW_ATOL = 2e-5  # rows and payload rows after a few steps


def spec_of(**kw):
    return dict(dict(model="dcn", dim=8, capacity=256, tiered=True,
                     cols=[("C1", 1, "sum"), ("C2", 1, "sum")],
                     numeric=["I1"]), **kw)


def batch_with(ids, bs=16):
    rng = np.random.default_rng(0)
    b = {"label": rng.integers(0, 2, bs).astype(np.float32),
         "I1": rng.normal(size=bs).astype(np.float32)}
    for n in ("C1", "C2"):
        b[n] = np.resize(np.asarray(ids, np.int64), bs)
    return b


def jax_tiered(spec, S):
    coll, model = W.parts(spec, (dr, jfc, jctr, jseq, JAX_ENGINES))
    return JTiered(model=model,
                   numeric_columns=[jfc.NumericColumn(n, log_normalize=True)
                                    for n in spec["numeric"]],
                   collections={"emb": coll},
                   sparse_optimizers={"emb": jsopt.sparse_adagrad(0.05)},
                   dense_optimizer=optax.adagrad(0.05), mesh=jmesh(S))


def jax_view(jt, js):
    coll = jt.collections["emb"]
    a = coll.ckpt_arrays(js.tables["emb"], jt.S, None, False, int(js.step))
    dev = dict(zip(a["keys"].tolist(), np.asarray(a["values"])))
    kv = jt.tiers["emb"]
    tier = {}
    if kv is not None and len(kv):
        k, rows = kv.export()
        tier = dict(zip(k.tolist(), rows))
    return dev, tier


def union(views):
    dev, tier = {}, {}
    for d, t in views:
        assert not dev.keys() & d.keys() and not tier.keys() & t.keys()
        dev.update(d)
        tier.update(t)
    return dev, tier


def assert_views(got, want, what):
    for g, w, part in zip(got, want, ("device", "tier")):
        assert g.keys() == w.keys(), (what, part)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=ROW_ATOL,
                                       err_msg=f"{what} {part} {k}")


def run(spec, S, bs, ops, tmp_path, ckpt=None):
    jt = jax_tiered(spec, S)
    js, dense = jax_init(jt, bs[0])
    ranks = W.run_ranks("tiered", dict(spec=spec, batches=bs, ops=ops,
                                       dense=dense, ckpt=ckpt),
                        S, str(tmp_path / "ranks"))
    views = []
    for i, op in enumerate(ops):
        if op[0] == "train":
            js = jt.train_step(js, bs[op[1]])
        elif op[0] == "demote":
            js = jt.maybe_demote(js)
        elif op[0] == "promote":
            js = jt._promote_for_batch(js, bs[op[1]])
        want = jax_view(jt, js)
        got = union([r[i] for r in ranks])
        assert_views(got, want, op)
        views.append(got)
    return views


def test_budget_pressure_demotes_and_promotes_like_jax(tmp_path):
    ids1, ids2 = [1, 2, 3, 4], [5, 6, 7, 8]
    bs = [batch_with(ids1), batch_with(ids2), batch_with(ids1 + ids2)]
    views = run(spec_of(hbm_capacity=8), 2, bs,
                [("train", 0), ("train", 1), ("demote",), ("promote", 2),
                 ("train", 2)], tmp_path)
    dev, tier = views[2]
    assert len(tier) > 0 and len(dev) <= 8
    assert not views[3][1]  # every demoted key came back


def test_evicted_rows_return_intact_like_jax(tmp_path):
    cold, hot = [11, 12, 13], [77, 78, 79]
    bs = [batch_with(cold), batch_with(hot)]
    views = run(spec_of(evict_steps=3), 2, bs,
                [("train", 0)] * 2 + [("train", 1)] * 4
                + [("demote",), ("promote", 0), ("train", 0)], tmp_path)
    dev, tier = views[6]
    assert tier and not dev.keys() & tier.keys()
    assert not views[7][1]


def test_tiered_save_restores_resharded(tmp_path):
    """A 2-rank save with a tier: the JAX trainer at 4 shards and the
    port's one-device ``TieredTrainer`` restore its device and tier rows
    intact, each key in one tier."""
    cold, hot = list(range(1, 17)), list(range(100, 116))
    bs = [batch_with(cold, 32), batch_with(hot, 32)]
    spec = spec_of(evict_steps=3)
    ckpt = str(tmp_path / "ckpt")
    views = run(spec, 2, bs, [("train", 0)] * 2 + [("train", 1)] * 4
                + [("demote",), ("save",)], tmp_path, ckpt=ckpt)
    dev0, tier0 = views[-1]
    assert len(tier0) >= 16
    j4 = jax_tiered(spec, 4)
    s4 = j4.init(jax.random.key(1), bs[1])
    s4, ok = JCkpt(ckpt).restore(j4, s4)
    assert ok
    assert_views(jax_view(j4, s4), (dev0, tier0), "jax at 4")
    tr = W.build(spec)
    from deeprec_tpu_torch.checkpoint import CheckpointManager
    st, ok = CheckpointManager(ckpt).restore(tr, tr.init(bs[1]))
    assert ok
    assert_views(W.tier_view(tr, st), (dev0, tier0), "port at 1")
