"""Port parity of the mesh engine: the port's ``ShardedTrainer`` on gloo
ranks (spawned processes, ``tests/torch_mesh_worker.py``) against the JAX
``ShardedTrainer`` on a mesh of the same size over the virtual CPU
devices, from the same numpy batches and the JAX init's weights.

- The step at S = 2 (DLRM, dim 8, fused Adagrad columns, four width-1
  columns and one multi-hot one, 5 steps; light and metadata layouts) and
  at S = 4 (width-1 columns only, so the column-parallel dedup): per shard
  the key planes, freqs, versions, create steps and health bit-equal,
  every step's loss within LOSS_ATOL, rows within ROW_ATOL.
- S = 1 against the port's one-device ``Trainer``.
- DIN at S = 2: its histories expanded from the exchanged rows, its Dice
  statistics averaged over the ranks.
- The bf16 wire, bucket drops at a tiny slack, the frequency semantics of
  the local trainer, ``microbatches=2`` and ``maybe_grow`` under load.
- The axis's ``all_to_all`` and ``multihost``'s host collectives at 3
  ranks.
"""
import numpy as np
import pytest
import torch

import jax
import optax

import deeprec_tpu as dr
from deeprec_tpu import feature_column as jfc
from deeprec_tpu import feature_column_variants as jfv
from deeprec_tpu.data.criteo import CAT_NAMES, DENSE_NAMES, SyntheticCriteo
from deeprec_tpu.host_index import HostIndexEmbeddingCollection as JHostIndex
from deeprec_tpu.models import ctr as jctr
from deeprec_tpu.models import sequence as jseq
from deeprec_tpu.optim import sparse as jsopt
from deeprec_tpu.parallel.host_sharded import HostShardedCollection as JHS
from deeprec_tpu.parallel.trainer import ShardedTrainer as JSharded
from deeprec_tpu.parallel.trainer import make_mesh as jmesh
from deeprec_tpu.sparse import dynamicdim as jdd
from deeprec_tpu.sparse import keys as jkeys
from deeprec_tpu.train.trainer import Trainer as JTrainer

import torch_mesh_worker as W

torch.set_num_threads(1)

B, DIM, STEPS = 64, 8, 5
LOSS_ATOL = 1e-5   # per-step loss: f32 sums in another order
ROW_ATOL = 2e-5    # rows and fused slot columns after the steps
WIDE = [(n, 1, "mean") for n in CAT_NAMES[:4]]
SPEC = dict(cols=WIDE + [("M1", 3, "mean")], dim=DIM, capacity=1 << 9,
            numeric=list(DENSE_NAMES[:4]), fused=True)
JAX_ENGINES = {"host": JHostIndex, "hs": JHS,  # spec["engine"] classes
               "multihash": jfv.MultiHashCollection,
               "adaptive": jfv.AdaptiveCollection,
               "hashtable": jfv.HashTableCollection,
               "dyndim": jfv.DynamicDimCollection,
               "dyndim_config": jdd.DynamicDimConfig}


def batches(seed, n, bs=B, vocab=60, multi_hot=True):
    """SyntheticCriteo batches (small vocabularies, so keys repeat across
    ranks), plus a 3-wide multi-hot column M1 with -1 padding."""
    gen = SyntheticCriteo(batch_size=bs, vocab_sizes=[vocab] * 26,
                          seed=seed, active_features=range(4))
    rng = np.random.default_rng(seed + 100)
    out = []
    for b in gen.take(n):
        if multi_hot:
            m = rng.integers(0, 40, (bs, 3)).astype(np.int64)
            m[rng.random((bs, 3)) < 0.3] = -1
            b["M1"] = m
        out.append(b)
    return out


def jax_trainer(spec, S=None):
    """The JAX twin of ``torch_mesh_worker.build(spec)``: a
    ``ShardedTrainer`` on the first ``S`` virtual devices, or a one-device
    ``Trainer``."""
    coll, model = W.parts(spec, (dr, jfc, jctr, jseq, JAX_ENGINES))
    opt = (jsopt.sparse_adagrad_fused(0.05) if spec.get("fused")
           else jsopt.sparse_adagrad(0.05))
    kw = dict(model=model,
              numeric_columns=[jfc.NumericColumn(n, log_normalize=True)
                               for n in spec["numeric"]],
              collections={"emb": coll}, sparse_optimizers={"emb": opt},
              dense_optimizer=optax.adagrad(0.05),
              microbatches=spec.get("microbatches", 1))
    if S is None:
        return JTrainer(**kw)
    return JSharded(mesh=jmesh(S), bucket_slack=spec.get("bucket_slack", 2.0),
                    **kw)


def jax_init(jt, batch):
    js = jt.init(jax.random.key(0), batch)
    dense = ([np.asarray(x) for x in jax.tree_util.tree_leaves(js.params)],
             [np.asarray(x) for x in jax.tree_util.tree_leaves(js.opt_state)])
    return js, dense


def jax_train(jt, js, bs, grow=False):
    losses, caps = [], []
    for b in bs:
        l0 = float(js.metrics.loss_sum)
        js = jt.train_step(js, b)
        losses.append((float(js.metrics.loss_sum) - l0) / len(b["label"]))
        if grow:
            js = jt.maybe_grow(js)
            caps.append(jt.collections["emb"].config.capacity)
    return js, losses, caps


def jax_shards(jt, js, S):
    """The JAX state of table emb split into its S shards."""
    e, b = js.tables["emb"].ev, js.tables["emb"]
    cap = jt.collections["emb"].config.capacity
    keys = jkeys.to_numpy(e.index.stored_keys).reshape(S, cap)
    out = []
    h = np.asarray(b.health).reshape(S, 3) if b.health is not None else None
    slots = [np.asarray(x) for x in jax.tree_util.tree_leaves(b.slot)]
    for s in range(S):
        d = {"keys": keys[s]}
        for f in ("values", "freqs", "versions", "create_steps"):
            a = np.asarray(getattr(e, f))
            d[f] = a.reshape((S, cap + 1) + a.shape[1:])[s]
        d["slot"] = [x.reshape((S, cap + 1) + x.shape[1:])[s] for x in slots]
        if h is not None:
            d["health"] = h[s]
        out.append(d)
    return out


def assert_shards_equal(got, want):
    """Per shard: key planes, freqs, versions, create steps and health
    bit-equal; rows and slot leaves within ROW_ATOL."""
    for s, (g, w) in enumerate(zip(got, want)):
        for f in ("keys", "freqs", "versions", "create_steps", "health"):
            np.testing.assert_array_equal(g[f], w[f], f"shard {s} {f}")
        np.testing.assert_allclose(g["values"], w["values"], rtol=0,
                                   atol=ROW_ATOL, err_msg=f"shard {s} rows")
        for gl, wl in zip(g["slot"], w["slot"]):
            np.testing.assert_allclose(gl, wl, rtol=0, atol=ROW_ATOL)


def lockstep(spec, S, tmp_path, bs, grow=False, eval_batch=None):
    """The JAX and the port's mesh trainers over ``bs``; per-step losses
    within LOSS_ATOL and every shard as :func:`assert_shards_equal` says.
    Returns the JAX trainer and state and the ranks' results."""
    jt = jax_trainer(spec, S)
    js, dense = jax_init(jt, bs[0])
    ranks = W.run_ranks("train", {"spec": spec, "batches": bs,
                                  "dense": dense, "grow": grow,
                                  "eval": eval_batch},
                        S, str(tmp_path / "ranks"))
    js, jlosses, jcaps = jax_train(jt, js, bs, grow)
    for r in ranks:
        np.testing.assert_allclose(r["losses"], jlosses, rtol=0,
                                   atol=LOSS_ATOL)
        assert r["caps"] == jcaps
        assert r["health"] == jt.table_health(js)
    assert_shards_equal([r["shard"] for r in ranks], jax_shards(jt, js, S))
    return jt, js, ranks


def test_collectives_over_three_ranks(tmp_path):
    """The axis's ``all_to_all`` (chunk j to rank j, bf16 bit-exact) and
    ``multihost``'s host collectives, at a rank count the engine tests do
    not use."""
    S = 3
    out = W.run_ranks("collectives", {}, S, str(tmp_path))
    for r, o in enumerate(out):
        assert o["rank"] == r and o["range"] == (r, r + 1)
        assert o["max"] == 7 * (S - 1) + 1
        np.testing.assert_array_equal(o["varlen"], np.concatenate(
            [np.full((j + 1, 2), j) for j in range(S)]))
        for j in range(S):  # chunk j of rank r came from rank j's chunk r
            np.testing.assert_array_equal(o["a2a"][j],
                                          np.arange(3) + 3 * r + 100 * j)
            np.testing.assert_array_equal(o["rows_back"][j],
                                          out[j]["rows"][r])
            np.testing.assert_array_equal(
                o["bf16_back"][j], torch.from_numpy(out[j]["rows"][r])
                .bfloat16().float().numpy())
        np.testing.assert_array_equal(o["psum"][0], np.full((2,), 3.0))
        np.testing.assert_array_equal(o["psum"][1], [3])
        np.testing.assert_array_equal(o["gather"], [0, 0, 1, -1, 2, -2])


@pytest.mark.parametrize("metadata", [False, True],
                         ids=["light", "metadata"])
def test_step_matches_jax_at_two_ranks(metadata, tmp_path):
    spec = dict(SPEC, max_unique=B * 6 // 2)
    if metadata:
        spec.update(filter_freq=2, evict_steps=1 << 20)
    jt, js, ranks = lockstep(spec, 2, tmp_path, batches(1, STEPS),
                             eval_batch=batches(9, 1)[0])
    h = ranks[0]["health"]["emb"]
    assert h["size"] > 0 and h["shards"] == 2
    # dense leaves (parameters, Adagrad state, step) agree on every rank
    ref = [np.asarray(x) for x in jax.tree_util.tree_leaves(
        (js.params, js.opt_state, js.step))]
    for r in ranks:
        for g, w in zip(r["dense"], ref):
            np.testing.assert_allclose(g, w, rtol=0, atol=ROW_ATOL)
    if metadata:
        assert max(int(r["shard"]["versions"].max()) for r in ranks) \
            == STEPS - 1
    # an eval step through the read-only exchange
    from deeprec_tpu.train import metrics as jm
    jeval = jm.summarize(jt.eval_step(js, jt.reset_metrics(js).metrics,
                                      batches(9, 1)[0]))
    for r in ranks:
        for k in ("auc", "accuracy", "loss"):
            assert abs(r["eval"][k] - jeval[k]) <= 1e-5, (k, r["eval"], jeval)


def test_step_matches_jax_at_four_ranks(tmp_path):
    """Width-1 columns with distinct groups: the column-parallel dedup."""
    spec = dict(SPEC, cols=WIDE, max_unique=B * 4 // 2)
    lockstep(spec, 4, tmp_path, batches(2, STEPS, multi_hot=False))


def test_one_rank_matches_the_one_device_trainer(tmp_path):
    """At S = 1 the exchange routes everything to this rank: the same key
    -> row map and per-step losses as the port's ``Trainer``."""
    spec = dict(SPEC, max_unique=B * 6 // 2)
    bs = batches(3, STEPS)
    _, dense = jax_init(jax_trainer(spec), bs[0])
    (r,) = W.run_ranks("train", {"spec": spec, "batches": bs,
                                 "dense": dense}, 1, str(tmp_path))
    tr = W.build(spec)
    st = W.carry(tr, tr.init(bs[0]), dense)
    losses = []
    for b in bs:
        st, loss = W.step_loss(st, b, lambda s: tr.train_step(s, b))
        losses.append(loss)
    np.testing.assert_allclose(r["losses"], losses, rtol=0, atol=1e-6)
    local = W.shard_np(st)

    def rows(d):
        live = d["keys"] != -1
        return dict(zip(d["keys"][live].tolist(),
                        d["values"][:-1][live].tolist()))
    got, want = rows(r["shard"]), rows(local)
    assert got.keys() == want.keys() and len(got) > 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6)


def test_bf16_wire_matches_jax(tmp_path):
    """``exchange_dtype="bfloat16"``: rows and their gradients cross the
    exchange in bf16 (one rounding each way) on both packages; the port
    tracks the JAX bf16 run and, as the JAX test holds, the f32 wire."""
    spec = dict(SPEC, cols=WIDE, exchange_dtype="bfloat16")
    bs = batches(4, STEPS, multi_hot=False)
    jt, js, ranks = lockstep(spec, 2, tmp_path, bs)
    j32 = jax_trainer(dict(spec, exchange_dtype=None), 2)
    s32, _ = jax_init(j32, bs[0])
    s32, l32, _ = jax_train(j32, s32, bs)
    for s, want in enumerate(jax_shards(j32, s32, 2)):
        np.testing.assert_allclose(ranks[s]["shard"]["values"],
                                   want["values"], rtol=0.1, atol=2e-2)
    for r in ranks:
        assert np.abs(np.asarray(r["losses"]) - l32).max() < 5e-2


def test_bucket_drops_counted_like_jax(tmp_path):
    """A tiny slack floors the buckets at 8 lanes: the ids that do not fit
    are dropped and counted in ``health``, equal to the JAX count."""
    spec = dict(SPEC, cols=WIDE, bucket_slack=1e-6)
    _, _, ranks = lockstep(spec, 2, tmp_path,
                           batches(5, 2, vocab=5000, multi_hot=False))
    assert ranks[0]["health"]["emb"]["dropped"] > 0


def test_freq_semantics_match_the_local_trainer(tmp_path):
    """CounterFilter admission does not change when a run adds ranks: the
    owner counts id occurrences (each requester's multiplicity rides the
    exchange), as the one-device trainer does (the JAX package's
    ``test_freq_semantics_identical_local_vs_sharded``)."""
    spec = dict(SPEC, cols=WIDE[:2], filter_freq=2)
    ids = np.asarray([5, 5, 5, 7, 7, 9], np.int64)
    b = batches(6, 1, bs=12, multi_hot=False)[0]
    for n, _, _ in WIDE[:2]:
        b[n] = np.resize(ids, 12)
    bs = [b] * 3
    ranks = W.run_ranks("train", {"spec": spec, "batches": bs}, 2,
                        str(tmp_path))
    tr = W.build(spec)
    st = tr.init(b)
    for x in bs:
        st = tr.train_step(st, x)

    def freq_by_key(d):
        live = d["keys"] != -1
        return dict(zip(d["keys"][live].tolist(),
                        d["freqs"][:-1][live].tolist()))
    sharded = {}
    for r in ranks:
        sharded.update(freq_by_key(r["shard"]))
    local = freq_by_key(W.shard_np(st))
    assert sharded == local
    assert set(local.values()) == {18, 12, 6}


def test_microbatches_match_jax(tmp_path):
    spec = dict(SPEC, max_unique=B * 6 // 2, microbatches=2)
    lockstep(spec, 2, tmp_path, batches(7, 3))


def test_maybe_grow_under_load_matches_jax(tmp_path):
    """Growth is one decision for all ranks: every shard doubles at the
    same step, to the capacity the JAX mesh trainer reaches."""
    spec = dict(SPEC, cols=WIDE, capacity=64)
    _, _, ranks = lockstep(spec, 2, tmp_path,
                           batches(8, 4, vocab=5000, multi_hot=False),
                           grow=True)
    assert ranks[0]["caps"][-1] > 64


def test_din_matches_jax_at_two_ranks(tmp_path):
    """DIN's two histories expanded from the exchanged rows (K2's one-id
    bags) and its Dice running statistics averaged over the ranks
    (``pmean``): tables, parameters and statistics as the JAX mesh
    trainer's."""
    from deeprec_tpu.data.behavior import SyntheticBehavior
    spec = dict(model="din", dim=DIM, hist=8, capacity=1 << 10,
                numeric=[], max_unique=B * 19 // 2)
    bs = list(SyntheticBehavior(batch_size=B, max_len=8, seed=5,
                                n_items=300, n_users=40).take(3))
    jt, js, ranks = lockstep(spec, 2, tmp_path, bs)
    ref = [np.asarray(x) for x in jax.tree_util.tree_leaves(
        (js.params, js.opt_state, js.step))]
    assert np.abs(ref[0]).sum() > 0  # the statistics moved
    for r in ranks:
        for g, w in zip(r["dense"], ref):
            np.testing.assert_allclose(g, w, rtol=0, atol=ROW_ATOL)
