"""Port parity of the host-sharded engine: the port's ``ShardedTrainer``
over ``HostShardedCollection`` on gloo ranks (spawned processes,
``tests/torch_mesh_worker.py``; the buckets cross the host exchange)
against the JAX ``ShardedTrainer`` over its ``HostShardedCollection`` on
a virtual CPU mesh of the same size, from the same numpy batches and the
JAX init's weights.

- The step at S = 2 (light and metadata layouts, with an eval step) and
  S = 4: per shard the resolver's keys in slot order, freqs, versions,
  create steps and the device health bit-equal, the health dict equal,
  every step's loss within LOSS_ATOL, rows and slot leaves within
  ROW_ATOL.
- S = 1 against the port's one-device host-index ``Trainer``: the same
  key -> row map.
- Growth under load, as the JAX engine grows.
- Saves both ways at other shard counts and across engines: a 2-rank save
  into the port at 4 and 1 ranks and into the JAX device-index engine at
  4 shards; a JAX 4-shard save into the port at 2 ranks.
- The refusals: a mesh-size change, and shard ranges that are not one
  shard per rank in rank order.
- The host exchange alone: frames, late steps counted against the soft
  deadline, and the address a rank advertises taken from the rendezvous
  ``initialize`` joined, with no environment variable set.
"""
import os
import socket

import jax
import numpy as np
import pytest
import torch

from deeprec_tpu.checkpoint.saver import CheckpointManager as JCkpt
from deeprec_tpu.checkpoint.saver import table_snapshot_host

import torch_mesh_worker as W
from test_torch_mesh import (B, DENSE_NAMES, LOSS_ATOL, ROW_ATOL, STEPS,
                             WIDE, batches, jax_init, jax_train,
                             jax_trainer)

torch.set_num_threads(1)

HS = dict(cols=WIDE + [("M1", 3, "mean")], dim=8, capacity=1 << 9,
          numeric=list(DENSE_NAMES[:4]), fused=True, engine="hs")


def jax_host_shards(jt, js, S):
    """The JAX host-sharded table split into its S shards, as
    ``torch_mesh_worker.host_shard_np`` gives a rank's."""
    coll = jt.collections["emb"]
    cap1 = coll.config.capacity + 1
    b = js.tables["emb"]
    e = b.ev
    health = np.asarray(b.health).reshape(S, 3)
    slots = [np.asarray(x) for x in jax.tree_util.tree_leaves(b.slot)]
    out = []
    for s in range(S):
        r = coll._shard_resolvers[s]
        n = r.size
        d = {"keys": r.export_keys(), "size": n, "health": health[s]}
        for f in ("values", "freqs", "versions", "create_steps"):
            a = np.asarray(getattr(e, f))
            d[f] = a.reshape((S, cap1) + a.shape[1:])[s][:n]
        d["slot"] = [x.reshape((S, cap1) + x.shape[1:])[s][:n]
                     if x.ndim and x.shape[0] == S * cap1 else x
                     for x in slots]
        out.append(d)
    return out


def assert_host_shards(got, want):
    for s, (g, w) in enumerate(zip(got, want)):
        assert g["size"] == w["size"], s
        for f in ("keys", "freqs", "versions", "create_steps", "health"):
            np.testing.assert_array_equal(g[f], w[f], f"shard {s} {f}")
        np.testing.assert_allclose(g["values"], w["values"], rtol=0,
                                   atol=ROW_ATOL, err_msg=f"shard {s} rows")
        for gl, wl in zip(g["slot"], w["slot"]):
            np.testing.assert_allclose(gl, wl, rtol=0, atol=ROW_ATOL)


def without_late(h):
    """The port's health dict without ``exchange_late_steps``, which the
    one-controller JAX engine does not report."""
    h = dict(h)
    late = h.pop("exchange_late_steps", 0)
    assert isinstance(late, int) and late >= 0
    return h


def lockstep(spec, S, tmp_path, bs, grow=False, eval_batch=None):
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
        assert without_late(r["health"]["emb"]) == jt.table_health(js)["emb"]
    assert_host_shards([r["shard"] for r in ranks], jax_host_shards(jt, js, S))
    return jt, js, ranks


@pytest.mark.parametrize("metadata", [False, True],
                         ids=["light", "metadata"])
def test_step_matches_jax_at_two_ranks(metadata, tmp_path):
    spec = dict(HS, max_unique=B * 6 // 2)
    if metadata:
        spec.update(filter_freq=2, evict_steps=1 << 20)
    jt, js, ranks = lockstep(spec, 2, tmp_path, batches(11, STEPS),
                             eval_batch=batches(19, 1)[0])
    h = ranks[0]["health"]["emb"]
    assert h["size"] > 0 and h["shards"] == 2
    if metadata:
        assert max(int(r["shard"]["versions"].max()) for r in ranks) \
            == STEPS - 1
    from deeprec_tpu.train import metrics as jm
    jeval = jm.summarize(jt.eval_step(js, jt.reset_metrics(js).metrics,
                                      batches(19, 1)[0]))
    for r in ranks:
        for k in ("auc", "accuracy", "loss"):
            assert abs(r["eval"][k] - jeval[k]) <= 1e-5, (k, r["eval"], jeval)


def test_step_matches_jax_at_four_ranks(tmp_path):
    spec = dict(HS, cols=WIDE, max_unique=B * 4 // 2)
    lockstep(spec, 4, tmp_path, batches(12, STEPS, multi_hot=False))


def test_bucket_drops_counted_like_jax(tmp_path):
    """A tiny slack floors the buckets at 8 lanes: the keys that do not
    fit are dropped and counted, globally, as the JAX engine counts."""
    spec = dict(HS, cols=WIDE, bucket_slack=1e-6)
    _, _, ranks = lockstep(spec, 2, tmp_path,
                           batches(13, 2, vocab=5000, multi_hot=False))
    assert ranks[0]["health"]["emb"]["dropped"] > 0


def test_growth_matches_jax(tmp_path):
    spec = dict(HS, cols=WIDE, capacity=64)
    _, _, ranks = lockstep(spec, 2, tmp_path,
                           batches(14, 4, vocab=5000, multi_hot=False),
                           grow=True)
    assert ranks[0]["caps"][-1] > 64


def test_one_rank_matches_the_one_device_host_trainer(tmp_path):
    """At S = 1 every key is this rank's: the same key -> row map and
    losses as the port's one-device host-index ``Trainer``."""
    spec = dict(HS, max_unique=B * 6 // 2)
    bs = batches(15, STEPS)
    _, dense = jax_init(jax_trainer(spec, 1), bs[0])
    (r,) = W.run_ranks("train", {"spec": spec, "batches": bs,
                                 "dense": dense}, 1, str(tmp_path))
    local = dict(spec, engine="host")
    tr = W.build(local)
    W._COLLS.update(tr.collections)
    st = W.carry(tr, tr.init(bs[0]), dense)
    losses = []
    for b in bs:
        st, loss = W.step_loss(st, b, lambda s: tr.train_step(s, b))
        losses.append(loss)
    np.testing.assert_allclose(r["losses"], losses, rtol=0, atol=1e-6)
    one = W.shard_np(st)

    def rows(d):
        return dict(zip(d["keys"].tolist(), d["values"].tolist()))
    got, want = rows(r["shard"]), rows(one)
    assert got.keys() == want.keys() and len(got) > 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6)


def _table(path, name="emb"):
    from deeprec_tpu.checkpoint import format as F
    base, incrs = F.restore_plan(path)
    parts = [F.read_table(m["path"], name) for m in [base] + incrs]
    keys = np.concatenate([p["keys"] for p in parts])
    from deeprec_tpu.checkpoint.saver import last_wins_sel
    sel = last_wins_sel(keys)
    return {k: np.concatenate([np.asarray(p[k]) for p in parts])[sel]
            for k in ("keys", "values", "freqs", "versions")}


def _by_key(d):
    return {int(k): (np.asarray(v), int(f), int(ver)) for k, v, f, ver in
            zip(d["keys"], d["values"], d["freqs"], d["versions"])}


def test_two_rank_save_restores_everywhere(tmp_path):
    """A 2-rank host-sharded save (a full save, then an incremental) is
    read by the JAX device-index engine at 4 shards, by the port's
    host-sharded engine at 4 ranks and at 1 (the cross-engine contract of
    the JAX multi-process test)."""
    spec = dict(HS, cols=WIDE, filter_freq=2, evict_steps=1 << 20)
    bs = batches(16, 6, multi_hot=False)
    ckpt = str(tmp_path / "ckpt")
    W.run_ranks("train", {"spec": spec, "batches": bs, "ckpt": ckpt,
                          "saves": {3: "full", 5: "incr"}}, 2,
                str(tmp_path / "r2"))
    saved = _by_key(_table(ckpt))
    assert len(saved) > 0
    # the JAX device-index mesh engine at 4 shards
    jt = jax_trainer(dict(spec, engine="device"), 4)
    js = jt.init(jax.random.key(0), bs[0])
    js, ok = JCkpt(ckpt).restore(jt, js)
    assert ok and int(js.step) == 6
    a = table_snapshot_host(jt.collections["emb"].config,
                            js.tables["emb"].ev, js.tables["emb"].slot,
                            num_shards=4, evict=False)
    got = _by_key(a)
    assert got.keys() == saved.keys()
    for k, (v, f, ver) in saved.items():
        np.testing.assert_array_equal(got[k][0], v)
        assert got[k][1:] == (f, ver)
    # the port at 4 and at 1 rank
    for S in (4, 1):
        ranks = W.run_ranks("restore", {"spec": spec, "batches": bs,
                                        "ckpt": ckpt}, S,
                            str(tmp_path / f"back{S}"))
        got = {}
        for r in ranks:
            assert r["step"] == 6
            d = r["shard"]
            for k, v, f, ver in zip(d["keys"], d["values"], d["freqs"],
                                    d["versions"]):
                assert int(k) not in got  # one owner per key
                got[int(k)] = (v, int(f), int(ver))
        assert got.keys() == saved.keys(), S
        for k, (v, f, ver) in saved.items():
            np.testing.assert_array_equal(got[k][0], v)
            assert got[k][1:] == (f, ver)


def test_jax_four_shard_save_restores_at_two_ranks(tmp_path):
    """A JAX host-sharded save at 4 shards restores into the port's
    host-sharded engine at 2 ranks: every key once, its row and
    metadata bit-equal."""
    spec = dict(HS, cols=WIDE, filter_freq=2, evict_steps=1 << 20)
    bs = batches(17, 4, multi_hot=False)
    jt = jax_trainer(spec, 4)
    js = jt.init(jax.random.key(0), bs[0])
    for b in bs:
        js = jt.train_step(js, b)
    ckpt = str(tmp_path / "ckpt")
    JCkpt(ckpt).save(jt, js, evict=False)
    saved = _by_key(_table(ckpt))
    ranks = W.run_ranks("restore", {"spec": spec, "batches": bs,
                                    "ckpt": ckpt}, 2, str(tmp_path / "r"))
    got = {}
    for r in ranks:
        d = r["shard"]
        got.update({int(k): (v, int(f), int(ver)) for k, v, f, ver in
                    zip(d["keys"], d["values"], d["freqs"], d["versions"])})
    assert got.keys() == saved.keys() and len(got) > 0
    for k, (v, f, ver) in saved.items():
        np.testing.assert_array_equal(got[k][0], v)
        assert got[k][1:] == (f, ver)


def test_mesh_size_change_refused():
    """The engine forms once: binding it to a mesh of another size
    raises (the JAX ``_ensure_shards`` refusal)."""
    from deeprec_tpu_torch.parallel.host_sharded import HostShardedCollection
    import deeprec_tpu_torch.feature_column as fc

    class OneRank:
        size, rank = 1, 0
    coll = HostShardedCollection(
        [fc.EmbeddingColumn(fc.CategoricalColumn("a"), 4)], capacity=64)
    coll.bind_mesh(OneRank())
    OneRank.size = 2
    with pytest.raises(ValueError, match="mesh size changed 1 -> 2"):
        coll.bind_mesh(OneRank())


def test_misordered_shard_ranges_raise(tmp_path):
    """Peer blocks are indexed by the ranges every rank reports, checked
    when the mesh forms: ranks that report each other's shard make every
    rank raise before a step (the JAX engine assumed rank q owned shard
    q and never looked)."""
    out = W.run_ranks("ranges", {"swap": True}, 2, str(tmp_path / "bad"))
    for r in out:
        assert "shard ranges [(1, 2), (0, 1)]" in r["error"]
    ok = W.run_ranks("ranges", {"swap": False}, 2, str(tmp_path / "good"))
    assert [r["ranges"] for r in ok] == [[(0, 1), (1, 2)]] * 2


def test_exchange_frames_deadline_and_address(tmp_path):
    """Three ranks swap frames through the host exchange: each gets every
    peer's blob, a step slower than the soft deadline counts as late, and
    the address each rank advertises comes from the ``tcp://``
    rendezvous given to ``initialize`` (no ``MASTER_ADDR`` or
    ``COORDINATOR_ADDRESS`` in the environment)."""
    try:  # this host's own address where it has one, else loopback
        host = socket.gethostbyname(socket.gethostname())
        with socket.socket() as s:
            s.bind((host, 0))
            port = s.getsockname()[1]
    except OSError:
        host = "127.0.0.1"
        port = W.free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "COORDINATOR_ADDRESS")}
    out = W.run_ranks("exchange", {"delay_rank": 2}, 3, str(tmp_path),
                      addr=f"tcp://{host}:{port}", env=env)
    for r, o in enumerate(out):
        assert o["advertised"].rsplit(":", 1)[0] == \
            ("127.0.0.1" if host.startswith("127.") else host)
        for q in range(3):
            if q != r:
                assert o["got"][q] == [f"{q}->{r} step {i}".encode()
                                       for i in range(3)]
        assert o["late"] == (0 if r == 2 else 1)
