"""Saves of the mesh engine cross between the packages at other shard
counts: a JAX ``ShardedTrainer`` save of 4 shards restores into the
port's mesh at 2 ranks and into its one-device ``Trainer``; a save of the
port's 2 ranks (one part file each) restores into the JAX package at 4
devices and at one. Full saves, and a full save followed by an
incremental one. Key sets bit-equal and rows equal (a restore copies
rows, so the saved float32 values come back unchanged), freqs and
versions too; each restored shard holds only the keys its owner hash
routes to it; the dense leaves equal.

A CBF table's sketch: at the same shard count each rank takes its own
saved block, at another the union of every block.

The CLI's ``--mesh 2`` under ``torchrun`` trains on the CPU and writes a
save the JAX CLI restores; ``--mesh`` with what is not ported refuses.
"""
import json
import os

import numpy as np
import pytest

import jax

from deeprec_tpu.checkpoint.saver import CheckpointManager as JManager

from deeprec_tpu_torch.checkpoint import format as tformat
from deeprec_tpu_torch.checkpoint import saver as tsaver
from deeprec_tpu_torch.parallel.sharded import OWNER_SEED
from deeprec_tpu_torch.sparse import keys as tkeys

import test_torch_mesh as M
import torch_mesh_worker as W

STEPS = 5
SPEC = dict(M.SPEC, track_version=True)
SAVES = {False: {STEPS - 1: "full"}, True: {1: "full", STEPS - 1: "incr"}}


def by_key(shards):
    """``key -> (row, freq, version)`` over a table's shards; asserts that
    each key lives in one shard."""
    out = {}
    for d in shards:
        live = d["keys"] != -1
        for k, row, f, v in zip(d["keys"][live], d["values"][:-1][live],
                                d["freqs"][:-1][live],
                                d["versions"][:-1][live]):
            assert int(k) not in out, k
            out[int(k)] = (row, int(f), int(v))
    return out


def assert_same_rows(got, want):
    assert sorted(got) == sorted(want) and len(want) > 0
    for k, (row, f, v) in want.items():
        g = got[k]
        np.testing.assert_array_equal(g[0], row, err_msg=str(k))
        assert g[1:] == (f, v), k


def assert_owned(shards):
    """Shard ``s`` of ``S`` holds only keys whose owner hash is ``s``."""
    S = len(shards)
    for s, d in enumerate(shards):
        keys = d["keys"][d["keys"] != -1]
        own = tkeys.hash32_np(keys, seed=OWNER_SEED) % np.uint32(S)
        assert (own == s).all()


@pytest.mark.parametrize("incremental", [False, True],
                         ids=["full", "incremental"])
def test_jax_four_shard_save_restores_in_the_port(incremental, tmp_path):
    bs = M.batches(11, STEPS)
    jt = M.jax_trainer(SPEC, 4)
    js, _ = M.jax_init(jt, bs[0])
    mgr = JManager(str(tmp_path / "ck"))
    for i, b in enumerate(bs):
        js = jt.train_step(js, b)
        kind = SAVES[incremental].get(i)
        if kind == "full":
            mgr.save(jt, js)
        elif kind == "incr":
            mgr.save_incremental(jt, js)
    want = by_key(M.jax_shards(jt, js, 4))
    ref_dense = [np.asarray(x) for x in jax.tree_util.tree_leaves(
        (js.params, js.opt_state, js.step))]
    ranks = W.run_ranks("restore", {"spec": SPEC, "batches": bs[:1],
                                    "ckpt": str(tmp_path / "ck")},
                        2, str(tmp_path / "ranks"))
    shards = [r["shard"] for r in ranks]
    assert_owned(shards)
    assert_same_rows(by_key(shards), want)
    tr = W.build(SPEC)
    st, ok = tsaver.CheckpointManager(str(tmp_path / "ck")).restore(
        tr, tr.init(bs[0]))
    assert ok and st.step == STEPS
    assert_same_rows(by_key([W.shard_np(st)]), want)
    for dense in [r["dense"] for r in ranks] + [tsaver._dense_leaves(tr, st)]:
        for g, w in zip(dense, ref_dense):
            np.testing.assert_array_equal(np.asarray(g), w)


@pytest.mark.parametrize("incremental", [False, True],
                         ids=["full", "incremental"])
def test_port_two_rank_save_restores_in_jax(incremental, tmp_path):
    bs = M.batches(12, STEPS)
    ck = str(tmp_path / "ck")
    _, dense = M.jax_init(M.jax_trainer(SPEC), bs[0])
    ranks = W.run_ranks("train", {"spec": SPEC, "batches": bs,
                                  "dense": dense, "ckpt": ck,
                                  "saves": SAVES[incremental]},
                        2, str(tmp_path / "ranks"))
    want = by_key([r["shard"] for r in ranks])
    saves = tformat.list_saves(ck)
    assert [m["kind"] for m in saves] == \
        sorted(SAVES[incremental].values())
    assert all(m["parts"] == 2 for m in saves)
    for S in (4, None):
        jt = M.jax_trainer(SPEC, S)
        js, _ = M.jax_init(jt, bs[0])
        js, ok = JManager(ck).restore(jt, js)
        assert ok and int(js.step) == STEPS
        got = M.jax_shards(jt, js, S or 1)
        if S:
            assert_owned(got)
        assert_same_rows(by_key(got), want)
        ref = [np.asarray(x) for x in jax.tree_util.tree_leaves(
            (js.params, js.opt_state, js.step))]
        for g, w in zip(ranks[0]["dense"], ref):
            np.testing.assert_array_equal(g, w)


def test_cbf_sketch_follows_the_shard_count(tmp_path):
    """A save of 2 ranks holds one CBF block per part; a restore at 2
    ranks takes each rank's own block, one at another count (here the
    one-device trainer) the union (sum) of the blocks."""
    spec = dict(M.SPEC, cols=M.WIDE, cbf=True, track_version=True)
    bs = M.batches(13, 3, multi_hot=False)
    ck = str(tmp_path / "ck")
    ranks = W.run_ranks("train", {"spec": spec, "batches": bs, "ckpt": ck,
                                  "saves": {2: "full"}},
                        2, str(tmp_path / "ranks"))
    table = tformat.read_table(tformat.list_saves(ck)[-1]["path"], "emb")
    blocks = [table[f"cbf__shard{s:03d}"] for s in range(2)]
    assert int(table["cbf_shards"]) == 2
    for r, blk in zip(ranks, blocks):
        np.testing.assert_array_equal(r["shard"]["cbf"], blk)
    back = W.run_ranks("restore", {"spec": spec, "batches": bs[:1],
                                   "ckpt": ck},
                       2, str(tmp_path / "back"))
    for r, blk in zip(back, blocks):
        np.testing.assert_array_equal(r["shard"]["cbf"], blk)
    assert_same_rows(by_key([r["shard"] for r in back]),
                     by_key([r["shard"] for r in ranks]))
    tr = W.build(spec)
    st, _ = tsaver.CheckpointManager(ck).restore(tr, tr.init(bs[0]))
    np.testing.assert_array_equal(st.tables["emb"].ev.cbf.numpy(),
                                  blocks[0] + blocks[1])
    # the JAX package reads the part files' blocks the same way
    jt = M.jax_trainer(spec)
    js, _ = M.jax_init(jt, bs[0])
    js, _ = JManager(ck).restore(jt, js)
    np.testing.assert_array_equal(np.asarray(js.tables["emb"].ev.cbf),
                                  blocks[0] + blocks[1])
    assert sorted(by_key([W.shard_np(st)])) == \
        sorted(by_key(M.jax_shards(jt, js, 1)))


CLI_FLAGS = ["--batch_size", "32", "--emb_dim", "4", "--capacity", "4096",
             "--eval_steps", "1", "--log_steps", "2", "--optimizer",
             "adagrad", "--learning_rate", "0.01", "--max_unique_ratio", "0",
             "--prefetch_workers", "1", "--jit_cache", ""]


def test_cli_mesh_trains_under_torchrun_and_jax_restores(tmp_path):
    """``torchrun --nproc_per_node 2 -m deeprec_tpu_torch.train.cli --mesh
    2 --device cpu``: two ranks train, rank 0 alone reports, the save has
    one part per rank, and the JAX CLI restores it and trains on."""
    import importlib
    import subprocess
    import sys
    from deeprec_tpu.train import cli as jcli
    ck = str(tmp_path / "ck")
    cmd = [sys.executable, "-m", "torch.distributed.run",
           "--nproc_per_node", "2", "--master_addr", "127.0.0.1",
           "--master_port", str(W.free_port()), "-m",
           "deeprec_tpu_torch.train.cli", "--model", "DLRM", "--mesh", "2",
           "--device", "cpu", "--steps", "4", "--checkpoint", ck,
           *CLI_FLAGS]
    out = subprocess.run(cmd, cwd=W.REPO, capture_output=True, text=True,
                         timeout=120, env=dict(os.environ,
                                               PYTHONPATH=W.REPO))
    assert out.returncode == 0, out.stderr[-4000:]
    summaries = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    assert len(summaries) == 1  # rank 0 alone prints
    assert json.loads(summaries[0])["steps"] == 4
    save = tformat.list_saves(ck)[-1]
    assert save["parts"] == 2 and save["step"] == 4
    sys.path.insert(0, W.REPO)  # the JAX package's modelzoo/
    jmod = importlib.import_module("modelzoo.DLRM.train")
    args = jcli.base_parser("DLRM").parse_args(
        CLI_FLAGS + ["--steps", "2", "--checkpoint", ck])
    assert jcli.run(jmod.build(args), args)["steps"] == 6


def test_cli_mesh_refuses_what_is_not_ported():
    """Every engine runs on a mesh now: ``--host_index`` takes the
    host-sharded collection, unless a tiered ``--ev_storage`` or
    ``--micro_batch > 1`` sends it to the device-index engine with a note
    (the JAX CLI's rule); only ``--micro_batch > 1`` with ``--host_index``
    on one device is refused (ROADMAP C6)."""
    import argparse
    from deeprec_tpu_torch.feature_column import EmbeddingCollection
    from deeprec_tpu_torch.parallel.host_sharded import HostShardedCollection
    from deeprec_tpu_torch.train import cli as tcli

    def ns(**kw):
        return argparse.Namespace(**dict(dict(
            mesh=2, micro_batch=1, host_index=True, ev_storage="hbm"), **kw))
    for args, cls in ((ns(), HostShardedCollection),
                      (ns(ev_storage="hbm_dram"), EmbeddingCollection),
                      (ns(micro_batch=2), EmbeddingCollection),
                      (ns(host_index=False, ev_storage="hbm_dram"),
                       EmbeddingCollection)):
        tcli.check_supported(args)
        assert tcli.collection_cls(args) is cls
    with pytest.raises(NotImplementedError, match="C6"):
        tcli.check_supported(ns(mesh=0, micro_batch=2))
