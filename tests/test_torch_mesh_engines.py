"""Port parity of the mesh entry points around the engines, on gloo ranks
(``tests/torch_mesh_worker.py``):

- ``checkpoint.migrate.import_tables`` into a 2-rank ``ShardedTrainer``
  from the committed DeepRec fixture (``tests/torch_fixtures/
  deeprec_bundle/``, read without TensorFlow): the ranks' shards together
  hold what the port's one-device import and the JAX import at 2 shards
  hold, every column bit-equal by key, and the same report.
- ``Estimator(mesh=)`` at 2 ranks continues a JAX ``Estimator(mesh=)``
  save beside the JAX one: the same saves by key (integer columns
  bit-equal, floats within ROW_ATOL), metrics within METRIC_ATOL; its
  predictions equal the one-device ``Predictor`` on its final save.
- ``python -m deeprec_tpu_torch.serving.server --mesh 2``: rank 0 answers
  HTTP predicts as the one-device ``Predictor`` does on the same save,
  answers a malformed request with 400 without the other rank hearing of
  it, refreshes, and closing its server stops the other rank.
"""
import json
import os
import shutil
import sys

import jax
import numpy as np
import optax
import pytest
import torch

import deeprec_tpu as dr
from deeprec_tpu import feature_column as jfc
from deeprec_tpu.checkpoint import migrate as jmig
from deeprec_tpu.models import ctr as jctr
from deeprec_tpu.models import sequence as jseq
from deeprec_tpu.optim import sparse as jsopt
from deeprec_tpu.parallel.trainer import make_mesh as jmesh
from deeprec_tpu.train.estimator import Estimator as JEstimator

from deeprec_tpu_torch.checkpoint import format as tformat
from deeprec_tpu_torch.checkpoint import migrate as tmig
from deeprec_tpu_torch.data.criteo import SyntheticCriteo
from deeprec_tpu_torch.serving import Predictor

import torch_mesh_worker as W
from test_torch_device_checkpoint import _assert_same_saves
from test_torch_mesh import (DENSE_NAMES, JAX_ENGINES, WIDE, batches,
                             jax_trainer)

sys.path.insert(0, os.path.join(W.REPO, "tests", "torch_fixtures"))
import make_bundle  # noqa: E402

torch.set_num_threads(1)

ROW_ATOL = 2e-5      # rows after a few steps
METRIC_ATOL = 1e-4   # AUC, accuracy, loss
PROB_ATOL = 1e-5     # served probabilities, the same save


def _by_key(a):
    order = np.argsort(a["keys"])
    return {k: np.asarray(v)[order] for k, v in a.items()
            if np.ndim(v) and len(v) == len(order)}


def test_import_tables_into_two_ranks(tmp_path):
    cols = [(f"C{i}", 1, "sum") for i in range(1, 5)]
    spec = dict(cols=cols, dim=make_bundle.DIM, capacity=64,
                numeric=["I1"], track_version=True)
    name_map = {"emb": {f"C{i}": make_bundle.ev_name(i)
                        for i in range(1, 5)}}
    batch = {"I1": np.ones(4, np.float32), "label": np.ones(4, np.float32),
             **{f"C{i}": np.zeros(4, np.int64) for i in range(1, 5)}}
    ranks = W.run_ranks("import", dict(spec=spec, batch=batch,
                                       prefix=make_bundle.PREFIX,
                                       name_map=name_map), 2, str(tmp_path))
    parts = [r["arrays"] for r in ranks]
    got = _by_key({k: np.concatenate([p[k] for p in parts])
                   for k in parts[0] if np.ndim(parts[0][k])})
    # the port on one device
    tr = W.build(spec)
    ts, trep = tmig.import_tables(tr, tr.init(batch), make_bundle.PREFIX,
                                  name_map=name_map, validate=True)
    one = _by_key(tr.collections["emb"].ckpt_arrays(ts.tables["emb"], 1,
                                                    None, False, 0))
    # the JAX package at 2 shards
    jt = jax_trainer(spec, 2)
    js = jt.init(jax.random.key(0), batch)
    js, jrep = jmig.import_tables(jt, js, make_bundle.PREFIX,
                                  name_map=name_map, validate=True)
    jarr = _by_key({k: np.asarray(v) for k, v in jt.collections["emb"]
                    .ckpt_arrays(js.tables["emb"], 2, None, False, 0)
                    .items()})
    assert len(got["keys"]) == 4 * make_bundle.N_KEYS
    for ref in (one, jarr):
        assert sorted(got) == sorted(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for r in ranks:
        assert r["report"] == trep == jrep
        assert r["capacity"] == jt.collections["emb"].config.capacity


def test_estimator_mesh_matches_jax(tmp_path):
    spec = dict(cols=WIDE, dim=8, capacity=1 << 9, fused=True,
                numeric=list(DENSE_NAMES[:4]))
    train, held = batches(41, 6, multi_hot=False), batches(42, 2,
                                                           multi_hot=False)
    a, b = tmp_path / "a", tmp_path / "b"

    def jest(path):
        coll, model = W.parts(spec, (dr, jfc, jctr, jseq, JAX_ENGINES))
        return JEstimator(model, [jfc.NumericColumn(n, log_normalize=True)
                                  for n in spec["numeric"]],
                          {"emb": coll},
                          {"emb": jsopt.sparse_adagrad_fused(0.05)},
                          optax.adagrad(0.05), str(path), mesh=jmesh(2),
                          log_steps=2)
    jest(a).train(lambda: iter(train[:3]))
    shutil.copytree(a, b)
    je = jest(a)
    jm = je.train(lambda: iter(train[3:]))
    jev = je.evaluate(lambda: iter(held))
    ranks = W.run_ranks("estimator", dict(spec=spec, dir=str(b),
                                          train=train[3:], held=held),
                        2, str(tmp_path / "ranks"))
    _assert_same_saves(str(a), str(b))
    coll, model = W.parts(spec)
    pred = Predictor(model, [], {"emb": coll}, str(b), device="cpu")
    for r in ranks:
        assert r["step"] == 6
        for k in ("auc", "accuracy", "loss"):
            assert abs(r["train"][k] - jm[k]) <= METRIC_ATOL, (k, r, jm)
            assert abs(r["eval"][k] - jev[k]) <= METRIC_ATOL, (k, r, jev)
    from deeprec_tpu_torch import feature_column as tfc
    pred = Predictor(model, [tfc.NumericColumn(n, log_normalize=True)
                             for n in spec["numeric"]], {"emb": coll},
                     str(b), device="cpu")
    for r in ranks:
        for got, batch in zip(r["predict"], held):
            np.testing.assert_allclose(got, pred.predict(batch), rtol=0,
                                       atol=PROB_ATOL)


def test_server_mesh_answers_like_the_predictor(tmp_path):
    from test_torch_cli import SMALL, _port, _run
    ck = str(tmp_path / "ck")
    _run("DLRM", SMALL + ["--steps", "3", "--checkpoint", ck])
    reqs = []
    for seed, n in ((5, 6), (6, 3)):
        b = next(iter(SyntheticCriteo(batch_size=n, seed=seed)))
        b.pop("label")
        reqs.append((b, json.dumps(
            {"inputs": {k: v.tolist() for k, v in b.items()}})))
    bad = dict(reqs[0][0])
    bad.pop("C7")  # a column the model reads
    body = [("/v1/predict", reqs[0][1]),
            ("/v1/predict", json.dumps(
                {"inputs": {k: v.tolist() for k, v in bad.items()}})),
            ("/v1/predict", reqs[1][1]), ("/refresh", "{}")]
    argv = ["--model", "DLRM", "--ckpt_dir", ck, "--host", "127.0.0.1",
            "--port", "0", "--mesh", "2", "--", "--emb_dim", "4",
            "--capacity", "8192", "--device", "cpu"]
    out = W.run_ranks("serve", dict(argv=argv, requests=body), 2,
                      str(tmp_path / "ranks"))
    answers = out[0]["answers"]
    assert [code for code, _ in answers] == [200, 400, 200, 200]
    assert "C7" in answers[1][1]["error"]
    assert answers[3][1]["changed"] is False
    assert out[1]["calls"] == 3  # two predicts and the refresh
    mod, args = _port("DLRM", SMALL + ["--emb_dim", "4"])
    spec = mod.build(args)
    pred = Predictor(spec.model, spec.numeric_columns, spec.collections, ck,
                     device="cpu")
    for (code, reply), (batch, _) in zip((answers[0], answers[2]), reqs):
        np.testing.assert_allclose(reply["predictions"], pred.predict(batch),
                                   rtol=0, atol=PROB_ATOL)
        assert reply["step"] == 3


@pytest.mark.parametrize("engine", ["host_index", "tiered"])
def test_cli_mesh_runs_every_engine(engine, tmp_path):
    """``torchrun --nproc_per_node 2 -m deeprec_tpu_torch.train.cli --mesh
    2 --device cpu`` with ``--host_index`` (the host-sharded engine, its
    resolves and host exchange on the pipeline's thread) or with a tiered
    ``--ev_storage`` (``TieredShardedTrainer``, demoting at fences): both
    train, rank 0 alone reports, the save has one part per rank, and the
    JAX CLI restores it and trains on."""
    import importlib
    import subprocess
    from deeprec_tpu.train import cli as jcli
    from test_torch_mesh_ckpt import CLI_FLAGS
    extra = (["--host_index"] if engine == "host_index" else
             ["--ev_storage", "hbm_dram", "--ev_evict_steps", "2",
              "--demote_steps", "2"])
    ck = str(tmp_path / "ck")
    cmd = [sys.executable, "-m", "torch.distributed.run",
           "--nproc_per_node", "2", "--master_addr", "127.0.0.1",
           "--master_port", str(W.free_port()), "-m",
           "deeprec_tpu_torch.train.cli", "--model", "DLRM", "--mesh", "2",
           "--device", "cpu", "--steps", "6", "--checkpoint", ck,
           *CLI_FLAGS, *extra]
    with W.job_slot():
        out = subprocess.run(cmd, cwd=W.REPO, capture_output=True, text=True,
                             timeout=150, env=dict(os.environ,
                                                   PYTHONPATH=W.REPO,
                                                   OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-4000:]
    summaries = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    assert len(summaries) == 1  # rank 0 alone prints
    assert json.loads(summaries[0])["steps"] == 6
    save = tformat.list_saves(ck)[-1]
    assert save["parts"] == 2 and save["step"] == 6
    rows = tformat.read_table(save["path"], "emb")["keys"]
    assert len(rows) == len(np.unique(rows)) > 0  # every key in one part
    if engine == "tiered":
        assert "host tier rows" in out.stdout
    sys.path.insert(0, W.REPO)  # the JAX package's modelzoo/
    jmod = importlib.import_module("modelzoo.DLRM.train")
    args = jcli.base_parser("DLRM").parse_args(
        CLI_FLAGS + extra + ["--steps", "2", "--checkpoint", ck])
    assert jcli.run(jmod.build(args), args)["steps"] == 8
