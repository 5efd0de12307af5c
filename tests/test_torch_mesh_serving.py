"""The port's ``ShardedPredictor`` on 2 gloo ranks against the JAX
``ShardedPredictor`` on 2 virtual devices and against the one-device
``Predictor`` of both packages, over a save of the JAX mesh trainer at 4
shards (so every restore reshards): probabilities within PROB_ATOL on
held-out batches of an odd size (padded to the rank count), then again
after ``refresh()`` picks up an incremental save, also when only rank 0
lists it yet. A request that
overflows the owner buckets is served again with a wider slack, to the
same probabilities."""
import os
import shutil

import numpy as np
import pytest

from deeprec_tpu import feature_column as jfc
from deeprec_tpu.checkpoint.saver import CheckpointManager as JManager
from deeprec_tpu.parallel.trainer import make_mesh as jmesh
from deeprec_tpu.serving import Predictor as JPredictor
from deeprec_tpu.serving import ShardedPredictor as JSharded

import deeprec_tpu as dr
from deeprec_tpu.models import ctr as jctr
from deeprec_tpu.models import sequence as jseq

from deeprec_tpu_torch import feature_column as tfc
from deeprec_tpu_torch.checkpoint import format as tformat
from deeprec_tpu_torch.serving import Predictor as TPredictor

import test_torch_mesh as M
import torch_mesh_worker as W

PROB_ATOL = 1e-6
SPEC = dict(M.SPEC, track_version=True)
HELD = 51  # an odd request size: padded to a multiple of the ranks


@pytest.fixture(scope="module")
def saves(tmp_path_factory):
    """A JAX 4-shard training run's full save (directory ``full``) and the
    incremental save that follows it (directory ``incr``, outside)."""
    root = tmp_path_factory.mktemp("mesh_serving")
    bs = M.batches(21, 4)
    jt = M.jax_trainer(SPEC, 4)
    js, _ = M.jax_init(jt, bs[0])
    mgr = JManager(str(root / "ck"))
    for i, b in enumerate(bs):
        js = jt.train_step(js, b)
        if i == 1:
            mgr.save(jt, js)
    mgr.save_incremental(jt, js)
    full, incr = tformat.list_saves(str(root / "ck"))
    assert (full["kind"], incr["kind"]) == ("full", "incr")
    shutil.copytree(full["path"], str(root / "full" /
                                       os.path.basename(full["path"])))
    return str(root / "full"), incr["path"]


def _copy(src, dst):
    shutil.copytree(src, dst)
    return dst


def _jax_probs(make, ckpt, incr, held):
    """A JAX predictor's probabilities before and after a refresh onto
    ``incr``."""
    pred = make(ckpt)
    before = [np.asarray(pred.predict(b)) for b in held]
    shutil.copytree(incr, os.path.join(ckpt, os.path.basename(incr)))
    assert pred.refresh()
    return before, [np.asarray(pred.predict(b)) for b in held]


def _port_one_device(ckpt):
    coll, model = W.parts(SPEC)
    return TPredictor(model, [tfc.NumericColumn(n, log_normalize=True)
                              for n in SPEC["numeric"]],
                      {"emb": coll}, ckpt, device="cpu")


def test_sharded_predictor_matches_jax_and_one_device(saves, tmp_path):
    full, incr = saves
    held = M.batches(31, 3, bs=HELD)
    ranks = W.run_ranks("predict", {
        "spec": SPEC, "batches": held, "then": incr,
        "ckpt": _copy(full, str(tmp_path / "port"))}, 2,
        str(tmp_path / "ranks"))
    numeric = [jfc.NumericColumn(n, log_normalize=True)
               for n in SPEC["numeric"]]

    def jax_make(sharded):
        def make(ckpt):
            coll, model = W.parts(SPEC, (dr, jfc, jctr, jseq))
            if sharded:
                return JSharded(model, numeric, {"emb": coll}, ckpt,
                                mesh=jmesh(2))
            return JPredictor(model, numeric, {"emb": coll}, ckpt)
        return make

    refs = {
        "jax sharded": _jax_probs(jax_make(True), _copy(
            full, str(tmp_path / "js")), incr, held),
        "jax one-device": _jax_probs(jax_make(False), _copy(
            full, str(tmp_path / "j1")), incr, held),
        "port one-device": _jax_probs(_port_one_device, _copy(
            full, str(tmp_path / "t1")), incr, held),
    }
    for r in ranks:
        assert r["refreshed"]
        for what, (before, after) in refs.items():
            for got, want in zip(r["before"] + r["after"], before + after):
                assert got.shape == (HELD,)
                np.testing.assert_allclose(got, want, rtol=0,
                                           atol=PROB_ATOL, err_msg=what)
    # the incremental save moved the predictions
    assert max(np.abs(a - b).max() for a, b in
               zip(ranks[0]["before"], ranks[0]["after"])) > 1e-6


def test_refresh_applies_rank0s_saves_on_every_rank(saves, tmp_path):
    """Rank 1 lists a directory that lacks the incremental save rank 0
    sees: both ranks apply rank 0's plan (the loads run collectives, so a
    rank that skipped the save would hang the group or serve another
    table version) and serve what the one-device predictor serves."""
    full, incr = saves
    held = M.batches(33, 2, bs=HELD)
    ranks = W.run_ranks("predict", {
        "spec": SPEC, "batches": held, "then": incr, "lag": True,
        "ckpt": _copy(full, str(tmp_path / "port"))}, 2,
        str(tmp_path / "ranks"))
    before, after = _jax_probs(_port_one_device, _copy(
        full, str(tmp_path / "t1")), incr, held)
    incr_step = tformat.list_saves(os.path.dirname(incr))[-1]["step"]
    assert incr_step in ranks[0]["listed"]
    assert incr_step not in ranks[1]["listed"]
    for r in ranks:
        assert r["refreshed"]
        for got, want in zip(r["before"] + r["after"], before + after):
            np.testing.assert_allclose(got, want, rtol=0, atol=PROB_ATOL)


def test_bucket_overflow_is_served_again(saves, tmp_path):
    """A slack far too small overflows the owner buckets: every rank
    warns, widens it and serves the request again, to the one-device
    answer."""
    full, _ = saves
    held = M.batches(32, 2, bs=HELD)
    ranks = W.run_ranks("predict", {
        "spec": SPEC, "batches": held, "bucket_slack": 1e-6,
        "ckpt": _copy(full, str(tmp_path / "port"))}, 2,
        str(tmp_path / "ranks"))
    one = _port_one_device(full)
    for r in ranks:
        assert r["slack"] > 1e-6
        assert any("overflowed owner buckets" in w for w in r["warnings"])
        for got, b in zip(r["before"], held):
            np.testing.assert_allclose(got, one.predict(b), rtol=0,
                                       atol=PROB_ATOL)
