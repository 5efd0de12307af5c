"""Port parity: ``train.estimator.Estimator`` against the JAX package's,
on the small device-index DLRM of ``test_torch_device_train.py``. The JAX
Estimator trains 3 steps into a model dir, which is copied; the JAX
Estimator continues 3 steps in one copy and the port's Estimator (which
restores the JAX save at first use) in the other. Both directories then
hold the same saves (by key: integer columns bit-equal, floats within
ROW_ATOL), evaluate to the same metrics and predict the same
probabilities, and the port's final save restores into a fresh port
Estimator at step 6. ``mesh=`` takes the port's ``multihost.Axis`` only
(``tests/test_torch_mesh_engines.py`` runs the mesh)."""
import shutil

import numpy as np
import pytest
import torch

import optax

import deeprec_tpu as dr
from deeprec_tpu import feature_column as jfc
from deeprec_tpu.data.criteo import DENSE_NAMES
from deeprec_tpu.optim import sparse as jsopt
from deeprec_tpu.train.estimator import Estimator as JEstimator

from deeprec_tpu_torch import config as tcfg
from deeprec_tpu_torch import feature_column as tfc
from deeprec_tpu_torch.optim import dense as tdense
from deeprec_tpu_torch.optim import sparse as tsopt
from deeprec_tpu_torch.train.estimator import Estimator as TEstimator

from test_torch_device_checkpoint import _assert_same_saves, _coll, _models
from test_torch_device_train import _criteo

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5  # served probabilities (test_torch_serving.py)
METRIC_ATOL = 1e-4


def _jax(path):
    jm, _ = _models()
    return JEstimator(jm, [jfc.NumericColumn(n, log_normalize=True)
                           for n in DENSE_NAMES],
                      {"emb": _coll(jfc, dr, "metadata")},
                      {"emb": jsopt.sparse_adagrad_fused(0.05)},
                      optax.adagrad(0.05), str(path))


def _port(path):
    _, tm = _models()
    return TEstimator(tm, [tfc.NumericColumn(n, log_normalize=True)
                           for n in DENSE_NAMES],
                      {"emb": _coll(tfc, tcfg, "metadata")},
                      {"emb": tsopt.sparse_adagrad_fused(0.05)},
                      tdense.Adagrad(0.05), str(path), device="cpu")


def test_estimator_matches_jax(tmp_path):
    train = _criteo(31, 6)
    held = _criteo(32, 2)
    a, b = tmp_path / "a", tmp_path / "b"
    _jax(a).train(lambda: iter(train[:3]))
    shutil.copytree(a, b)
    je, te = _jax(a), _port(b)
    jm = je.train(lambda: iter(train[3:]))
    tm = te.train(lambda: iter(train[3:]))
    assert te.global_step == je.global_step == 6
    for k in ("auc", "accuracy", "loss"):
        assert abs(tm[k] - jm[k]) <= METRIC_ATOL, (k, tm, jm)
    _assert_same_saves(str(a), str(b))

    jev, tev = je.evaluate(lambda: iter(held)), te.evaluate(
        lambda: iter(held))
    for k in ("auc", "accuracy", "loss"):
        assert abs(tev[k] - jev[k]) <= METRIC_ATOL, (k, tev, jev)
    size = int(te._state.tables["emb"].ev.index.size)
    for got, ref in zip(te.predict(lambda: iter(held)),
                        je.predict(lambda: iter(held))):
        assert got.shape == (len(held[0]["label"]),)
        np.testing.assert_allclose(got, np.asarray(ref), rtol=RTOL,
                                   atol=ATOL)
    # predict inserted nothing
    assert int(te._state.tables["emb"].ev.index.size) == size

    assert te.export_saved_model() == str(b)
    again = _port(b)
    assert again.evaluate(lambda: iter(held))["loss"] == \
        pytest.approx(tev["loss"], abs=METRIC_ATOL)
    assert again.global_step == 6


def test_estimator_refuses_a_mesh(tmp_path):
    """``mesh=`` takes the port's ``multihost.Axis``; anything else (a JAX
    ``Mesh``, say) is refused before a trainer is built. The mesh itself
    runs: ``tests/test_torch_mesh_engines.py``."""
    _, tm = _models()
    with pytest.raises(TypeError, match="multihost.Axis"):
        TEstimator(tm, [], {"emb": _coll(tfc, tcfg, "light")},
                   {"emb": tsopt.sparse_adagrad(0.05)}, tdense.Adagrad(0.05),
                   str(tmp_path), mesh=object(), device="cpu")
