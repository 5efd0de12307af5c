"""Port parity of the last two JAX functions the port lacked: the
behaviour stream's oracle AUC (``data/behavior.py`` ``oracle_auc`` and
``_rank_auc``, numpy copies) and ``feature_column.dense_features``."""
import inspect

import numpy as np
import pytest
import torch

from deeprec_tpu import feature_column as jfc
from deeprec_tpu.data import behavior as jbehavior

from deeprec_tpu_torch import feature_column as tfc
from deeprec_tpu_torch.data import behavior as tbehavior

torch.set_num_threads(1)


def test_oracle_auc_copies_are_the_source():
    for name in ("oracle_auc", "_rank_auc"):
        assert inspect.getsource(getattr(tbehavior, name)) == \
            inspect.getsource(getattr(jbehavior, name))


def test_oracle_auc_matches_jax():
    kw = dict(n_batches=8, seed=3)  # batches of 4096
    got = tbehavior.oracle_auc(**kw)
    assert got == jbehavior.oracle_auc(**kw)
    assert 0.5 < got < 1.0


@pytest.mark.parametrize("ties", [False, True])
def test_rank_auc_matches_jax(ties):
    rng = np.random.default_rng(4)
    s = rng.normal(size=2000)
    if ties:  # tied scores take their average rank
        s = np.round(s, 1)
    y = (rng.random(2000) < 1 / (1 + np.exp(-2 * s))).astype(np.float32)
    assert tbehavior._rank_auc(s, y) == jbehavior._rank_auc(s, y)


def test_dense_features_matches_jax():
    rng = np.random.default_rng(6)
    batch = {"a": rng.normal(0, 50, 64).astype(np.float32),
             "b": rng.integers(-5, 1000, (64, 3)).astype(np.float32),
             "c": rng.normal(size=64)}
    specs = [("a", 1, True), ("b", 3, True), ("c", 1, False)]
    jcols = [jfc.NumericColumn(n, shape=s, log_normalize=l)
             for n, s, l in specs]
    tcols = [tfc.NumericColumn(n, shape=s, log_normalize=l)
             for n, s, l in specs]
    want = np.asarray(jfc.dense_features(jcols, batch))
    got = tfc.dense_features(tcols, batch, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (64, 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    # the training path's split computes the same
    split = tfc.normalize_dense(tcols, torch.from_numpy(
        tfc.pack_dense(tcols, batch)))
    assert torch.equal(got, split)
