"""The two host syncs of a training step that needed no new design are
gone (ROADMAP C7), and their results are unchanged:

- ``train.metrics.update`` builds its AUC histograms with scatter-adds on
  the device instead of a weighted ``torch.bincount`` (which syncs on the
  card): bit-equal to the ``bincount`` histograms and to the JAX package's
  on logits where many share a bin, over several updates.
- ``feature_column.normalize_dense`` keeps its ``log_normalize`` mask on
  the device, built once per column list and device, instead of copying a
  numpy mask every call: bit-equal to the per-call mask.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeprec_tpu import feature_column as jfc
from deeprec_tpu.train import metrics as jmetrics

from deeprec_tpu_torch import feature_column as tfc
from deeprec_tpu_torch.train import metrics as tmetrics


def _bincount_update(state, logits, labels):
    """The histograms as ``metrics.update`` built them before: weighted
    ``torch.bincount``s added to the state."""
    nbins = state.pos_hist.shape[0]
    p = torch.sigmoid(logits.float())
    idx = torch.clamp((p * nbins).to(torch.int64), 0, nbins - 1)
    labels = labels.float()
    return (state.pos_hist + torch.bincount(idx, weights=labels,
                                            minlength=nbins),
            state.neg_hist + torch.bincount(idx, weights=1.0 - labels,
                                            minlength=nbins))


@pytest.mark.parametrize("nbins", [16, 1024])
def test_histograms_equal_bincount_and_jax(nbins):
    rng = np.random.default_rng(0)
    ts = tmetrics.create(nbins, device="cpu")
    js = jmetrics.create(nbins)
    for _ in range(3):
        # logits on a coarse grid: many share a bin
        logits = (np.round(rng.standard_normal(512) * 4) / 2).astype(
            np.float32)
        labels = (rng.random(512) < 0.4).astype(np.float32)
        tl, tlab = torch.from_numpy(logits), torch.from_numpy(labels)
        ref_pos, ref_neg = _bincount_update(ts, tl, tlab)
        ts = tmetrics.update(ts, tl, tlab)
        js = jmetrics.update(js, jnp.asarray(logits), jnp.asarray(labels))
        assert ts.pos_hist.dtype == torch.float32
        assert torch.equal(ts.pos_hist, ref_pos.float())
        assert torch.equal(ts.neg_hist, ref_neg.float())
        np.testing.assert_array_equal(ts.pos_hist.numpy(),
                                      np.asarray(js.pos_hist))
        np.testing.assert_array_equal(ts.neg_hist.numpy(),
                                      np.asarray(js.neg_hist))
    assert int((ts.pos_hist > 1).sum()) > 0  # bins held several logits
    assert abs(tmetrics.summarize(ts)["auc"]
               - jmetrics.summarize(js)["auc"]) <= 1e-6


def _per_call_normalize(columns, raw):
    """``normalize_dense`` as it was: a numpy mask copied every call."""
    mask = np.concatenate([np.full(col.shape, col.log_normalize, bool)
                           for col in columns])
    if not mask.any():
        return raw
    logged = torch.log1p(torch.clamp_min(raw, 0.0))
    return torch.where(torch.from_numpy(mask).to(raw.device)[None, :],
                       logged, raw)


def test_normalize_dense_unchanged_and_its_mask_kept():
    rng = np.random.default_rng(1)
    cols = [tfc.NumericColumn("a", log_normalize=True),
            tfc.NumericColumn("b", shape=2),
            tfc.NumericColumn("c", log_normalize=True)]
    jcols = [jfc.NumericColumn(c.name, c.shape, c.log_normalize)
             for c in cols]
    for _ in range(3):
        raw = torch.from_numpy(
            (rng.standard_normal((64, 4)) * 50).astype(np.float32))
        got = tfc.normalize_dense(cols, raw)
        assert torch.equal(got, _per_call_normalize(cols, raw))
        # XLA's log1p and torch's differ in the last ulp
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jfc.normalize_dense(
                jcols, jnp.asarray(raw.numpy()))), rtol=1e-6, atol=0)
    # the mask is built once per column list and device
    m1 = tfc._log_mask(tuple(cols), raw.device)
    assert m1 is tfc._log_mask(tuple(list(cols)), torch.device("cpu"))
    assert m1.tolist() == [[True, False, False, True]]
    # no column takes the log: the input comes back as it is
    plain = [tfc.NumericColumn("x", shape=3)]
    raw = torch.randn(5, 3)
    assert tfc.normalize_dense(plain, raw) is raw
