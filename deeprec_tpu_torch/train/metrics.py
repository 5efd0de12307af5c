"""Streaming training/eval metrics (port of ``deeprec_tpu/train/metrics.py``).

AUC is a device-resident histogram of positive and negative counts over
fixed probability bins, finalised by trapezoidal integration (the
thresholded estimator of ``tf.metrics.auc`` with ``nbins + 1``
thresholds). The histogram is a ``torch.bincount`` with weights; the JAX
package's one-hot matmul is a TPU workaround and stays behind.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class MetricState(NamedTuple):
    pos_hist: torch.Tensor  # [nbins] float32
    neg_hist: torch.Tensor
    loss_sum: torch.Tensor  # f32 scalar
    correct: torch.Tensor   # f32 scalar
    count: torch.Tensor     # f32 scalar


def create(nbins: int = 1024, device="cuda") -> MetricState:
    def z(shape=()):
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return MetricState(z((nbins,)), z((nbins,)), z(), z(), z())


def update(state: MetricState, logits: torch.Tensor, labels: torch.Tensor,
           loss: Optional[torch.Tensor] = None) -> MetricState:
    nbins = state.pos_hist.shape[0]
    logits = logits.detach().float()
    p = torch.sigmoid(logits)
    labels = labels.float()
    idx = torch.clamp((p * nbins).to(torch.int64), 0, nbins - 1)
    pos = state.pos_hist + torch.bincount(idx, weights=labels,
                                          minlength=nbins)
    neg = state.neg_hist + torch.bincount(idx, weights=1.0 - labels,
                                          minlength=nbins)
    correct = state.correct + ((p >= 0.5) == (labels >= 0.5)).sum()
    n = float(logits.shape[0])
    loss_sum = state.loss_sum + (loss.detach() * n if loss is not None
                                 else 0.0)
    return MetricState(pos, neg, loss_sum, correct, state.count + n)


def auc(state: MetricState) -> torch.Tensor:
    """Trapezoidal AUC over the ROC curve induced by the bin thresholds."""
    tp = torch.cumsum(state.pos_hist.flip(0), 0)
    fp = torch.cumsum(state.neg_hist.flip(0), 0)
    P = torch.clamp_min(tp[-1], 1e-12)
    N = torch.clamp_min(fp[-1], 1e-12)
    zero = tp.new_zeros((1,))
    tpr = torch.cat([zero, tp / P])
    fpr = torch.cat([zero, fp / N])
    return torch.sum((fpr[1:] - fpr[:-1]) * 0.5 * (tpr[1:] + tpr[:-1]))


def summarize(state: MetricState) -> dict:
    """auc, accuracy, mean loss and example count, with one device-to-host
    read."""
    a, correct, loss_sum, count = torch.stack(
        [auc(state), state.correct, state.loss_sum, state.count]).tolist()
    c = max(count, 1e-12)
    return {"auc": a, "accuracy": correct / c, "loss": loss_sum / c,
            "examples": int(count)}
