"""Port parity: ``ops/segment.py``'s ``segment_sum`` and ``segment_combine``
against the JAX package's (``jax.ops.segment_sum``, an XLA scatter-add) on
the CPU, with ids outside ``[0, n)`` dropped, empty segments and one
segment; and the plain version of K2's backward, what a CPU tensor runs,
against the transpose of the JAX gather it differentiates, at Criteo's
skew. On a CUDA tensor float data goes through K2's backward instead; the
card tests (tests/test_torch_kernels_cuda.py) hold it to these plain
versions."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeprec_tpu.ops import segment as jseg

from deeprec_tpu_torch.ops import segment as tseg
from deeprec_tpu_torch.ops.fused_lookup import (
    fused_pooled_lookup_backward, fused_pooled_lookup_backward_plain)

torch.set_num_threads(1)

# name: (rows, trailing shape, segments, id draw)
_CASES = {
    "dropped_and_empty": (400, (16,), 90, "mixed"),
    "one_segment": (300, (8,), 1, "zero"),
    "skewed_1d": (600, (), 40, "skewed"),
    "matrix_rows": (200, (3, 5), 70, "mixed"),
    "all_dropped": (50, (4,), 10, "out"),
}


def _case(name, seed=0):
    n, tail, segs, draw = _CASES[name]
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(n,) + tail).astype(np.float32)
    if draw == "zero":
        ids = np.zeros(n, np.int32)
    elif draw == "skewed":
        ids = (rng.random(n) ** 4 * segs).astype(np.int32)
    elif draw == "out":
        ids = np.where(rng.random(n) < 0.5, -3, segs + 2).astype(np.int32)
    else:  # some ids out of range on both sides, every 4th segment empty
        ids = rng.integers(-segs // 10, segs + segs // 10, n).astype(np.int32)
        ids[(ids >= 0) & (ids % 4 == 3)] += 1
    return data, ids, segs


@pytest.mark.parametrize("case", list(_CASES))
def test_segment_sum_matches_jax(case):
    data, ids, segs = _case(case)
    ref = np.asarray(jseg.segment_sum(jnp.asarray(data), jnp.asarray(ids),
                                      segs))
    got = tseg.segment_sum(torch.from_numpy(data), torch.from_numpy(ids),
                           segs)
    assert got.shape == ref.shape
    # both add each segment's rows in row order here
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    keep = (ids >= 0) & (ids < segs)
    empty = np.bincount(ids[keep], minlength=segs) == 0
    assert not got.numpy()[empty].any()
    assert fused_pooled_lookup_backward.launches == 0


def test_segment_sum_integer_data_matches_jax():
    data, ids, segs = _case("dropped_and_empty")
    counts = (np.abs(data[:, 0]) * 10).astype(np.int32)
    ref = np.asarray(jseg.segment_sum(jnp.asarray(counts), jnp.asarray(ids),
                                      segs))
    got = tseg.segment_sum(torch.from_numpy(counts), torch.from_numpy(ids),
                           segs)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
@pytest.mark.parametrize("case", ["dropped_and_empty", "one_segment"])
def test_segment_combine_matches_jax(case, combiner, weighted):
    data, ids, segs = _case(case, seed=1)
    w = (np.random.default_rng(2).random(data.shape[0]).astype(np.float32)
         if weighted else None)
    ref = np.asarray(jseg.segment_combine(
        jnp.asarray(data), jnp.asarray(ids), segs, combiner,
        None if w is None else jnp.asarray(w)))
    got = tseg.segment_combine(
        torch.from_numpy(data), torch.from_numpy(ids), segs, combiner,
        None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", list(_CASES))
def test_segment_sum_backward_is_the_jax_transpose(case):
    """``segment_sum_backward``, the card route's backward, equals jax.vjp
    of the JAX package's ``segment_sum``: each row takes its segment's
    cotangent, a dropped id zero."""
    data, ids, segs = _case(case, seed=3)
    ct = np.random.default_rng(4).normal(
        size=(segs,) + data.shape[1:]).astype(np.float32)
    _, vjp = jax.vjp(lambda d: jseg.segment_sum(d, jnp.asarray(ids), segs),
                     jnp.asarray(data))
    (ref,) = vjp(jnp.asarray(ct))
    t_ids = torch.from_numpy(ids)
    got = tseg.segment_sum_backward(torch.from_numpy(ct), t_ids,
                                    (t_ids >= 0) & (t_ids < segs))
    assert got.shape == data.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
@pytest.mark.parametrize("case", ["dropped_and_empty", "one_segment"])
def test_card_route_gradient_matches_jax(case, combiner, weighted,
                                         monkeypatch):
    """``segment_combine``'s gradients through the card route's autograd
    function (its sums run K2's plain backward on a CPU tensor) against
    jax.grad of the JAX package's ``segment_combine``, in ``data`` and the
    weights, to 1e-5."""
    data, ids, segs = _case(case, seed=6)
    rng = np.random.default_rng(7)
    w = rng.random(data.shape[0]).astype(np.float32) if weighted else None
    ct = rng.normal(size=(segs,) + data.shape[1:]).astype(np.float32)

    def loss(d, wt):
        return (jseg.segment_combine(d, jnp.asarray(ids), segs, combiner,
                                     wt) * jnp.asarray(ct)).sum()
    ref = jax.grad(loss, argnums=(0, 1) if weighted else 0)(
        jnp.asarray(data), None if w is None else jnp.asarray(w))
    ref_d, ref_w = ref if weighted else (ref, None)

    cpu_route = tseg.segment_sum

    def card_route(d, i, n):
        if not d.is_floating_point():
            return cpu_route(d, i, n)
        return tseg._SegmentSum.apply(d, i, (i >= 0) & (i < n), n)
    monkeypatch.setattr(tseg, "segment_sum", card_route)
    d = torch.from_numpy(data).requires_grad_()
    wt = None if w is None else torch.from_numpy(w).requires_grad_()
    out = tseg.segment_combine(d, torch.from_numpy(ids), segs, combiner, wt)
    assert out.grad_fn is not None
    (out * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(ref_d), rtol=1e-5,
                               atol=1e-6)
    if weighted:
        np.testing.assert_allclose(wt.grad.numpy(), np.asarray(ref_w),
                                   rtol=1e-5, atol=1e-5)


def test_segment_combine_rejects_unknown_combiner():
    data, ids, segs = _case("one_segment")
    with pytest.raises(ValueError, match="unknown combiner"):
        tseg.segment_combine(torch.from_numpy(data), torch.from_numpy(ids),
                             segs, "max")


def _skewed_bags(layout, rng):
    """(slots, valid, d_pooled, n_rows): Criteo's [26*B, 1] layout with one
    row taking 1,100 lanes, a multi-hot [B, 8] layout with a power-law
    draw, or the transposed view ``inv[1:4].T`` of a [W, B] inverse (the
    serving path's)."""
    if layout == "criteo":
        bags, w, n_rows = 26 * 512, 1, 2000
        slots = (rng.random((bags, w)) ** 3 * n_rows).astype(np.int64)
        hot = rng.permutation(bags)[:1100]
        slots[hot] = 7
    elif layout == "multihot":
        bags, w, n_rows = 512, 8, 900
        slots = (rng.random((bags, w)) ** 4 * (n_rows + 4) - 2).astype(
            np.int64)
    else:
        bags, n_rows = 700, 300
        inv = (rng.random((6, bags)) ** 3 * n_rows).astype(np.int64)
        slots = inv[1:4].T
        w = 3
    valid = rng.random(slots.shape) < 0.8
    if layout == "criteo":
        valid[hot] = True  # the hot row's lanes all count
    valid[0] = False
    d_pooled = rng.normal(size=(bags, 16)).astype(np.float32)
    return slots, valid, d_pooled, n_rows


@pytest.mark.parametrize("idx", [np.int32, np.int64])
@pytest.mark.parametrize("layout", ["criteo", "multihot", "transposed"])
@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
def test_plain_backward_is_the_jax_gather_transpose(combiner, layout, idx):
    """The plain version of K2's backward (what a CPU tensor runs, and what
    the card's kernel is held to) equals jax.vjp of the pooling it
    differentiates, a JAX gather of the clamped slots masked by ``valid``,
    whose transpose XLA computes as a scatter-add; at Criteo's skew a row
    takes 1,100 lanes."""
    rng = np.random.default_rng(5)
    slots, valid, d_pooled, n_rows = _skewed_bags(layout, rng)
    slots = slots.astype(idx)
    values = rng.normal(size=(n_rows, 16)).astype(np.float32)
    n = np.maximum(valid.sum(1, keepdims=True), 1).astype(np.float32)
    scale = {"sum": np.ones_like(n), "mean": n, "sqrtn": np.sqrt(n)}[combiner]

    def pool(v):
        rows = v[jnp.clip(jnp.asarray(slots), 0, n_rows - 1)]
        rows = jnp.where(jnp.asarray(valid)[..., None], rows, 0.0)
        return rows.sum(1) / jnp.asarray(scale)
    _, vjp = jax.vjp(pool, jnp.asarray(values))
    (ref,) = vjp(jnp.asarray(d_pooled))
    got = fused_pooled_lookup_backward_plain(
        torch.from_numpy(d_pooled), torch.from_numpy(slots),
        torch.from_numpy(valid), combiner, n_rows)
    assert got.shape == (n_rows, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    lanes = np.bincount(np.clip(slots, 0, n_rows - 1)[valid],
                        minlength=n_rows)
    assert not got.numpy()[lanes == 0].any()
    if layout == "criteo":
        assert lanes.max() >= 1000
