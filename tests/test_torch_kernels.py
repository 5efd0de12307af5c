"""Port parity: the plain PyTorch versions of kernels K1 (row gather) and
K2 (gather+pool) against the Pallas TPU kernels, run on the CPU in
interpret mode as tests/test_pallas_*.py run them, and K2's gradient
against jax.vjp of the JAX collection's pooling. On a CPU tensor the
port's wrappers run exactly these plain versions; the CUDA kernels are
compared with them on the card (tests/test_torch_kernels_cuda.py,
chip_smoke.py)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeprec_tpu import feature_column as jfc
from deeprec_tpu.ops.pallas_fused_lookup import fused_pooled_lookup as jfused
from deeprec_tpu.ops.pallas_gather import gather_rows as jgather

from deeprec_tpu_torch import feature_column as tfc
from deeprec_tpu_torch.ops.fused_lookup import (
    fused_pooled_lookup, fused_pooled_lookup_backward,
    fused_pooled_lookup_plain)
from deeprec_tpu_torch.ops.gather import gather_rows, gather_rows_plain

torch.set_num_threads(1)


@pytest.mark.parametrize("d", [16, 128])
def test_gather_rows_matches_pallas(d):
    rng = np.random.default_rng(d)
    r = 512
    vals = rng.normal(size=(r, d)).astype(np.float32)
    # out-of-range slots on both sides are clamped to [0, R-1]
    slots = np.concatenate([rng.integers(0, r, 600), [-5, -1, r, r + 9999]])
    slots = slots.astype(np.int32)
    ref = np.asarray(jgather(jnp.asarray(vals), jnp.asarray(slots)))
    got = gather_rows(torch.from_numpy(vals), torch.from_numpy(slots))
    np.testing.assert_array_equal(got.numpy(), ref)  # a copy: atol=0
    got64 = gather_rows(torch.from_numpy(vals),
                        torch.from_numpy(slots.astype(np.int64)))
    np.testing.assert_array_equal(got64.numpy(), ref)


def test_gather_rows_strided_values():
    """Fused-width table [R, 32]: fetching the first 16 columns equals the
    Pallas gather of the sliced table."""
    rng = np.random.default_rng(1)
    table = rng.normal(size=(256, 32)).astype(np.float32)
    slots = rng.integers(-3, 260, 300).astype(np.int32)
    ref = np.asarray(jgather(jnp.asarray(table[:, :16]), jnp.asarray(slots)))
    got = gather_rows(torch.from_numpy(table), torch.from_numpy(slots), 16)
    np.testing.assert_array_equal(got.numpy(), ref)
    view = torch.from_numpy(table)[:, :16]  # a strided view works too
    np.testing.assert_array_equal(gather_rows(view, torch.from_numpy(slots))
                                  .numpy(), ref)


@pytest.mark.parametrize("bad", ["d_out", "slots_dtype", "values_2d"])
def test_gather_rows_rejects_bad_input(bad):
    vals = torch.zeros(8, 4)
    slots = torch.zeros(3, dtype=torch.int64)
    with pytest.raises(ValueError):
        if bad == "d_out":
            gather_rows(vals, slots, 5)
        elif bad == "slots_dtype":
            gather_rows(vals, slots.float())
        else:
            gather_rows(vals[None], slots)


def _bags(rng, r, b, w, p_valid):
    slots = rng.integers(-2, r + 2, size=(b, w)).astype(np.int32)
    valid = rng.random((b, w)) < p_valid
    valid[0] = False  # an all-invalid bag
    return slots, valid


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
def test_fused_pooled_lookup_matches_pallas(combiner):
    rng = np.random.default_rng(7)
    r, d, b, w = 512, 128, 96, 20
    vals = rng.normal(size=(r, d)).astype(np.float32)
    slots, valid = _bags(rng, r, b, w, 0.6)
    ref = np.asarray(jfused(jnp.asarray(vals), jnp.asarray(slots),
                            jnp.asarray(valid), combiner=combiner))
    got = fused_pooled_lookup(torch.from_numpy(vals), torch.from_numpy(slots),
                              torch.from_numpy(valid), combiner)
    # f32 sums of up to 20 rows in another order
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got.numpy()[0], 0.0)


def test_fused_pooled_lookup_strided_inputs():
    """Fused-width values [R, 256] read as [R, 128], and slots/valid given
    as transposed views (the serving path's inverse.view(W, B)[o:o+w].T)."""
    rng = np.random.default_rng(9)
    r, b, w = 256, 40, 5
    table = rng.normal(size=(r, 256)).astype(np.float32)
    slots, valid = _bags(rng, r, b, w, 0.7)
    ref = np.asarray(jfused(jnp.asarray(table[:, :128]), jnp.asarray(slots),
                            jnp.asarray(valid), combiner="mean"))
    got = fused_pooled_lookup(torch.from_numpy(table)[:, :128],
                              torch.from_numpy(slots.T.copy()).T,
                              torch.from_numpy(valid.T.copy()).T, "mean")
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_fused_pooled_lookup_unknown_combiner():
    vals = torch.zeros(8, 128)
    slots = torch.zeros(2, 3, dtype=torch.int64)
    valid = torch.ones(2, 3, dtype=torch.bool)
    with pytest.raises(ValueError):
        fused_pooled_lookup(vals, slots, valid, "Sum")
    with pytest.raises(ValueError):
        jfused(jnp.zeros((8, 128)), jnp.zeros((2, 3), jnp.int32),
               jnp.ones((2, 3), bool), combiner="Sum")


def test_plain_versions_are_what_cpu_tensors_run():
    rng = np.random.default_rng(4)
    vals = torch.from_numpy(rng.normal(size=(64, 16)).astype(np.float32))
    slots = torch.from_numpy(rng.integers(0, 64, (10, 3)))
    valid = torch.from_numpy(rng.random((10, 3)) < 0.5)
    assert torch.equal(gather_rows(vals, slots[:, 0], 8),
                       gather_rows_plain(vals, slots[:, 0], 8))
    assert torch.equal(fused_pooled_lookup(vals, slots, valid, "sqrtn"),
                       fused_pooled_lookup_plain(vals, slots, valid, "sqrtn"))
    assert gather_rows.launches == 0 and fused_pooled_lookup.launches == 0
    assert fused_pooled_lookup_backward.launches == 0


def _columns(mod, combiner):
    cat = mod.CategoricalColumn
    return [mod.EmbeddingColumn(cat("a"), 16),
            mod.EmbeddingColumn(cat("m", max_length=5), 16,
                                combiner=combiner),
            mod.EmbeddingColumn(cat("b"), 16),
            mod.EmbeddingColumn(cat("c"), 16)]


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
def test_pooling_gradient_matches_jax_vjp(combiner):
    """d(pooled)/d(urows) through K2's autograd (its backward's plain
    version here) equals jax.vjp of the JAX collection's pooling of
    ``urows[inverse]``, with invalid lanes and an all-invalid bag."""
    rng = np.random.default_rng(11)
    b, u = 64, 200
    jcoll = jfc.EmbeddingCollection(_columns(jfc, combiner), capacity=1024)
    tcoll = tfc.EmbeddingCollection(_columns(tfc, combiner), capacity=1024)
    width = jcoll.total_width
    urows = rng.normal(size=(u, 16)).astype(np.float32)
    inverse = rng.integers(0, u, width * b).astype(np.int32)
    valid = rng.random(width * b) < 0.7
    valid[b:6 * b:b] = False  # bag 0 of the multi-hot column (rows 1-5)
    cots = {c.name: rng.normal(size=(b, 16)).astype(np.float32)
            for c in jcoll.columns}

    def pool(r):
        return jcoll.embeddings_from_rows(r[jnp.asarray(inverse)],
                                          jnp.asarray(valid))

    ref_out, vjp = jax.vjp(pool, jnp.asarray(urows))
    (ref_grad,) = vjp({k: jnp.asarray(v) for k, v in cots.items()})

    tr = torch.from_numpy(urows).requires_grad_(True)
    out = tcoll.embeddings_from_rows(tr, torch.from_numpy(inverse),
                                     torch.from_numpy(valid))
    sum((out[k] * torch.from_numpy(v)).sum() for k, v in cots.items()
        ).backward()
    for k in cots:  # f32 sums of up to 5 rows in another order
        np.testing.assert_allclose(out[k].detach().numpy(),
                                   np.asarray(ref_out[k]), rtol=1e-5,
                                   atol=1e-6)
    # each row's gradient sums ~70 scaled cotangent lanes in another
    # order than XLA's scatter-add
    np.testing.assert_allclose(tr.grad.numpy(), np.asarray(ref_grad),
                               rtol=1e-5, atol=1e-6)
    assert fused_pooled_lookup_backward.launches == 0
