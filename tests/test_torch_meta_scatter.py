"""Port parity: the plain versions of kernels K3a (meta_scatter,
scatter_set) and K3b (blocked_rmw_set) against the JAX package's metadata
writes: the XLA scatters of ``benchmarks/pallas_meta_bench.py`` and its
Pallas kernels run in interpret mode, at that script's own interpret sizes.
On a CPU tensor the port's wrappers run exactly these plain versions; the
CUDA kernels are held to them on the card. Integer writes: bit-equal.

The JAX scatters write any index of the ``[CAP+1]`` plane, row CAP
included (the DMA kernel clamps out-of-range slots onto it); the host-index
lookup then resets row CAP, the null row, to its fill
(``host_index.py:387-395``). The port's kernel skips every slot outside
``[0, CAP)`` instead, so each JAX result is compared after that reset.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeprec_tpu_torch.ops.meta_scatter import (blocked_rmw_set,
                                                meta_scatter, scatter_set)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def bench(monkeypatch):
    """benchmarks/pallas_meta_bench.py with its --interpret settings."""
    spec = importlib.util.spec_from_file_location(
        "pallas_meta_bench", os.path.join(REPO, "benchmarks",
                                          "pallas_meta_bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for name, value in (("INTERPRET", True), ("U", 512), ("CAP", 1 << 14),
                        ("BLK", 1 << 12)):
        monkeypatch.setattr(mod, name, value)
    return mod


def _slots(bench, seed, edges):
    rng = np.random.default_rng(seed)
    slots = rng.choice(bench.CAP, size=bench.U, replace=False)
    slots[:len(edges)] = edges
    return slots.astype(np.int32)


def _reset_null(plane, fill):
    out = np.array(plane)
    out[-1] = fill
    return out


EDGES = [1 << 14, (1 << 14) + 1, (1 << 14) + 7]  # CAP, CAP+1, beyond


def test_meta_scatter_plain_matches_xla_scatters(bench):
    cap, u = bench.CAP, bench.U
    rng = np.random.default_rng(1)
    slots = _slots(bench, 2, EDGES)
    versions = rng.integers(-1, 9, cap + 1).astype(np.int32)
    freqs = rng.integers(0, 9, cap + 1).astype(np.int32)
    creates = rng.integers(-1, 9, cap + 1).astype(np.int32)
    versions[-1], freqs[-1], creates[-1] = -1, 0, -1
    inc = rng.integers(1, 5, u).astype(np.int32)
    jv, jf, jc = bench.xla_three_scatters(
        jnp.asarray(versions), jnp.asarray(freqs), jnp.asarray(creates),
        jnp.asarray(slots), jnp.int32(7), jnp.asarray(inc))
    tv, tf, tc = (torch.from_numpy(a.copy())
                  for a in (versions, freqs, creates))
    s = torch.from_numpy(slots)
    meta_scatter(tc, s, tv, tf, s, torch.from_numpy(inc), 7)
    np.testing.assert_array_equal(tv.numpy(), _reset_null(jv, -1))
    np.testing.assert_array_equal(tf.numpy(), _reset_null(jf, 0))
    np.testing.assert_array_equal(tc.numpy(), _reset_null(jc, -1))
    assert meta_scatter.launches == 0  # the CPU runs the plain version


def test_meta_scatter_planes_are_optional():
    """Absent planes are left alone; indices may be int64."""
    plane = torch.full((17,), -1, dtype=torch.int32)
    idx = torch.tensor([3, 16, 20, 5])
    meta_scatter(None, idx, None, plane,
                 idx, torch.tensor([2, 2, 2, 4], dtype=torch.int32), 9)
    expect = torch.full((17,), -1, dtype=torch.int32)
    expect[3], expect[5] = 1, 3
    assert torch.equal(plane, expect)
    with pytest.raises(ValueError):
        meta_scatter(plane, idx, None, None, idx.int(), None, 1)


def test_scatter_set_plain_matches_pallas_dma_stores(bench):
    slots = _slots(bench, 3, EDGES)
    plane = np.full((bench.CAP + 1,), -1, np.int32)
    ref = bench.pallas_dma_stores(jnp.asarray(plane), jnp.asarray(slots),
                                  jnp.full((bench.U,), 7, jnp.int32))
    got = torch.from_numpy(plane.copy())
    scatter_set(got, torch.from_numpy(slots), 7)
    np.testing.assert_array_equal(got.numpy(), _reset_null(ref, -1))


def test_blocked_rmw_set_plain_matches_pallas_blocked_rmw(bench):
    slots = _slots(bench, 4, EDGES + [-1])
    rng = np.random.default_rng(5)
    plane = rng.integers(-5, 5, bench.CAP + 1).astype(np.int32)
    vals = rng.integers(-100, 100, bench.U).astype(np.int32)
    ref = bench.pallas_blocked_rmw(jnp.asarray(plane), jnp.asarray(slots),
                                   jnp.asarray(vals))
    got = blocked_rmw_set(torch.from_numpy(plane), torch.from_numpy(slots),
                          torch.from_numpy(vals), bench.CAP)
    assert got.shape == (bench.CAP,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert blocked_rmw_set.launches == 0
