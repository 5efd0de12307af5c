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


LOOKUP_CASES = {  # (readonly, planes written, add_freqs, filter_freq)
    "metadata": (False, ("create_steps", "versions"), True, 1),
    "filter3": (False, ("create_steps", "versions"), True, 3),
    "readonly": (True, ("create_steps", "versions"), True, 2),
    "no_filter": (False, ("create_steps", "versions"), True, None),
    "freqs_only": (False, (), True, None),
    "versions_only": (False, ("versions",), False, None),
    "filter_only": (False, (), False, 2),
}


def _lookup_case(seed, cap=300, u=120):
    """Lanes of one resolve: unique slots, null-row lanes (EMPTY keys and
    the overflow group) and lanes with no count; created rows get dest."""
    rng = np.random.default_rng(seed)
    uslots = rng.choice(cap, size=u, replace=False).astype(np.int32)
    uslots[rng.random(u) < 0.15] = cap
    counts = rng.integers(0, 4, u).astype(np.int32)
    created = rng.random(u) < 0.4
    planes = {"create_steps": rng.integers(-1, 5, cap + 1),
              "versions": rng.integers(-1, 5, cap + 1),
              "freqs": rng.integers(0, 4, cap + 1)}
    planes = {k: v.astype(np.int32) for k, v in planes.items()}
    planes["freqs"][cap], planes["versions"][cap] = 0, -1
    planes["create_steps"][cap] = -1
    return uslots, counts, created, planes


@pytest.mark.parametrize("case", list(LOOKUP_CASES))
def test_lookup_meta_matches_lane_loop(case):
    """K3a's path function on a CPU tensor against a lane-by-lane loop:
    readonly lanes write nothing, lanes with no count and null-row lanes
    are not live, and admission reads the freq after this step's add."""
    from deeprec_tpu_torch.ops.meta_scatter import lookup_meta
    readonly, written, add_freqs, filter_freq = LOOKUP_CASES[case]
    uslots, counts, created, planes = _lookup_case(7)
    cap, gs = planes["freqs"].shape[0] - 1, 9
    dest = np.where(created & (not readonly), uslots, cap + 1)
    dest = dest.astype(np.int32)
    expect = {k: v.copy() for k, v in planes.items()}
    for i, s in enumerate(uslots):
        if "create_steps" in written and dest[i] < cap:
            expect["create_steps"][dest[i]] = gs
        if counts[i] > 0 and s != cap and not readonly:
            if "versions" in written:
                expect["versions"][s] = gs
            if add_freqs:
                expect["freqs"][s] += counts[i]
    want = (uslots != cap) & (True if filter_freq is None
                              else expect["freqs"][uslots] >= filter_freq)
    got = {k: torch.from_numpy(v.copy()) for k, v in planes.items()}
    admitted = lookup_meta(
        torch.from_numpy(uslots), torch.from_numpy(counts),
        torch.tensor(readonly), torch.from_numpy(dest), gs, cap,
        *(got[k] if k in written else None
          for k in ("create_steps", "versions")),
        got["freqs"] if add_freqs or filter_freq is not None else None,
        add_freqs, filter_freq)
    for k in planes:
        np.testing.assert_array_equal(got[k].numpy(), expect[k], k)
    np.testing.assert_array_equal(admitted.numpy(), want)
    if case == "filter3":
        assert 0 < admitted.sum() < (uslots != cap).sum()


def test_lookup_meta_rejects_bad_input():
    from deeprec_tpu_torch.ops.meta_scatter import lookup_meta
    idx = torch.tensor([1, 2], dtype=torch.int32)
    counts = torch.ones(2, dtype=torch.int32)
    ro = torch.tensor(False)
    plane = torch.zeros(5, dtype=torch.int32)
    with pytest.raises(ValueError):  # the filter needs the freq plane
        lookup_meta(idx, counts, ro, idx, 1, 4, filter_freq=1)
    with pytest.raises(ValueError):  # a plane of another length
        lookup_meta(idx, counts, ro, idx, 1, 5, versions=plane)
    with pytest.raises(ValueError):  # dest of another dtype
        lookup_meta(idx, counts, ro, idx.long(), 1, 4, versions=plane)
