"""Port parity for the host tier's building blocks: the ``HostKV`` and
``TierStack`` stores of ``utils/native.py`` (held against the JAX
package's on the same inputs, contents compared as key-sorted maps), the
``sparse/tier_payload.py`` payload helpers and ``budget_cold_np``. The
copies are held to their sources; integer payload columns survive
bit-exactly past 2^24."""
import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import deeprec_tpu as dr
from deeprec_tpu.config import EmbeddingVariableConfig as JConfig
from deeprec_tpu.sparse import embedding_var as jev
from deeprec_tpu.sparse import tier_payload as jtp
from deeprec_tpu.utils import native as jnative

from deeprec_tpu_torch import config as tcfg
from deeprec_tpu_torch.sparse import embedding_var as tev
from deeprec_tpu_torch.sparse import tier_payload as ttp
from deeprec_tpu_torch.utils import native as tnative


def _by_key(store):
    keys, rows = store.export()
    o = np.argsort(keys)
    return keys[o], rows[o]


def _same_contents(got, ref):
    gk, gr = _by_key(got)
    rk, rr = _by_key(ref)
    np.testing.assert_array_equal(gk, rk)
    np.testing.assert_array_equal(gr.view(np.int32), rr.view(np.int32))


def test_payload_and_budget_copies_are_the_source():
    for name in ("SlotLeaf", "PayloadSpec", "spec", "_to_f32_bits",
                 "pack_np"):
        assert inspect.getsource(getattr(ttp, name)) == \
            inspect.getsource(getattr(jtp, name)), name
    assert inspect.getsource(tev.budget_cold_np) == \
        inspect.getsource(jev.budget_cold_np)


def test_port_tier_store_binds_the_port_library():
    """The port's stores run on the library the port builds from the
    shared source (its own build directory), or on the dict fallback when
    it cannot be built."""
    kv = tnative.HostKV(dim=4)
    lib = tnative.get_lib()
    assert (kv._h is not None) == (lib is not None)
    if lib is not None:
        assert str(tnative.BUILD) in lib._name


def test_hostkv_roundtrip():
    rows = np.random.default_rng(0).normal(size=(1000, 8)).astype(np.float32)
    keys = np.arange(1000, dtype=np.int64) * 7 - 100
    stores = [mod.HostKV(dim=8, capacity_hint=64) for mod in (tnative,
                                                              jnative)]
    for kv in stores:
        kv.upsert(keys, rows)
        assert len(kv) == 1000
        out, found = kv.lookup(np.concatenate([keys[::3], [999999]]))
        assert found[:-1].all() and not found[-1]
        np.testing.assert_array_equal(out[:-1], rows[::3])
        np.testing.assert_array_equal(out[-1], 0)
        kv.upsert(keys[:10], rows[:10] * 2)   # overwrite
        kv.erase(keys[500:])
        assert len(kv) == 500
        assert not kv.lookup(keys[500:])[1].any()
    _same_contents(*stores)
    k, v = stores[0].export_col(3)
    o = np.argsort(k)
    np.testing.assert_array_equal(v[o], _by_key(stores[0])[1][:, 3])


def test_hostkv_growth_and_negative_keys():
    keys = np.unique(np.random.default_rng(1).integers(
        -2**62, 2**62, size=20000, dtype=np.int64))
    rows = np.arange(keys.shape[0] * 4, dtype=np.float32).reshape(-1, 4)
    stores = [mod.HostKV(dim=4, capacity_hint=16) for mod in (tnative,
                                                              jnative)]
    for kv in stores:
        kv.upsert(keys, rows)
        out, found = kv.lookup(keys)
        assert found.all()
        np.testing.assert_array_equal(out, rows)
    _same_contents(*stores)


def _payload_rows(n, dim, rng, v0=0):
    """Rows of the tier payload: values, then freq, version and create
    step as int32 bit patterns (versions past 2^24)."""
    rows = rng.normal(size=(n, dim + 3)).astype(np.float32)
    ints = np.stack([rng.integers(0, 50, n), v0 + rng.integers(0, 1000, n),
                     rng.integers(0, 1 << 30, n)], 1).astype(np.int32)
    rows[:, dim:] = ints.view(np.float32)
    return rows


def test_tier_stack_demote_spill_promote(tmp_path):
    """DRAM -> SSD: past the DRAM budget the oldest versions spill to the
    file store; lookups read through both, an erase (promotion) takes a
    key out of both, and an upsert supersedes a spilled copy."""
    rng = np.random.default_rng(2)
    dim = 6
    stacks = [mod.TierStack(dim + 3, dim + 1, 32, str(tmp_path / f"{i}.a"))
              for i, mod in enumerate((tnative, jnative))]
    batches = [(np.arange(40 * j, 40 * j + 40, dtype=np.int64) * 11 - 7,
                _payload_rows(40, dim, rng, v0=(1 << 25) + 1000 * j))
               for j in range(3)]
    for st in stacks:
        for keys, rows in batches:
            st.upsert(keys, rows)
        assert len(st) == 120 and len(st.ssd) > 0
        assert len(st.dram) <= 32 or len(st.dram) == 120 - len(st.ssd)
    _same_contents(*stacks)
    if all(st.dram._h is not None for st in stacks):
        # the split itself only where both run the C++ store: its
        # argpartition picks among equal versions in export order
        assert len(stacks[0].ssd) == len(stacks[1].ssd)
    keys = np.concatenate([k for k, _ in batches])
    rows = np.concatenate([r for _, r in batches])
    for st in stacks:
        out, found = st.lookup(keys[::5])
        assert found.all()
        np.testing.assert_array_equal(out.view(np.int32),
                                      rows[::5].view(np.int32))
        st.erase(keys[:60])                     # promoted
        assert not st.lookup(keys[:60])[1].any() and len(st) == 60
        st.upsert(keys[100:110], rows[100:110] * 0)   # demoted again
        out, _ = st.lookup(keys[100:110])
        assert not out.any() and len(st) == 60
    _same_contents(*stacks)


def test_tier_export_import_roundtrip(tmp_path):
    """Export one store into a new one (the checkpoint's path): the same
    keys and bit-exact rows, from the DRAM and the SSD part alike."""
    rng = np.random.default_rng(3)
    src = tnative.TierStack(9, 7, 16, str(tmp_path / "a.arena"))
    keys = rng.permutation(1 << 20)[:100].astype(np.int64) - 5000
    src.upsert(keys, _payload_rows(100, 6, rng, v0=1 << 26))
    ek, er = src.export()
    for dst in (tnative.HostKV(9), jnative.HostKV(9),
                tnative.TierStack(9, 7, 16, str(tmp_path / "b.arena"))):
        dst.upsert(ek, er)
        _same_contents(dst, src)


def _slot_trees(cap1):
    """The same slot state as torch and as jax arrays: a dict of a
    row-shaped float leaf, a row-shaped int leaf of rank 3 and a scalar."""
    rng = np.random.default_rng(4)
    leaves = {"acc": rng.normal(size=(cap1, 4)).astype(np.float32),
              "last": rng.integers(0, 1 << 28, (cap1, 2, 2)).astype(np.int32),
              "step": np.asarray(7, np.int32)}
    return ({k: torch.from_numpy(v) for k, v in leaves.items()},
            {k: jnp.asarray(v) for k, v in leaves.items()}, leaves)


def test_payload_pack_and_unpack_match_jax():
    cap1, dim = 33, 8
    tslot, jslot, np_leaves = _slot_trees(cap1)
    ts, js = ttp.spec(dim, tslot, cap1), jtp.spec(dim, jslot, cap1)
    assert ts.width == js.width == dim + 3 + 4 + 4
    assert [(s.index, s.width, s.shape) for s in ts.slot_rows] == \
        [(s.index, s.width, s.shape) for s in js.slot_rows]
    rng = np.random.default_rng(5)
    idx = rng.permutation(cap1)[:20]
    values = rng.normal(size=(cap1, dim)).astype(np.float32)
    planes = [rng.integers(0, 1 << 30, cap1).astype(np.int32)
              for _ in range(3)]
    planes[1][:5] = (1 << 24) + np.arange(5)   # versions past 2^24
    flat = [np_leaves[k] for k in sorted(np_leaves)]
    got = ttp.pack_np(ts, idx, values, *planes, flat)
    ref = jtp.pack_np(js, idx, values, *planes, flat)
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    # the torch inverse: integer columns bit-cast back, exactly
    t = torch.from_numpy(got)
    for c, plane in zip(range(dim, dim + 3), planes):
        back = ttp._from_f32_bits(t[:, c], torch.int32)
        np.testing.assert_array_equal(back.numpy(), plane[idx])
        np.testing.assert_array_equal(
            back.numpy(), np.asarray(jtp._from_f32_bits(jnp.asarray(got[:, c]),
                                                        jnp.int32)))
    o = dim + 3
    for s in ts.slot_rows:
        part = ttp._from_f32_bits(t[:, o:o + s.width], s.dtype)
        np.testing.assert_array_equal(
            part.reshape((-1,) + s.shape).numpy(), flat[s.index][idx])
        o += s.width
    assert torch.equal(ttp.to_f32_bits(torch.from_numpy(planes[1])),
                       torch.from_numpy(planes[1].view(np.float32)))


@pytest.mark.parametrize("budget", [0, 5, 40, 1000])
def test_budget_cold_np_matches_jax(budget):
    rng = np.random.default_rng(budget)
    n = 64
    versions = rng.integers(0, 6, n).astype(np.int32)   # ties on versions
    freqs = rng.integers(0, 4, n).astype(np.int32)
    occupied = rng.random(n) < 0.9
    ev = dict(name="t", embedding_dim=4, capacity=n)
    tc = tcfg.EmbeddingVariableConfig(**ev, evict=tcfg.GlobalStepEvict(3))
    jc = JConfig(**ev, evict=dr.GlobalStepEvict(3))
    tcold = tev.cold_mask_np(tc, None, versions, occupied, 7)
    jcold = jev.cold_mask_np(jc, None, versions, occupied, 7)
    np.testing.assert_array_equal(tcold, jcold)
    got = tev.budget_cold_np(tc, versions, freqs, occupied, tcold, budget)
    ref = jev.budget_cold_np(jc, versions, freqs, occupied, jcold, budget)
    np.testing.assert_array_equal(got, ref)
    if budget:
        assert int((occupied & ~got).sum()) <= budget
