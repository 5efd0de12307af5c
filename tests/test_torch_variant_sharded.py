"""Port parity of the variant collections on the mesh: the port's
``ShardedTrainer`` on gloo ranks (``tests/torch_mesh_worker.py``) against
the JAX ``ShardedTrainer`` on a virtual CPU mesh of the same size, from
the same numpy batches, the JAX init's weights and its random table draws
(multi-hash sub-tables, the adaptive static table), at the JAX tests'
small size (4 Criteo columns at dim 8, DCN with one cross layer).

- Each collection in lockstep at 2 ranks (multi-hash: replicated tables,
  all-gathered update; adaptive: the owner's EV half and warm seeding,
  the replicated static table's summed gradient; hash table: per-rank id
  spaces behind a CBF gate; dynamic dimension: the owner's block mask):
  every step's loss within LOSS_ATOL; the saved state (each rank's part of
  the save format against the JAX collection's whole save) per key:
  freqs, versions and CBF counters bit-equal, rows and slot rows within
  ROW_ATOL.
- Saves at 2 ranks restore at 1 (the one-device ``Trainer``) and into the
  JAX trainer at 4 shards with every key's state intact.
- The hash table's growth under load, as the JAX mesh grows it.
"""
import jax
import numpy as np
import pytest
import torch

from deeprec_tpu.checkpoint.saver import CheckpointManager as JCkpt

import torch_mesh_worker as W
from test_torch_mesh import (CAT_NAMES, DENSE_NAMES, batches, jax_init,
                             jax_train, jax_trainer)

torch.set_num_threads(1)

LOSS_ATOL = 1e-5   # per-step loss: f32 sums in another order
ROW_ATOL = 2e-5    # rows and slot rows after the steps
KINDS = ["multihash", "adaptive", "hashtable", "dyndim"]
B, STEPS = 64, 4


def spec_of(kind, capacity=1 << 9):
    """The hash table adds a 3-wide mean column, where a key the owner
    did not admit must leave the mean (its validity travels back)."""
    cols = [(n, 1, "sum") for n in CAT_NAMES[:4]]
    if kind == "hashtable":
        cols.append(("M1", 3, "mean"))
    return dict(engine=kind, model="dcn", dim=8, capacity=capacity,
                cols=cols, numeric=list(DENSE_NAMES[:3]))


def draws(js):
    """The JAX init's random table draws, for the ranks to carry."""
    e = js.tables["emb"].ev
    if hasattr(e, "tables"):
        return {"mh_tables": [np.asarray(t) for t in e.tables]}
    if hasattr(e, "static"):
        return {"static": np.asarray(e.static)}
    return {}


def merged_arrays(parts):
    """Every rank's part of the save format as one table (rows
    concatenated, the rest from the first part that has it)."""
    out = {}
    n = [p["keys"].shape[0] if "keys" in p else None for p in parts]
    for p, nk in zip(parts, n):
        for k, v in p.items():
            v = np.asarray(v)
            if nk is not None and v.ndim and v.shape[0] == nk \
                    and not k.startswith(("cbf", "static__")):
                out.setdefault(k, []).append(v)
            elif k not in out:
                out[k] = v
    return {k: np.concatenate(v) if isinstance(v, list) else v
            for k, v in out.items()}


def assert_same_tables(got, want):
    """Two saves of one table: the same keys, per key the same integer
    state and rows within ROW_ATOL; dense leaves and the static table
    within ROW_ATOL; CBF counters bit-equal (the ranks' blocks in rank
    order against the JAX stacked sketch)."""
    if "keys" in want:
        go, wo = np.argsort(got["keys"]), np.argsort(want["keys"])
        np.testing.assert_array_equal(got["keys"][go], want["keys"][wo])
        assert len(wo) > 0
        for k in want:
            w = np.asarray(want[k])
            if k == "keys" or not w.ndim or w.shape[0] != len(wo) \
                    or k.startswith("static__"):
                continue
            g = np.asarray(got[k])[go]
            if w.dtype.kind in "iu":
                np.testing.assert_array_equal(g, w[wo], err_msg=k)
            else:
                np.testing.assert_allclose(g, w[wo], rtol=0, atol=ROW_ATOL,
                                           err_msg=k)
    for k in want:
        if k.startswith(("leaf__", "static__")):
            np.testing.assert_allclose(np.asarray(got[k]), want[k], rtol=0,
                                       atol=ROW_ATOL, err_msg=k)
    if "cbf" in want:
        blocks = sorted(k for k in got if k.startswith("cbf__shard"))
        sketch = np.concatenate([got[k] for k in blocks]) if blocks \
            else got["cbf"]
        np.testing.assert_array_equal(sketch, want["cbf"])


def lockstep(kind, S, tmp_path, bs, grow=False, capacity=1 << 9):
    spec = spec_of(kind, capacity)
    jt = jax_trainer(spec, S)
    js, dense = jax_init(jt, bs[0])
    ranks = W.run_ranks("train", dict(spec=spec, batches=bs, dense=dense,
                                      grow=grow, arrays=True, **draws(js)),
                        S, str(tmp_path / "ranks"))
    js, jlosses, jcaps = jax_train(jt, js, bs, grow)
    for r in ranks:
        np.testing.assert_allclose(r["losses"], jlosses, rtol=0,
                                   atol=LOSS_ATOL)
        assert r["caps"] == jcaps
    jarr = jt.collections["emb"].ckpt_arrays(js.tables["emb"], S, None,
                                             False, int(js.step))
    got = merged_arrays([r["arrays"] for r in ranks])
    if kind == "multihash":  # replicated: every rank holds the same tables
        for r in ranks[1:]:
            for k, v in r["arrays"].items():
                np.testing.assert_array_equal(v, ranks[0]["arrays"][k])
    assert_same_tables(got, {k: np.asarray(v) for k, v in jarr.items()})
    return jt, js, ranks


@pytest.mark.parametrize("kind", KINDS)
def test_variant_step_matches_jax_at_two_ranks(kind, tmp_path):
    lockstep(kind, 2, tmp_path, batches(21, STEPS))


@pytest.mark.parametrize("kind", KINDS)
def test_variant_save_at_two_ranks_restores_everywhere(kind, tmp_path):
    """A 2-rank save restores into the port's one-device ``Trainer`` and
    into the JAX mesh trainer at 4 shards: the same saved state."""
    spec = spec_of(kind)
    bs = batches(22, STEPS)
    jt = jax_trainer(spec, 2)
    js, dense = jax_init(jt, bs[0])
    ckpt = str(tmp_path / "ckpt")
    ranks = W.run_ranks("train", dict(spec=spec, batches=bs, dense=dense,
                                      ckpt=ckpt, saves={STEPS - 1: "full"},
                                      arrays=True, **draws(js)),
                        2, str(tmp_path / "r"))
    saved = merged_arrays([r["arrays"] for r in ranks])
    # the port, one device
    tr = W.build(spec)
    from deeprec_tpu_torch.checkpoint import CheckpointManager
    st, ok = CheckpointManager(ckpt).restore(tr, tr.init(bs[0]))
    assert ok and st.step == STEPS
    one = tr.collections["emb"].ckpt_arrays(st.tables["emb"], 1, None,
                                            False, STEPS)
    assert_same_tables({k: np.asarray(v) for k, v in one.items()}, saved)
    # the JAX mesh trainer at 4 shards
    j4 = jax_trainer(spec, 4)
    s4 = j4.init(jax.random.key(1), bs[0])
    s4, ok = JCkpt(ckpt).restore(j4, s4)
    assert ok and int(s4.step) == STEPS
    jarr = j4.collections["emb"].ckpt_arrays(s4.tables["emb"], 4, None,
                                             False, STEPS)
    jarr = {k: np.asarray(v) for k, v in jarr.items()}
    if "cbf" in jarr:  # JAX resums the blocks at another shard count
        jarr.pop("cbf")
    assert_same_tables(saved, jarr)


def test_hashtable_grow_under_load_matches_jax(tmp_path):
    """Every rank's hash table doubles at the step the JAX mesh's does;
    ids and rows survive, the state stays the JAX state."""
    _, _, ranks = lockstep("hashtable", 2, tmp_path,
                           batches(23, 4, vocab=400),
                           grow=True, capacity=64)
    assert ranks[0]["caps"][-1] > 64
