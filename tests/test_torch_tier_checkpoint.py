"""Port parity for tiered checkpoints: a save's ``__tier__`` table is the
JAX package's format. A tiered save from either framework, full or full +
incremental, restores into a fresh JAX ``Trainer`` and a fresh port
``Trainer``: device key sets, tier key sets and integer planes bit-equal
to the writer's live table, rows and payloads within 1e-6, and the two
restored trainers go on in lockstep, promoting the restored tier rows.

The stream keeps every key that a full save holds on the device out of
the incremental's tier rows: the JAX restore loads such a key twice (the
fault the port fixes, ``test_torch_tier_trainer.py``), so the restored
trainers would part there by design."""
import numpy as np
import pytest

import jax

from deeprec_tpu.checkpoint import saver as jsaver

from deeprec_tpu_torch.checkpoint import saver as tsaver

from test_torch_tier_trainer import (assert_maps, batch_with, carried,
                                     key_map, lockstep, tier_keys, trainers)

RESTORE_ATOL = 1e-6  # rows through a save: f32 written and read back


def _dense(trainer, state):
    if hasattr(trainer, "_jit_train"):
        return [np.asarray(x) for x in jax.tree_util.tree_leaves(
            (state.params, state.opt_state, state.step))]
    return tsaver._dense_leaves(trainer, state)


@pytest.mark.parametrize("incr", [False, True], ids=["full", "full+incr"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_tiered_save_restores_into_both_trainers(writer, incr, tmp_path):
    jt, tt = trainers(steps_to_live=2)
    b0 = batch_with([1, 2, 3, 4])
    js, ts = carried(jt, tt, b0)
    wt, ws = (tt, ts) if writer == "port" else (jt, js)
    mgr = (tsaver.CheckpointManager if writer == "port"
           else jsaver.CheckpointManager)(str(tmp_path))
    for b in [b0, b0] + [batch_with([100 + s], seed=s) for s in range(3)]:
        ws = wt.train_step(ws, b)
    ws = wt.maybe_demote(ws)          # 1-4, 100 and 101 leave the device
    mgr.save(wt, ws)
    if incr:                          # 200 and 201 made and demoted after
        for b in (batch_with([200], seed=5), batch_with([201], seed=6),
                  batch_with([102], seed=7), batch_with([102], seed=8)):
            ws = wt.train_step(ws, b)
        ws = wt.maybe_demote(ws)
        mgr.save_incremental(wt, ws)
    wc = wt.collections["emb"]
    live = key_map(wc, ws.tables["emb"].ev)
    assert tier_keys(wc) and wc._resolver.size

    jt2, tt2 = trainers(steps_to_live=2)
    js2, ok_j = jsaver.CheckpointManager(str(tmp_path)).restore(
        jt2, jt2.init(jax.random.key(1), b0))
    ts2, ok_t = tsaver.CheckpointManager(str(tmp_path)).restore(
        tt2, tt2.init(b0))
    assert ok_j and ok_t
    for t2, s2 in ((jt2, js2), (tt2, ts2)):
        c2 = t2.collections["emb"]
        assert int(s2.step) == int(ws.step)
        assert tier_keys(c2) == tier_keys(wc)
        assert np.array_equal(np.sort(c2._resolver.export_keys()),
                              np.sort(wc._resolver.export_keys()))
        assert_maps(key_map(c2, s2.tables["emb"].ev), live,
                    atol=RESTORE_ATOL)
        for g, r in zip(_dense(t2, s2), _dense(wt, ws)):
            np.testing.assert_allclose(g, r, rtol=0, atol=RESTORE_ATOL)

    # both restored trainers go on together, promoting what they restored
    after = [batch_with([1, 200, 102, 300], seed=20),
             batch_with([2, 100, 201], seed=21),
             batch_with([3, 300], seed=22), batch_with([4], seed=23)]
    js2, ts2, promoted = lockstep(jt2, tt2, js2, ts2, after)
    assert promoted >= (12 if incr else 8)
