"""Port parity for host-index tiered storage: the collection and the
trainer. A port ``Trainer`` and a JAX ``Trainer`` over tiered host-index
tables (``StorageOption(HBM_DRAM)`` or ``HBM_DRAM_SSD``), with the same
weights, step the same batches with the same demotion cadence: the wires
and their promo lanes are bit-equal every step, and at every fence the
key -> (row, freq, version, create step) map across both tiers matches
(integers bit-equal, rows within ROW_ATOL). Tier contents are compared as
key-sorted maps: the JAX side may run on its dict-fallback store and its
Python resolver (one hash group keeps their slot order the C++ one's).

Also the two faults of the JAX package that the port fixes: a tiered
restore leaves a key in one tier only, and a save that fails keeps the
tier's since-save window.

The helpers here are shared by the other ``test_torch_tier_*`` files."""
import os
import tempfile

import numpy as np
import pytest
import torch

import jax
import optax

import deeprec_tpu as dr
from deeprec_tpu import feature_column as jfc
from deeprec_tpu.data.criteo import SyntheticCriteo
from deeprec_tpu.host_index import HostIndexEmbeddingCollection as JHost
from deeprec_tpu.models import ctr as jctr
from deeprec_tpu.optim import sparse as jsopt
from deeprec_tpu.train.trainer import Trainer as JTrainer

from deeprec_tpu_torch import config as tcfg
from deeprec_tpu_torch import feature_column as tfc
from deeprec_tpu_torch.checkpoint import format as tformat
from deeprec_tpu_torch.checkpoint import saver as tsaver
from deeprec_tpu_torch.host_index import HostIndexEmbeddingCollection as THost
from deeprec_tpu_torch.models import ctr as tctr
from deeprec_tpu_torch.optim import dense as tdense
from deeprec_tpu_torch.optim import sparse as tsopt
from deeprec_tpu_torch.train.trainer import Trainer as TTrainer

torch.set_num_threads(1)

CATS = ["C1", "C2"]
DIM, CAP = 8, 256
ROW_ATOL = 1e-5    # rows and payload floats: f32 sums in another order
LOSS_ATOL = 1e-4   # per-step loss


def _kw(mod, steps_to_live, hbm_capacity, storage, ssd_path,
        counter_filter, value_dtype):
    kw = dict(name="emb", capacity=CAP, n_groups=1, fused_slot_columns=DIM,
              fused_slot_init=0.1, value_dtype=value_dtype,
              initializer=mod.Initializer("normal", scale=0.1),
              storage=mod.StorageOption(
                  storage_type=getattr(mod.StorageType, storage),
                  hbm_capacity=hbm_capacity, ssd_path=ssd_path,
                  dram_row_budget=8 if ssd_path else 0))
    if steps_to_live:
        kw["evict"] = mod.GlobalStepEvict(steps_to_live=steps_to_live)
    if counter_filter:
        kw["counter_filter"] = mod.CounterFilter(counter_filter)
    return kw


def colls(steps_to_live=4, hbm_capacity=0, storage="HBM_DRAM", ssd_dir=None,
          counter_filter=None, value_dtype="float32"):
    """A JAX and a port tiered collection of the same configuration (their
    SSD arenas, if any, in two files of ``ssd_dir``)."""
    out = []
    for mod, host, fc, side in ((dr, JHost, jfc, "jax"),
                                (tcfg, THost, tfc, "port")):
        ssd = str(ssd_dir / f"{side}.arena") if ssd_dir else ""
        out.append(host([fc.EmbeddingColumn(fc.CategoricalColumn(n), DIM)
                         for n in CATS],
                        **_kw(mod, steps_to_live, hbm_capacity, storage, ssd,
                              counter_filter, value_dtype)))
    return out


def trainers(**kw):
    """A JAX and a port Trainer (DLRM, fused sparse Adagrad, dense Adagrad)
    over :func:`colls`; the port model takes the flax init at ``init``."""
    jc, tc = colls(**kw)
    jt = JTrainer(model=jctr.DLRM(emb_names=CATS, emb_dim=DIM,
                                  bottom_units=(16,), top_units=(16,)),
                  numeric_columns=[jfc.NumericColumn("I1")],
                  collections={"emb": jc},
                  sparse_optimizers={"emb": jsopt.sparse_adagrad_fused(0.1)},
                  dense_optimizer=optax.adagrad(0.05))
    tt = TTrainer(tctr.DLRM(CATS, DIM, bottom_units=(16,), top_units=(16,),
                            dense_dim=1),
                  [tfc.NumericColumn("I1")], {"emb": tc},
                  {"emb": tsopt.sparse_adagrad_fused(0.1)},
                  tdense.Adagrad(0.05), device="cpu")
    return jt, tt


def port_trainer(**kw):
    return trainers(**kw)[1]


def carried(jt, tt, batch):
    """Both trainers initialised with the same weights (the flax init)."""
    js, ts = jt.init(jax.random.key(0), batch), tt.init(batch)
    tctr.load_flax_params(tt.model, [np.asarray(x) for x in
                                     jax.tree_util.tree_leaves(js.params)])
    ts = ts._replace(opt_state=tt.dense_optimizer.load_flax_state(
        tt.model, [np.asarray(x)
                   for x in jax.tree_util.tree_leaves(js.opt_state)]))
    return js, ts


def batch_with(ids, bs=8, seed=0):
    rng = np.random.default_rng(seed)
    b = {"label": rng.integers(0, 2, bs).astype(np.float32),
         "I1": rng.normal(size=bs).astype(np.float32)}
    for n in CATS:
        b[n] = np.resize(np.asarray(ids, np.int64), bs)
    return b


def stream(n, seed=5, bs=64, vocab=64):
    gen = SyntheticCriteo(batch_size=bs, vocab_sizes=[vocab] * 26, seed=seed,
                          active_features=range(2))
    return [{k: v for k, v in b.items() if k in ("label", "I1", *CATS)}
            for b in gen.take(n)]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.kind == "V" or \
        x.dtype.name == "bfloat16" else x


def key_map(coll, ev):
    """key -> (value row incl. the fused accumulator, freq, version,
    create step) across the device stores and the host tier; asserts that
    no key is in both."""
    n = coll._resolver.size
    keys = coll._resolver.export_keys()
    planes = [_np(getattr(ev, f))[:n] for f in ("values", "freqs",
                                                 "versions", "create_steps")]
    out = {int(k): (planes[0][i].astype(np.float32), int(planes[1][i]),
                    int(planes[2][i]), int(planes[3][i]))
           for i, k in enumerate(keys)}
    if coll.tier_store is not None and len(coll.tier_store):
        w = coll.config.embedding_dim + coll.config.fused_slot_columns
        tk, rows = coll.tier_store.export()
        bits = rows[:, w:w + 3].copy().view(np.int32)
        for k, row, b in zip(tk.tolist(), rows, bits):
            assert k not in out, f"key {k} is on the device and in the tier"
            out[k] = (row[:w], int(b[0]), int(b[1]), int(b[2]))
    return out


def tier_keys(coll):
    if coll.tier_store is None or not len(coll.tier_store):
        return set()
    return set(coll.tier_store.export()[0].tolist())


def assert_maps(got, ref, atol=ROW_ATOL):
    assert set(got) == set(ref), (len(got), len(ref))
    for k, (gv, *gi) in got.items():
        rv, *ri = ref[k]
        assert gi == ri, (k, gi, ri)
        np.testing.assert_allclose(gv, rv, rtol=0, atol=atol,
                                   err_msg=f"key {k}")


def step(trainer, state, batch):
    """One train step: (state, wire bytes, promo (lanes, payload) or None,
    mean loss)."""
    d, c, lab = trainer.prepare_batch(batch)
    jaxy = isinstance(trainer, JTrainer)
    before = float(state.metrics.loss_sum)
    state = (trainer._jit_train if jaxy else trainer._train_step)(
        state, d, c, lab)
    w = c["emb"]
    promo = None
    if w.promo is not None:
        lanes, payload = (_np(t) for t in w.promo)
        real = lanes < w.u  # the JAX package pads lanes to a power of two
        promo = lanes[real], payload[real]
    loss = (float(state.metrics.loss_sum) - before) / len(batch["label"])
    return state, _np(w.buf).tobytes(), promo, loss


def assert_same_promo(got, ref, width):
    assert (got is None) == (ref is None)
    if got is None:
        return
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1][:, width:width + 3].view(np.int32),
                                  ref[1][:, width:width + 3].view(np.int32))
    np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=ROW_ATOL)


def lockstep(jt, tt, js, ts, batches, demote_every=4):
    """Step both trainers, demoting every ``demote_every`` steps (never at
    0); holds the wires, promo planes, losses and (at each fence) the
    tiered maps. Returns the states and the promoted lane count."""
    width = DIM * 2
    promoted = 0
    for i, b in enumerate(batches):
        js, jw, jp, jl = step(jt, js, b)
        ts, tw, tp, tl = step(tt, ts, b)
        assert jw == tw, f"wires differ at step {i}"
        assert_same_promo(tp, jp, width)
        promoted += 0 if tp is None else tp[0].shape[0]
        assert abs(jl - tl) <= LOSS_ATOL, (i, jl, tl)
        if demote_every and i % demote_every == demote_every - 1:
            js, ts = jt.maybe_demote(js), tt.maybe_demote(ts)
            assert_maps(key_map(tt.collections["emb"], ts.tables["emb"].ev),
                        key_map(jt.collections["emb"], js.tables["emb"].ev))
    return js, ts, promoted


def test_trainer_matches_jax_across_tiers():
    """A SyntheticCriteo stream with demotion every 4 steps: rows leave
    for the tier at every fence and come back through the wire."""
    batches = stream(16)
    jt, tt = trainers(steps_to_live=4)
    js, ts = carried(jt, tt, batches[0])
    js, ts, promoted = lockstep(jt, tt, js, ts, batches)
    assert tt.host_tier_rows("emb") > 0 and promoted > 0
    assert tt.host_tier_rows("emb") == jt.host_tier_rows("emb")
    assert set(tt.tiers) == {"emb"}


def test_demote_then_promote_roundtrip():
    """Rows demote to the tier (the resolver compacts) and a re-touch
    promotes them back through the wire: exact value, freq, version and
    accumulator; the version is stamped again on top of the restored row
    and the accumulator grows from its restored value."""
    jt, tt = trainers(steps_to_live=3)
    b0 = batch_with([1, 2, 3, 4])
    js, ts = carried(jt, tt, b0)
    batches = [b0] + [batch_with([100 + s], seed=s) for s in range(4)]
    js, ts, _ = lockstep(jt, tt, js, ts, batches, demote_every=5)
    coll = tt.collections["emb"]
    # at step 5, cold = version <= 2: ids 1-4, 100, 101 of two columns
    assert tt.host_tier_rows("emb") == 12 and coll._resolver.size == 4
    before, tier = key_map(coll, ts.tables["emb"].ev), tier_keys(coll)
    js, ts, promoted = lockstep(jt, tt, js, ts,
                                [batch_with([1, 2, 3, 4], seed=9)],
                                demote_every=0)
    assert promoted == 8 and tt.host_tier_rows("emb") == 4
    after = key_map(coll, ts.tables["emb"].ev)
    back = tier - tier_keys(coll)
    assert len(back) == 8
    for k in back:
        assert after[k][2] > before[k][2]
        assert np.all(after[k][0][DIM:] >= before[k][0][DIM:] - 1e-7)


def test_budget_demotion_hbm_capacity():
    """``hbm_capacity`` demotes the least recently touched rows past the
    budget with no eviction policy."""
    jt, tt = trainers(steps_to_live=0, hbm_capacity=6)
    b0 = batch_with([1, 2, 3, 4])
    js, ts = carried(jt, tt, b0)
    js, ts, _ = lockstep(jt, tt, js, ts,
                         [b0, batch_with([10, 11, 12, 13], seed=1)],
                         demote_every=2)
    coll = tt.collections["emb"]
    assert coll._resolver.size <= 6
    assert tt.host_tier_rows("emb") == 16 - coll._resolver.size


def test_ssd_cascade(tmp_path):
    """HBM_DRAM_SSD: the DRAM part spills its oldest rows to the file
    store; promotion reads through both."""
    jt, tt = trainers(steps_to_live=2, storage="HBM_DRAM_SSD",
                      ssd_dir=tmp_path)
    b0 = batch_with(list(range(1, 9)))
    js, ts = carried(jt, tt, b0)
    batches = [b0] + [batch_with([50 + s], seed=s) for s in range(3)]
    js, ts, _ = lockstep(jt, tt, js, ts, batches)
    coll = tt.collections["emb"]
    demoted = tt.host_tier_rows("emb")
    assert demoted >= 16 and len(coll.tier_store.ssd) > 0
    assert coll.tier_store.ssd.path == str(tmp_path / "port.arena")
    js, ts, promoted = lockstep(jt, tt, js, ts,
                                [batch_with(list(range(1, 9)), seed=7)],
                                demote_every=0)
    assert promoted == 16 and tt.host_tier_rows("emb") <= demoted - 16


def test_counter_filter_with_tier():
    """CounterFilter with a tier: the payload carries the freq, so a
    returning key keeps its admission."""
    jt, tt = trainers(steps_to_live=2, counter_filter=2)
    b0 = batch_with([1, 1, 2, 2])
    js, ts = carried(jt, tt, b0)
    batches = [b0] + [batch_with([90 + s], seed=s) for s in range(3)]
    js, ts, _ = lockstep(jt, tt, js, ts, batches)
    m0 = key_map(tt.collections["emb"], ts.tables["emb"].ev)
    assert tt.host_tier_rows("emb") > 0
    js, ts, promoted = lockstep(jt, tt, js, ts, [batch_with([1, 2], seed=5)],
                                demote_every=0)
    assert promoted > 0
    m1 = key_map(tt.collections["emb"], ts.tables["emb"].ev)
    for k in m0:
        assert m1[k][1] >= m0[k][1]


def test_cbf_with_tier_raises():
    with pytest.raises(NotImplementedError):
        THost([tfc.EmbeddingColumn(tfc.CategoricalColumn("C1"), DIM)],
              cbf_filter=tcfg.CBFFilter(2),
              storage=tcfg.StorageOption(tcfg.StorageType.HBM_DRAM))


def test_readonly_resolve_reads_through_the_tier():
    """An eval lookup of a demoted key reads its tier row and leaves the
    tier and the resolver as they were; eval steps agree with JAX."""
    from deeprec_tpu.train import metrics as jm
    from deeprec_tpu_torch.train import metrics as tm
    batches = stream(8)
    jt, tt = trainers(steps_to_live=4)
    js, ts = carried(jt, tt, batches[0])
    js, ts, _ = lockstep(jt, tt, js, ts, batches)
    coll = tt.collections["emb"]
    n, tier = coll._resolver.size, tier_keys(coll)
    assert tier
    tk, trows = coll.tier_store.export()
    probe = coll.pack_ids_eval(np.asarray([[tk[0]]], np.int64), "cpu")
    aux, rows = coll.readonly_rows(ts.tables["emb"].ev, probe)
    lane = int(aux.ev_aux.uniq.inverse[0])
    np.testing.assert_array_equal(rows[lane].numpy(), trows[0, :DIM])
    assert bool(aux.ev_aux.admitted[lane])
    for b in stream(2, seed=77):
        mj = jt.eval_step(js, jm.create(), b)
        mt = tt.eval_step(ts, tm.create(device="cpu"), b)
        np.testing.assert_allclose(float(mt.loss_sum), float(mj.loss_sum),
                                   rtol=1e-5)
    assert coll._resolver.size == n and tier_keys(coll) == tier


def test_bf16_tier_demote_promote_roundtrip():
    """A bfloat16 table demotes and promotes with exact bits (the payload
    is f32, and bf16 -> f32 -> bf16 is lossless), as the JAX package's
    does."""
    batches = stream(9)
    jt, tt = trainers(steps_to_live=3, value_dtype="bfloat16")
    js, ts = carried(jt, tt, batches[0])
    coll = tt.collections["emb"]
    promoted = 0
    for i, b in enumerate(batches):
        ts, tw, tp, _ = step(tt, ts, b)
        js, jw, jp, _ = step(jt, js, b)
        assert tw == jw
        promoted += 0 if tp is None else tp[0].shape[0]
        if i % 3 == 2:
            # the bits a demotion sends to the tier come back unchanged
            ev = ts.tables["emb"].ev
            keys = coll._resolver.export_keys()
            dev_bits = {int(k): ev.values[i].view(torch.int16).numpy().copy()
                        for i, k in enumerate(keys)}
            ts, js = tt.maybe_demote(ts), jt.maybe_demote(js)
            tk, rows = coll.tier_store.export()
            for k, row in zip(tk.tolist(), rows):
                if k in dev_bits:
                    back = torch.from_numpy(row[:2 * DIM].copy()).to(
                        torch.bfloat16).view(torch.int16).numpy()
                    np.testing.assert_array_equal(back, dev_bits[k])
            assert_maps(key_map(coll, ts.tables["emb"].ev),
                        key_map(jt.collections["emb"], js.tables["emb"].ev),
                        atol=1e-2)
            assert set(key_map(coll, ts.tables["emb"].ev)) == \
                set(key_map(jt.collections["emb"], js.tables["emb"].ev))
    assert promoted > 0 and ts.tables["emb"].ev.values.dtype == torch.bfloat16
    # a promoted row holds the tier row's bits
    tk, rows = coll.tier_store.export()
    tiered = dict(zip(tk.tolist(), rows))
    b = batch_with(tk[:4], seed=3)
    d, c, lab = tt.prepare_batch(b)
    tt._sparse_forward(dict(ts.tables), c, ts.step)
    ev = ts.tables["emb"].ev
    slot = {int(k): i for i, k in enumerate(coll._resolver.export_keys())}
    for k in tk[:4].tolist():
        want = torch.from_numpy(tiered[k][:2 * DIM].copy()).to(torch.bfloat16)
        assert torch.equal(ev.values[slot[k]].view(torch.int16),
                           want.view(torch.int16))


def test_restore_keeps_a_key_in_one_tier(tmp_path):
    """Demote keys, promote and train them on the device, save an
    incremental, train them on, demote them again and save. The restore
    must take the newest payload: each key lives in the tier only (the JAX
    restore also loads the stale device row into the resolver, and
    training resumes from it), and the restored trainer goes on exactly as
    the live one."""
    tt = port_trainer(steps_to_live=2)
    hot = [1, 2, 3, 4]
    ts = tt.init(batch_with(hot))
    mgr = tsaver.CheckpointManager(str(tmp_path))

    def age(ts, s0):
        for s in range(3):
            ts = tt.train_step(ts, batch_with([100 + s0 + s], seed=s0 + s))
        return tt.maybe_demote(ts)
    ts = tt.train_step(ts, batch_with(hot))
    ts = age(ts, 0)
    coll = tt.collections["emb"]
    demoted = set(coll._resolver.export_keys().tolist()) ^ tier_keys(coll)
    keys = {k for k in tier_keys(coll)} & set(
        key_map(coll, ts.tables["emb"].ev))
    mgr.save(tt, ts)
    ts = tt.train_step(ts, batch_with(hot, seed=1))   # promote, train
    ts = tt.train_step(ts, batch_with(hot, seed=2))
    mgr.save_incremental(tt, ts)                       # device rows
    ts = tt.train_step(ts, batch_with(hot, seed=3))    # trained since
    ts = age(ts, 10)                                   # demote them again
    mgr.save_incremental(tt, ts)                       # tier rows, newer
    live = key_map(coll, ts.tables["emb"].ev)
    again = tier_keys(coll)
    assert demoted and keys
    hot_keys = set(tsaver.F.read_table(
        tformat.list_saves(str(tmp_path))[1]["path"], "emb")["keys"].tolist())
    assert hot_keys & again  # the stale device rows are in a save

    tt2 = port_trainer(steps_to_live=2)
    ts2, ok = tsaver.CheckpointManager(str(tmp_path)).restore(
        tt2, tt2.init(batch_with(hot)))
    assert ok
    coll2 = tt2.collections["emb"]
    assert not set(coll2._resolver.export_keys().tolist()) & tier_keys(coll2)
    assert_maps(key_map(coll2, ts2.tables["emb"].ev), live, atol=0)
    for s in range(2):  # the touch promotes the newest payload on both
        b = batch_with(hot, seed=20 + s)
        ts, ts2 = tt.train_step(ts, b), tt2.train_step(ts2, b)
        assert_maps(key_map(coll2, ts2.tables["emb"].ev),
                    key_map(coll, ts.tables["emb"].ev), atol=0)


def test_failed_save_keeps_the_tier_window(tmp_path, monkeypatch):
    """``export_tier(since=...)`` leaves the since-save window alone; the
    saver clears it once the save is written. A save whose write raises
    leaves the next incremental carrying the same tier rows."""
    tt = port_trainer(steps_to_live=2)
    ts = tt.init(batch_with([1, 2]))
    ts = tt.train_step(ts, batch_with([1, 2]))
    mgr = tsaver.CheckpointManager(str(tmp_path))
    mgr.save(tt, ts)
    for s in range(3):
        ts = tt.train_step(ts, batch_with([100 + s], seed=s))
    ts = tt.maybe_demote(ts)
    window = tier_keys(tt.collections["emb"])
    assert window

    def broken(*a, **kw):
        raise OSError("disk full")
    monkeypatch.setattr(tformat, "write_save", broken)
    with pytest.raises(OSError):
        mgr.save_incremental(tt, ts)
    monkeypatch.undo()
    path = mgr.save_incremental(tt, ts)
    saved = tformat.read_table(path, "__tier__emb")
    assert set(saved["keys"].tolist()) == window
    # that save was durable: the next incremental carries no tier rows
    ts = tt.train_step(ts, batch_with([100], seed=9))
    path = mgr.save_incremental(tt, ts)
    with pytest.raises(FileNotFoundError):
        tformat.read_table(path, "__tier__emb")


def test_default_ssd_arenas_are_apart():
    """Two HBM_DRAM_SSD tables of one name in one process (a live trainer
    and the one a checkpoint restores into) get their own arena files
    under the temp dir when ``ssd_path`` is empty."""
    tiers = []
    for _ in range(2):
        tc = colls(storage="HBM_DRAM_SSD")[1]
        tiers.append(tc._make_tier(2 * DIM + 3))
    a, b = (t.ssd.path for t in tiers)
    assert a != b
    assert all(p.startswith(tempfile.gettempdir()) for p in (a, b))
    tiers[0].upsert(np.arange(3, dtype=np.int64),
                    np.ones((3, 2 * DIM + 3), np.float32))
    assert len(tiers[1]) == 0
    del tiers
    for p in (a, b):
        if os.path.exists(p):
            os.remove(p)
