"""Port parity for tiered device-index tables: ``train.tiered_trainer.
TieredTrainer`` and ``sparse.tiered.TieredTable`` against the JAX
package's.

- The two TieredTrainers (DLRM, sparse Adagrad with its accumulator slot
  rows) step a SyntheticCriteo stream with demotion every 4 steps: losses
  within LOSS_ATOL, and at every fence the key -> (row, freq, version,
  create step, accumulator row) map over the device table and the host
  tier matches (integers bit-equal, floats within ROW_ATOL), no key in
  both tiers; rows leave for the tier and come back.
- A demote -> promote round trip keeps rows and optimizer state exactly.
- ``StorageOption.hbm_capacity`` demotes the least recently touched rows
  with no eviction policy, as in the JAX package.
- The port's two engines, both tiered (a host-index collection under the
  plain Trainer, a device-index one under TieredTrainer), end a stream
  with equal key maps and equal eval losses
  (``tests/test_host_tiered.py`` ``test_engine_equality_with_device_
  tiered``).
- A full and an incremental save of a TieredTrainer restore into fresh
  port and JAX TieredTrainers; the port keeps each key in one tier.
- ``TieredTable``: demote, promote on re-creation, export and import."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import deeprec_tpu as dr
from deeprec_tpu import feature_column as jfc
from deeprec_tpu.checkpoint import saver as jsaver
from deeprec_tpu.models import ctr as jctr
from deeprec_tpu.optim import sparse as jsopt
from deeprec_tpu.sparse import embedding_var as jev
from deeprec_tpu.sparse import keys as JK
from deeprec_tpu.sparse.tiered import TieredTable as JTieredTable
from deeprec_tpu.train.tiered_trainer import TieredTrainer as JTiered

from deeprec_tpu_torch import config as tcfg
from deeprec_tpu_torch import feature_column as tfc
from deeprec_tpu_torch.checkpoint import saver as tsaver
from deeprec_tpu_torch.host_index import HostIndexEmbeddingCollection as THost
from deeprec_tpu_torch.models import ctr as tctr
from deeprec_tpu_torch.optim import dense as tdense
from deeprec_tpu_torch.optim import sparse as tsopt
from deeprec_tpu_torch.sparse import embedding_var as tev
from deeprec_tpu_torch.sparse.tiered import TieredTable as TTieredTable
from deeprec_tpu_torch.train import metrics as tmetrics
from deeprec_tpu_torch.train.tiered_trainer import TieredTrainer as TTiered
from deeprec_tpu_torch.train.trainer import Trainer as TTrainer

from test_torch_tier_trainer import CATS, batch_with, carried, stream

torch.set_num_threads(1)

DIM, CAP = 8, 256
ROW_ATOL = 1e-5    # rows and slot rows: f32 sums in another order
LOSS_ATOL = 1e-4


def _coll(fcm, cfgm, steps_to_live=4, hbm_capacity=0):
    kw = dict(name="emb", capacity=CAP,
              initializer=cfgm.Initializer("normal", scale=0.1),
              storage=cfgm.StorageOption(
                  storage_type=cfgm.StorageType.HBM_DRAM,
                  hbm_capacity=hbm_capacity))
    if steps_to_live:
        kw["evict"] = cfgm.GlobalStepEvict(steps_to_live=steps_to_live)
    return fcm.EmbeddingCollection(
        [fcm.EmbeddingColumn(fcm.CategoricalColumn(n), DIM) for n in CATS],
        **kw)


def _tmodel():
    return tctr.DLRM(CATS, DIM, bottom_units=(16,), top_units=(16,),
                     dense_dim=1)


def tiered_pair(**kw):
    jt = JTiered(model=jctr.DLRM(emb_names=CATS, emb_dim=DIM,
                                 bottom_units=(16,), top_units=(16,)),
                 numeric_columns=[jfc.NumericColumn("I1")],
                 collections={"emb": _coll(jfc, dr, **kw)},
                 sparse_optimizers={"emb": jsopt.sparse_adagrad(0.1)},
                 dense_optimizer=optax.adagrad(0.05))
    tt = TTiered(_tmodel(), [tfc.NumericColumn("I1")],
                 {"emb": _coll(tfc, tcfg, **kw)},
                 {"emb": tsopt.sparse_adagrad(0.1)}, tdense.Adagrad(0.05),
                 device="cpu")
    return jt, tt


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def key_map(trainer, state):
    """key -> (values row, freq, version, create step, accumulator row)
    over the device table and the host tier; no key in both."""
    st, slot = state.tables["emb"].ev, state.tables["emb"].slot
    keys = (JK.to_numpy(st.index.stored_keys) if hasattr(st.index, "key_hi")
            else st.index.keys.numpy())
    idx = np.nonzero(keys != -1)[0]
    acc = _np(slot["acc"])
    planes = [_np(getattr(st, f)) for f in ("values", "freqs", "versions",
                                            "create_steps")]
    out = {int(keys[i]): (planes[0][i], int(planes[1][i]),
                          int(planes[2][i]), int(planes[3][i]), acc[i])
           for i in idx}
    kv = trainer.tiers.get("emb")
    if kv is not None and len(kv):
        tk, rows = kv.export()
        bits = rows[:, DIM:DIM + 3].copy().view(np.int32)
        for k, row, b in zip(tk.tolist(), rows, bits):
            assert k not in out, f"key {k} is on the device and in the tier"
            out[k] = (row[:DIM], int(b[0]), int(b[1]), int(b[2]),
                      row[DIM + 3:DIM + 3 + DIM])
    return out


def assert_maps(got, ref, atol=ROW_ATOL):
    assert set(got) == set(ref), (len(got), len(ref))
    for k, (gv, gf, gver, gc, ga) in got.items():
        rv, rf, rver, rc, ra = ref[k]
        assert (gf, gver, gc) == (rf, rver, rc), k
        np.testing.assert_allclose(gv, rv, rtol=0, atol=atol, err_msg=k)
        np.testing.assert_allclose(ga, ra, rtol=0, atol=atol, err_msg=k)


def _lockstep(jt, tt, js, ts, batches, demote_every=4):
    """Step both (``train_step``: promotion first), demoting every
    ``demote_every`` steps; the maps equal at each fence. Returns the
    states and the keys that came back from the tier."""
    back, tiered = set(), set()
    for i, b in enumerate(batches):
        j0, t0 = float(js.metrics.loss_sum), float(ts.metrics.loss_sum)
        js, ts = jt.train_step(js, b), tt.train_step(ts, b)
        n = len(b["label"])
        jl = (float(js.metrics.loss_sum) - j0) / n
        tl = (float(ts.metrics.loss_sum) - t0) / n
        assert abs(jl - tl) <= LOSS_ATOL, (i, jl, tl)
        if i % demote_every == demote_every - 1:
            js, ts = jt.maybe_demote(js), tt.maybe_demote(ts)
            got = key_map(tt, ts)
            assert_maps(got, key_map(jt, js))
            keys = tt.tiers["emb"].export()[0] if tt.tiers["emb"] else []
            on_dev = set(got) - set(int(k) for k in keys)
            back |= tiered & on_dev
            tiered = set(int(k) for k in keys)
    return js, ts, back


def test_tiered_trainer_matches_jax():
    batches = stream(16)
    jt, tt = tiered_pair(steps_to_live=4)
    js, ts = carried(jt, tt, batches[0])
    js, ts, back = _lockstep(jt, tt, js, ts, batches)
    assert tt.host_tier_rows("emb") == jt.host_tier_rows("emb") > 0
    assert back, "no demoted key came back"


def _rows_of(tt, ts, ids):
    """Device rows and accumulator rows of column C1's ``ids``."""
    from deeprec_tpu_torch.sparse import hashtable as ht
    coll = tt.collections["emb"]
    keys = torch.from_numpy(coll.pack_ids_np(batch_with(ids,
                                                        bs=len(ids)))[0])
    b = ts.tables["emb"]
    slots, found = ht.lookup(b.ev.index, keys)
    return found.numpy(), b.ev.values[slots].numpy(), \
        b.slot["acc"][slots].numpy()


def test_demote_then_promote_keeps_optimizer_state():
    jt, tt = tiered_pair(steps_to_live=3)
    cold, hot = [11, 12], [77, 78]
    js, ts = carried(jt, tt, batch_with(cold))
    for b in [batch_with(cold)] * 2 + [batch_with(hot)] * 4:
        js, ts = jt.train_step(js, b), tt.train_step(ts, b)
    found, vals, acc = _rows_of(tt, ts, cold)
    assert found.all()
    js, ts = jt.maybe_demote(js), tt.maybe_demote(ts)
    assert not _rows_of(tt, ts, cold)[0].any()  # gone from the device
    assert tt.host_tier_rows("emb") == jt.host_tier_rows("emb") > 0
    js = jt.promote_packed(js, jt.prepare_probe(batch_with(cold)))
    ts = tt.promote_packed(ts, tt.prepare_probe(batch_with(cold)))
    found, vals2, acc2 = _rows_of(tt, ts, cold)
    assert found.all()
    np.testing.assert_array_equal(vals2, vals)
    np.testing.assert_array_equal(acc2, acc)
    assert_maps(key_map(tt, ts), key_map(jt, js))


def test_budget_demotion_without_policy():
    jt, tt = tiered_pair(steps_to_live=0, hbm_capacity=8)
    old, new = [1, 2, 3, 4], [5, 6, 7, 8]
    js, ts = carried(jt, tt, batch_with(old))
    for b in (batch_with(old), batch_with(new)):
        js, ts = jt.train_step(js, b), tt.train_step(ts, b)
    js, ts = jt.maybe_demote(js), tt.maybe_demote(ts)
    assert not _rows_of(tt, ts, old)[0].any()
    assert _rows_of(tt, ts, new)[0].all()
    assert tt.host_tier_rows("emb") == jt.host_tier_rows("emb") == 8
    assert_maps(key_map(tt, ts), key_map(jt, js))


def _host_map(tr, state):
    """key -> (values row, freq, version, accumulator row) over a host-index
    table and its tier."""
    coll = tr.collections["emb"]
    n = coll._resolver.size
    keys = coll._resolver.export_keys()
    st, slot = state.tables["emb"].ev, state.tables["emb"].slot
    out = {int(k): (st.values[i].numpy(), int(st.freqs[i]),
                    int(st.versions[i]), slot["acc"][i].numpy())
           for i, k in enumerate(keys[:n])}
    if coll.tier_store is not None and len(coll.tier_store):
        tk, rows = coll.tier_store.export()
        bits = rows[:, DIM:DIM + 2].copy().view(np.int32)
        for k, row, b in zip(tk.tolist(), rows, bits):
            out[k] = (row[:DIM], int(b[0]), int(b[1]),
                      row[DIM + 3:DIM + 3 + DIM])
    return out


def test_engine_equality_with_device_tiered():
    """The port's host-index tiered engine and its TieredTrainer, the same
    stream and demotion cadence: the same key -> state map, and the same
    eval loss once a step has promoted the batch's keys on both."""
    batches = stream(12)
    host = THost([tfc.EmbeddingColumn(tfc.CategoricalColumn(n), DIM)
                  for n in CATS], name="emb", capacity=CAP,
                 initializer=tcfg.Initializer("normal", scale=0.1),
                 evict=tcfg.GlobalStepEvict(steps_to_live=4),
                 storage=tcfg.StorageOption(
                     storage_type=tcfg.StorageType.HBM_DRAM))
    th = TTrainer(_tmodel(), [tfc.NumericColumn("I1")], {"emb": host},
                  {"emb": tsopt.sparse_adagrad(0.1)}, tdense.Adagrad(0.05),
                  device="cpu")
    _, td = tiered_pair(steps_to_live=4)
    sh, sd = th.init(batches[0]), td.init(batches[0])
    td.model.load_state_dict(th.model.state_dict())
    for i, b in enumerate(batches):
        sh, sd = th.train_step(sh, b), td.train_step(sd, b)
        if i % 4 == 3:
            sh, sd = th.maybe_demote(sh), td.maybe_demote(sd)
    assert th.host_tier_rows("emb") > 0
    got = _host_map(th, sh)
    ref = {k: (v[0], v[1], v[2], v[4]) for k, v in key_map(td, sd).items()}
    assert set(got) == set(ref)
    for k, (gv, gf, gver, ga) in got.items():
        rv, rf, rver, ra = ref[k]
        assert (gf, gver) == (rf, rver), k
        np.testing.assert_allclose(gv, rv, rtol=0, atol=1e-6)
        np.testing.assert_allclose(ga, ra, rtol=0, atol=1e-6)
    sh, sd = th.train_step(sh, batches[0]), td.train_step(sd, batches[0])
    mh = th.eval_step(sh, tmetrics.create(device="cpu"), batches[0])
    md = td.eval_step(sd, tmetrics.create(device="cpu"), batches[0])
    np.testing.assert_allclose(float(mh.loss_sum), float(md.loss_sum),
                               rtol=1e-6)


def test_tiered_saves_restore_into_one_tier(tmp_path):
    """Full save after the first demotion, incremental after the second;
    fresh port and JAX TieredTrainers restore the directory. The port's
    restore holds exactly the map the trainer had (each key in one tier);
    the JAX restore holds the same keys (it may keep a key in both)."""
    batches = stream(12)
    jt, tt = tiered_pair(steps_to_live=4)
    js, ts = carried(jt, tt, batches[0])
    mgr = tsaver.CheckpointManager(str(tmp_path))
    for i, b in enumerate(batches):
        js, ts = jt.train_step(js, b), tt.train_step(ts, b)
        if i % 4 == 3:
            ts = tt.maybe_demote(ts)
            if i == 3:
                mgr.save(tt, ts, evict=False)
            else:
                mgr.save_incremental(tt, ts)
    assert tt.host_tier_rows("emb") > 0
    want = key_map(tt, ts)
    _, rt = tiered_pair(steps_to_live=4)
    rs, ok = tsaver.CheckpointManager(str(tmp_path)).restore(
        rt, rt.init(batches[0]))
    assert ok and rs.step == 12
    assert_maps(key_map(rt, rs), want, atol=0)
    rjt, _ = tiered_pair(steps_to_live=4)
    rjs, ok = jsaver.CheckpointManager(str(tmp_path)).restore(
        rjt, rjt.init(jax.random.key(0), batches[0]))
    assert ok and int(rjs.step) == 12
    jkeys = set(JK.to_numpy(rjs.tables["emb"].ev.index.stored_keys)) - {-1}
    jkeys |= set(rjt.tiers["emb"].export()[0].tolist())
    assert jkeys == set(want)


def test_tiered_table_matches_jax():
    kw = dict(name="t", embedding_dim=4, capacity=64)
    jcfg = dr.EmbeddingVariableConfig(
        evict=dr.GlobalStepEvict(steps_to_live=2),
        initializer=dr.Initializer("uniform", scale=0.1), **kw)
    tcfgv = tcfg.EmbeddingVariableConfig(
        evict=tcfg.GlobalStepEvict(steps_to_live=2),
        initializer=tcfg.Initializer("uniform", scale=0.1), **kw)
    jtab, ttab = JTieredTable(jcfg), TTieredTable(tcfgv)
    js, ts = jev.create(jcfg), tev.create(tcfgv, "cpu")
    ids = np.asarray([1, 2, 3, -1, 2], np.int64)
    js, ja = jtab.lookup_or_create(js, JK.from_numpy(ids), 0)
    ts, ta = ttab.lookup_or_create(ts, torch.from_numpy(ids), 0)
    marker = np.arange(ta.slots.shape[0] * 4, dtype=np.float32).reshape(
        -1, 4) + 1.0  # hand-trained rows the tier must keep
    live = ta.slots.numpy() != 64
    js = js._replace(values=js.values.at[jnp.asarray(ja.slots[live])].set(
        jnp.asarray(marker[live])))
    ts.values[ta.slots[torch.from_numpy(live)]] = torch.from_numpy(
        marker[live])
    js, jperm = jtab.demote(js, 5)
    ts, tperm = ttab.demote(ts, 5)
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(jperm))
    assert ttab.host_rows() == jtab.host_rows() == 3
    assert int(ts.index.size) == 0
    js, ja = jtab.lookup_or_create(js, JK.from_numpy(ids), 6)
    ts, ta = ttab.lookup_or_create(ts, torch.from_numpy(ids), 6)
    np.testing.assert_array_equal(ta.created.numpy(), np.asarray(ja.created))
    assert not ta.created.any() and ttab.host_rows() == 0
    np.testing.assert_array_equal(tev.gather(ts.values, ta, tcfgv).numpy(),
                                  np.asarray(jev.gather(js.values, ja, jcfg)))
    # export / import
    ttab.import_host(np.asarray([10, 20], np.int64),
                     np.ones((2, 4), np.float32))
    k, r = ttab.export_host()
    t2 = TTieredTable(tcfgv)
    t2.import_host(k, r)
    assert t2.host_rows() == 2
