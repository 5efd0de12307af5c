"""Slot leaves of the optimizers ported last through host-index tiering:
a JAX and a port ``Trainer`` over tiered tables (``StorageOption(HBM_DRAM)``,
demotion every 4 steps) with adagrad_decay (an int32 ``last_period`` row
leaf), adam_async (0-d beta powers) and sgd (an empty slot state) step the
same batches. Their wires and promo planes are bit-equal every step; at
each fence the key -> (row, metadata, slot rows) maps across both tiers
match, the payloads' integer columns (freq, version, create step, the
int32 slot leaf) bit-equal; the 0-d leaves stay 0-d and equal."""
import numpy as np
import pytest
import torch

import optax

import deeprec_tpu as dr
from deeprec_tpu import feature_column as jfc
from deeprec_tpu.host_index import HostIndexEmbeddingCollection as JHost
from deeprec_tpu.models import ctr as jctr
from deeprec_tpu.optim import sparse as jsopt
from deeprec_tpu.train.trainer import Trainer as JTrainer

from deeprec_tpu_torch import config as tcfg
from deeprec_tpu_torch import feature_column as tfc
from deeprec_tpu_torch.checkpoint import format as tformat
from deeprec_tpu_torch.host_index import HostIndexEmbeddingCollection as THost
from deeprec_tpu_torch.models import ctr as tctr
from deeprec_tpu_torch.optim import dense as tdense
from deeprec_tpu_torch.optim import sparse as tsopt
from deeprec_tpu_torch.sparse import tier_payload as TP
from deeprec_tpu_torch.train.trainer import Trainer as TTrainer

from test_torch_tier_trainer import (CATS, DIM, LOSS_ATOL, ROW_ATOL, _np,
                                     carried, step, stream)

torch.set_num_threads(1)

CAP = 256
OPTS = {"adagrad_decay": dict(learning_rate=0.1, accumulator_decay_step=3,
                              accumulator_decay_rate=0.5),
        "adam_async": dict(learning_rate=0.01),
        "sgd": dict(learning_rate=0.1)}


def _trainers(name):
    out = []
    for mod, host, fc, sopt in ((dr, JHost, jfc, jsopt),
                                (tcfg, THost, tfc, tsopt)):
        out.append(host(
            [fc.EmbeddingColumn(fc.CategoricalColumn(n), DIM) for n in CATS],
            name="emb", capacity=CAP, n_groups=1,
            initializer=mod.Initializer("normal", scale=0.1),
            evict=mod.GlobalStepEvict(steps_to_live=4),
            storage=mod.StorageOption(
                storage_type=mod.StorageType.HBM_DRAM)))
    jc, tc = out
    jt = JTrainer(model=jctr.DLRM(emb_names=CATS, emb_dim=DIM,
                                  bottom_units=(16,), top_units=(16,)),
                  numeric_columns=[jfc.NumericColumn("I1")],
                  collections={"emb": jc},
                  sparse_optimizers={"emb": jsopt.make(name, **OPTS[name])},
                  dense_optimizer=optax.adagrad(0.05))
    tt = TTrainer(tctr.DLRM(CATS, DIM, bottom_units=(16,), top_units=(16,),
                            dense_dim=1),
                  [tfc.NumericColumn("I1")], {"emb": tc},
                  {"emb": tsopt.make(name, **OPTS[name])},
                  tdense.Adagrad(0.05), device="cpu")
    return jt, tt


def _slot_map(coll, bundle):
    """key -> slot rows (flattened, each leaf's own dtype) across the
    device stores and the tier payloads; the 0-d leaves apart."""
    n = coll._resolver.size
    keys = coll._resolver.export_keys()
    leaves = [_np(x) for _, x in tformat.slot_leaf_names(bundle.slot)]
    rowed = [x for x in leaves if x.ndim and x.shape[0] == CAP + 1]
    scalars = [x for x in leaves if not x.ndim]
    out = {int(k): [x[i].reshape(-1) for x in rowed]
           for i, k in enumerate(keys[:n])}
    if coll.tier_store is not None and len(coll.tier_store):
        sp = TP.spec(DIM, bundle.slot, CAP + 1)
        tk, rows = coll.tier_store.export()
        for k, row in zip(tk.tolist(), rows):
            o, parts = DIM + 3, []
            for s in sp.slot_rows:
                part = row[o:o + s.width].copy()
                if not s.dtype.is_floating_point:
                    part = part.view(np.int32)
                parts.append(part)
                o += s.width
            assert k not in out
            out[k] = parts
    return out, scalars


def _jax_slot_map(coll, bundle):
    """The JAX side of :func:`_slot_map`."""
    import jax
    n = coll._resolver.size
    keys = coll._resolver.export_keys()
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(bundle.slot)]
    rowed = [x for x in leaves if x.ndim and x.shape[0] == CAP + 1]
    scalars = [x for x in leaves if not x.ndim]
    out = {int(k): [x[i].reshape(-1) for x in rowed]
           for i, k in enumerate(keys[:n])}
    if coll.tier_store is not None and len(coll.tier_store):
        tk, rows = coll.tier_store.export()
        widths = [int(np.prod(x.shape[1:], dtype=np.int64)) for x in rowed]
        for k, row in zip(tk.tolist(), rows):
            o, parts = DIM + 3, []
            for x, w in zip(rowed, widths):
                part = row[o:o + w].copy()
                parts.append(part.view(np.int32) if x.dtype.kind == "i"
                             else part)
                o += w
            out[k] = parts
    return out, scalars


def _assert_slot_maps(got, ref):
    (gm, gs), (rm, rs) = got, ref
    assert set(gm) == set(rm)
    for k, parts in gm.items():
        for g, r in zip(parts, rm[k]):
            assert g.dtype == r.dtype, k
            if r.dtype.kind == "i":
                np.testing.assert_array_equal(g, r, err_msg=f"key {k}")
            else:
                np.testing.assert_allclose(g, r, rtol=0, atol=ROW_ATOL,
                                           err_msg=f"key {k}")
    assert len(gs) == len(rs)
    for g, r in zip(gs, rs):
        assert g.shape == () and g.dtype == r.dtype
        np.testing.assert_allclose(g, r, rtol=1e-6)


@pytest.mark.parametrize("name", list(OPTS))
def test_tier_carries_the_slot_leaves(name):
    batches = stream(16)
    jt, tt = _trainers(name)
    js, ts = carried(jt, tt, batches[0])
    promoted = 0
    for i, b in enumerate(batches):
        js, jw, jp, jl = step(jt, js, b)
        ts, tw, tp, tl = step(tt, ts, b)
        assert jw == tw, f"wires differ at step {i}"
        assert (jp is None) == (tp is None)
        if tp is not None:
            np.testing.assert_array_equal(tp[0], jp[0])
            ints = [DIM, DIM + 1, DIM + 2]
            if name == "adagrad_decay":   # [acc (DIM) | last_period]
                ints.append(DIM + 3 + DIM)
            np.testing.assert_array_equal(tp[1][:, ints].view(np.int32),
                                          jp[1][:, ints].view(np.int32))
            np.testing.assert_allclose(tp[1], jp[1], rtol=0, atol=ROW_ATOL)
            promoted += tp[0].shape[0]
        assert abs(jl - tl) <= LOSS_ATOL, (i, jl, tl)
        if i % 4 == 3:
            js, ts = jt.maybe_demote(js), tt.maybe_demote(ts)
            _assert_slot_maps(
                _slot_map(tt.collections["emb"], ts.tables["emb"]),
                _jax_slot_map(jt.collections["emb"], js.tables["emb"]))
    assert tt.host_tier_rows("emb") > 0 and promoted > 0
    width = TP.spec(DIM, ts.tables["emb"].slot, CAP + 1).width
    assert tt.collections["emb"].tier_store.dim == width == \
        {"adagrad_decay": 2 * DIM + 4, "adam_async": 3 * DIM + 3,
         "sgd": DIM + 3}[name]
