"""Port parity for the production loop's host side: ``train/pipeline.py``
``HostStepPipeline`` (order, drain and fence semantics; a pipelined
trainer against an unpipelined one), and the growth and health of the
host-index engine against the JAX package's on one SyntheticCriteo
stream."""
import threading
from typing import NamedTuple

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import deeprec_tpu as dr
from deeprec_tpu import feature_column as jfc
from deeprec_tpu.data.criteo import CAT_NAMES, DENSE_NAMES, SyntheticCriteo
from deeprec_tpu.host_index import HostIndexEmbeddingCollection as JHost
from deeprec_tpu.models import ctr as jctr
from deeprec_tpu.optim import sparse as jsopt
from deeprec_tpu.train.trainer import Trainer as JTrainer

from deeprec_tpu_torch import config as tcfg
from deeprec_tpu_torch import feature_column as tfc
from deeprec_tpu_torch.host_index import HostIndexEmbeddingCollection as THost
from deeprec_tpu_torch.models import ctr as tctr
from deeprec_tpu_torch.optim import dense as tdense
from deeprec_tpu_torch.optim import sparse as tsopt
from deeprec_tpu_torch.train.pipeline import HostStepPipeline
from deeprec_tpu_torch.train.trainer import Trainer as TTrainer

torch.set_num_threads(1)

B, DIM = 128, 8
COLS = CAT_NAMES[:6]
CAP = 1 << 8          # small: the stream outgrows it within a few steps
MAX_UNIQUE = len(COLS) * B // 4  # some batches saturate it
LOSS_ATOL = 1e-4      # per-step loss: f32 sums in another order
STATE_ATOL = 1e-4     # tables after such drift (test_torch_train.py's)
ROW_ATOL = 1e-6       # init rows: Box-Muller log/cos to a few ulps
LAYOUTS = {
    "light": {},
    # bench.py --metadata
    "metadata": dict(counter_filter=("CounterFilter", 1),
                     evict=("GlobalStepEvict", 1 << 30)),
    # an admission threshold that keeps keys out for a step
    "filter2": dict(counter_filter=("CounterFilter", 2),
                    evict=("GlobalStepEvict", 1 << 30)),
}


def _kw(mod, layout):
    return {k: getattr(mod, cls)(arg)
            for k, (cls, arg) in LAYOUTS[layout].items()}


def _colls(layout, cap=CAP):
    # one hash group: the JAX side's C++ resolver and its Python fallback
    # assign slots in the same order, whichever it got
    common = dict(name="emb", capacity=cap, max_unique=MAX_UNIQUE,
                  fused_slot_columns=DIM, fused_slot_init=0.1, n_groups=1)
    j = JHost([jfc.EmbeddingColumn(jfc.CategoricalColumn(n), DIM)
               for n in COLS],
              initializer=dr.Initializer("normal", scale=0.05),
              **common, **_kw(dr, layout))
    t = THost([tfc.EmbeddingColumn(tfc.CategoricalColumn(n), DIM)
               for n in COLS],
              initializer=tcfg.Initializer("normal", scale=0.05),
              **common, **_kw(tcfg, layout))
    return j, t


def _port_trainer(layout, seed=0):
    torch.manual_seed(seed)
    _, coll = _colls(layout)
    return TTrainer(
        tctr.DLRM(COLS, DIM, bottom_units=(16,), top_units=(16,),
                  dense_dim=len(DENSE_NAMES)),
        [tfc.NumericColumn(n, log_normalize=True) for n in DENSE_NAMES],
        {"emb": coll}, {"emb": tsopt.sparse_adagrad_fused(0.05)},
        tdense.Adagrad(0.05), device="cpu")


def _wire_bytes(cats):
    return cats["emb"].buf.numpy().tobytes()


# -- the pipeline alone ---------------------------------------------------


@pytest.mark.parametrize("fence_every,depth", [(0, 1), (3, 1), (3, 3),
                                               (5, 2)])
def test_pipeline_order_drain_and_fences(fence_every, depth):
    """Items come out in source order; resolves run on one thread in
    step order; a fence sees the pipeline drained (every resolved item
    consumed); a closed pipeline takes no more items."""
    resolved, stepped, fences, threads = [], [], [], set()

    def resolve(i):
        threads.add(threading.get_ident())
        resolved.append(i)
        return torch.tensor([i])

    with HostStepPipeline(resolve, depth=depth, device="cpu") as pipe:
        def on_fence(done):
            assert len(pipe) == 0 and len(resolved) == done
            fences.append(done)
        n = pipe.run(range(17), lambda x: stepped.append(int(x)),
                     fence_every=fence_every, on_fence=on_fence)
        assert n == 17 and len(pipe) == 0
    assert stepped == resolved == list(range(17))
    assert len(threads) == 1 and threading.get_ident() not in threads
    if fence_every:
        assert fences and all(f % fence_every < depth for f in fences)
        assert fences == sorted(set(fences))
    else:
        assert not fences
    with pytest.raises(RuntimeError):
        pipe.feed(0)


def test_pipeline_drain_consumes_every_item():
    pipe = HostStepPipeline(lambda i: torch.tensor([i]), depth=4,
                            device="cpu")
    for i in range(4):
        pipe.feed(i)
    got = []
    assert pipe.drain(lambda x: got.append(int(x))) == 4
    assert got == [0, 1, 2, 3] and len(pipe) == 0
    pipe.close()


@pytest.mark.parametrize("layout,depth", [("light", 1), ("light", 3),
                                          ("metadata", 3), ("filter2", 2)])
def test_pipelined_trainer_matches_unpipelined(layout, depth):
    """A trainer fed through the pipeline (growth at its fences) and the
    same trainer stepped inline with growth after the same steps give
    bit-equal wires, equal tables and equal parameters."""
    batches = list(SyntheticCriteo(batch_size=B, seed=3).take(14))
    tp, tu = _port_trainer(layout), _port_trainer(layout)
    sp, su = tp.init(batches[0]), tu.init(batches[0])
    box = {"s": sp}
    wires_p, fences = [], []

    def step(args):
        wires_p.append(_wire_bytes(args[1]))
        box["s"] = tp._train_step(box["s"], *args)

    def fence(done):
        fences.append(done)
        box["s"] = tp.maybe_grow(box["s"])

    with HostStepPipeline(lambda b: tp.prepare_host(b), depth=depth,
                          device="cpu") as pipe:
        assert pipe.run(batches, step, fence_every=4, on_fence=fence) == 14
    sp = box["s"]

    for i, b in enumerate(batches):
        args = tu.prepare_batch(b)
        assert _wire_bytes(args[1]) == wires_p[i], i
        su = tu._train_step(su, *args)
        if i + 1 in fences:
            su = tu.maybe_grow(su)
    cp, cu = tp.collections["emb"], tu.collections["emb"]
    assert cp.config.capacity == cu.config.capacity > CAP  # it grew
    assert sp.step == su.step == 14
    for f in ("values", "freqs", "versions", "create_steps"):
        assert torch.equal(getattr(sp.tables["emb"].ev, f),
                           getattr(su.tables["emb"].ev, f)), f
    for a, b in zip(tp.model.parameters(), tu.model.parameters()):
        assert torch.equal(a, b)
    assert tp.table_health(sp) == tu.table_health(su)


# -- growth and health against the JAX package ------------------------------


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_collection_growth_matches_jax(layout):
    """Lookups with a growth whenever ``needs_growth`` says so, on both
    collections: bit-equal wires, growth at the same steps, equal health
    dicts every step, integer planes bit-equal and rows within 1e-6."""
    jc, tc = _colls(layout)
    js, ts = jc.init(), tc.init("cpu")
    opt_j, opt_t = jsopt.sparse_adagrad_fused(), tsopt.sparse_adagrad_fused()
    jlookup = jax.jit(jc.lookup_or_create)
    grown = 0
    for step, batch in enumerate(SyntheticCriteo(batch_size=B,
                                                 seed=5).take(10)):
        jw, tw = jc.pack_ids(batch), tc.pack_ids(batch, "cpu")
        assert np.asarray(jw.buf).tobytes() == tw.buf.numpy().tobytes()
        js, _ = jlookup(js, jw, jnp.asarray(step, jnp.int32))
        ts, _ = tc.lookup_or_create(ts, tw, step)
        assert tc.needs_growth(ts) == jc.needs_growth(js)
        if jc.needs_growth(js):
            js, _ = jc.grow_state(js, (), opt=opt_j)
            ts, slot = tc.grow_state(ts, (), opt=opt_t)
            assert slot == ()
            grown += 1
        assert ts.capacity == js.capacity == tc.config.capacity
        assert tc.host_health() == jc.host_health()
        assert tc.load_factor(ts) == jc.load_factor(js)
    assert grown >= 2
    h = tc.host_health()
    assert h["capacity"] > CAP and h["unique_saturated_steps"] > 0
    for f in ("freqs", "versions", "create_steps"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), f)
    np.testing.assert_allclose(ts.values.numpy(), np.asarray(js.values),
                               rtol=0, atol=ROW_ATOL)


def _jax_and_port_trainers(layout):
    jc, tc = _colls(layout)
    jt = JTrainer(
        model=jctr.DLRM(emb_names=COLS, emb_dim=DIM, bottom_units=(16,),
                        top_units=(16,)),
        numeric_columns=[jfc.NumericColumn(n, log_normalize=True)
                         for n in DENSE_NAMES],
        collections={"emb": jc},
        sparse_optimizers={"emb": jsopt.sparse_adagrad_fused(0.05)},
        dense_optimizer=optax.adagrad(0.05))
    tt = TTrainer(
        tctr.DLRM(COLS, DIM, bottom_units=(16,), top_units=(16,),
                  dense_dim=len(DENSE_NAMES)),
        [tfc.NumericColumn(n, log_normalize=True) for n in DENSE_NAMES],
        {"emb": tc}, {"emb": tsopt.sparse_adagrad_fused(0.05)},
        tdense.Adagrad(0.05), device="cpu")
    return jt, tt


@pytest.mark.parametrize("layout", ["light", "metadata"])
def test_trainer_maybe_grow_matches_jax(layout):
    """``Trainer.maybe_grow`` after every step on both trainers (weights
    carried from flax): bit-equal wires and the same growths; losses
    within 1e-4 each step; health, planes and rows after the run."""
    jt, tt = _jax_and_port_trainers(layout)
    batches = list(SyntheticCriteo(batch_size=B, seed=8).take(8))
    js = jt.init(jax.random.key(0), batches[0])
    ts = tt.init(batches[0])
    tctr.load_flax_params(tt.model, [np.asarray(x) for x in
                                     jax.tree_util.tree_leaves(js.params)])
    ts = ts._replace(opt_state=tt.dense_optimizer.load_flax_state(
        tt.model, [np.asarray(x)
                   for x in jax.tree_util.tree_leaves(js.opt_state)]))
    caps = []
    for step, batch in enumerate(batches):
        jd, jcats, jl = jt.prepare_batch(batch)
        td, tcats, tl = tt.prepare_batch(batch)
        assert np.asarray(jcats["emb"].buf).tobytes() == \
            _wire_bytes(tcats), step
        j0, t0 = float(js.metrics.loss_sum), float(ts.metrics.loss_sum)
        js = jt._jit_train(js, jd, jcats, jl)
        ts = tt._train_step(ts, td, tcats, tl)
        assert abs((float(js.metrics.loss_sum) - j0)
                   - (float(ts.metrics.loss_sum) - t0)) / B <= LOSS_ATOL
        js, ts = jt.maybe_grow(js), tt.maybe_grow(ts)
        caps.append(tt.collections["emb"].config.capacity)
        assert caps[-1] == jt.collections["emb"].config.capacity
    assert caps[-1] >= 4 * CAP  # grew at least twice
    assert tt.table_health(ts) == jt.table_health(js)
    jev, tev = js.tables["emb"].ev, ts.tables["emb"].ev
    for f in ("freqs", "versions", "create_steps"):
        np.testing.assert_array_equal(getattr(tev, f).numpy(),
                                      np.asarray(getattr(jev, f)), f)
    np.testing.assert_allclose(tev.values.numpy(), np.asarray(jev.values),
                               rtol=0, atol=STATE_ATOL)
    tt.reset_metrics(ts)  # the fence helpers exist and run
    tt.rejit()


# -- slot state through a rebuild ------------------------------------------


class _Slots(NamedTuple):
    acc: object
    power: object


def _slot_trees(rows, rng):
    def r(*shape):
        return rng.normal(size=(rows,) + shape).astype(np.float32)
    return {
        "tuple": ((r(4), r()), (np.float32(2.0), np.float32(-1.0))),
        "dict": ({"m": r(4), "v": r(4), "t": np.int32(3)},
                 {"m": np.float32(0.0), "v": np.float32(0.1),
                  "t": np.int32(0)}),
        "namedtuple": (_Slots(acc=r(4), power=np.float32(0.9)),
                       _Slots(acc=np.float32(0.1), power=np.float32(1.0))),
    }


@pytest.mark.parametrize("tree", ["tuple", "dict", "namedtuple"])
def test_permute_slot_state_matches_jax(tree):
    """Slot rows through a growth permutation (and a rebuild that drops
    rows), fresh rows filled from ``fills``, scalars passed through;
    the leaf names the checkpoint uses equal the JAX package's."""
    from deeprec_tpu.checkpoint import format as jformat
    from deeprec_tpu_torch.checkpoint import format as tformat
    cap = 16
    slots, fills = _slot_trees(cap + 1, np.random.default_rng(4))[tree]
    to_t = lambda t: jax.tree_util.tree_map(torch.as_tensor, t)
    to_j = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    assert [n for n, _ in tformat.slot_leaf_names(to_t(slots))] == \
        [n for n, _ in jformat.slot_leaf_names(to_j(slots))]
    keep = np.arange(cap) % 3 != 0
    for old_to_new in (np.arange(cap),  # growth: slots stay
                       np.where(keep, np.cumsum(keep) - 1,
                                2 * cap + 1)):  # a rebuild that drops rows
        got = tsopt.permute_slot_state(to_t(slots), torch.as_tensor(
            old_to_new), 2 * cap, fills=to_t(fills))
        ref = jsopt.permute_slot_state(to_j(slots), jnp.asarray(
            old_to_new, jnp.int32), 2 * cap, fills=to_j(fills))
        for (_, g), (_, r) in zip(tformat.slot_leaf_names(got),
                                  jformat.slot_leaf_names(ref)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
