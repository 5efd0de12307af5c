"""Port parity for the zoo's optimizers: sparse_adagrad, sparse_ftrl and
sparse_adam on one step over the same rows, slot rows and lanes (created,
masked and null-row lanes among them) as the JAX package's; the sparse
registry; and the dense Adagrad, Adam and SGD (plain, momentum and
Nesterov) against optax.adagrad, optax.adam and optax.sgd over five steps
of a DCN's parameters, with their state carried to and from the optax
leaves. The other sparse optimizers: test_torch_sparse_optim.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from deeprec_tpu.checkpoint import format as jformat
from deeprec_tpu.models import ctr as jctr
from deeprec_tpu.optim import sparse as jsopt

from deeprec_tpu_torch.checkpoint import format as tformat
from deeprec_tpu_torch.models import ctr as tctr
from deeprec_tpu_torch.optim import dense as tdense
from deeprec_tpu_torch.optim import sparse as tsopt

torch.set_num_threads(1)

CAP, DIM, U = 64, 4, 40
# f32 arithmetic in another order (rsqrt, pow, the bias correction): a
# sparse result within 1e-6 of its array's largest magnitude (FTRL's
# linear adds g to sigma * row with sigma = d(accum^p) / lr, terms of
# ~40, whose rounding stays in a near-cancelled sum)
SPARSE_RTOL = 1e-6
DENSE_ATOL = 1e-6

SPARSE_CASES = {
    "adagrad": dict(learning_rate=0.05, initial_accumulator_value=0.1),
    "ftrl": dict(learning_rate=0.05),
    "ftrl_l1_l2": dict(learning_rate=0.05, learning_rate_power=-0.7,
                       l1_regularization_strength=0.01,
                       l2_regularization_strength=0.1),
    "adam": dict(learning_rate=0.002),
}


def _slot_init(name, rng):
    """Slot rows as a trained table holds them (accumulators > 0)."""
    shape = (CAP + 1, DIM)
    if name == "adagrad":
        return {"acc": rng.uniform(0.1, 2.0, shape)}
    if name.startswith("ftrl"):
        return {"accum": rng.uniform(0.1, 2.0, shape),
                "linear": rng.normal(size=shape)}
    return {"m": 0.1 * rng.normal(size=shape),
            "v": rng.uniform(0.0, 0.1, shape)}


@pytest.mark.parametrize("cur", [False, True], ids=["stored", "cur_rows"])
@pytest.mark.parametrize("case", list(SPARSE_CASES))
def test_sparse_optimizer_step_matches_jax(case, cur):
    name = case.split("_")[0]
    rng = np.random.default_rng(len(case) + cur)
    values = rng.normal(size=(CAP + 1, DIM)).astype(np.float32)
    values[CAP] = 0.0  # the null row
    slot = {k: v.astype(np.float32) for k, v in _slot_init(case,
                                                          rng).items()}
    slots = rng.permutation(CAP)[:U].astype(np.int32)
    slots[-4:] = CAP                       # overflow lanes: the null row
    mask = rng.random(U) < 0.8
    mask[-4:] = False                      # ... never admitted
    created = rng.random(U) < 0.3
    grads = rng.normal(size=(U, DIM)).astype(np.float32)
    cur_rows = rng.normal(size=(U, DIM)).astype(np.float32) if cur else None
    step = 6

    jopt = getattr(jsopt, f"sparse_{name}")(**SPARSE_CASES[case])
    topt = tsopt.make(name, **SPARSE_CASES[case])
    assert topt.name == jopt.name and topt.fills == jopt.fills
    # the slot dict's leaves are named as a save names its columns
    jinit = jopt.init(jnp.asarray(values))
    tinit = topt.init(torch.from_numpy(values))
    assert [n for n, _ in tformat.slot_leaf_names(tinit)] == \
        [n for n, _ in jformat.slot_leaf_names(jinit)]
    for (_, a), (_, b) in zip(tformat.slot_leaf_names(tinit),
                              jformat.slot_leaf_names(jinit)):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    jv, js = jopt.apply(
        jnp.asarray(values), {k: jnp.asarray(v) for k, v in slot.items()},
        jnp.asarray(slots), jnp.asarray(grads), jnp.asarray(mask),
        jnp.asarray(step, jnp.int32),
        cur_rows=None if cur_rows is None else jnp.asarray(cur_rows),
        created=jnp.asarray(created))
    tv, ts = topt.apply(
        torch.from_numpy(values.copy()),
        {k: torch.from_numpy(v.copy()) for k, v in slot.items()},
        torch.from_numpy(slots), torch.from_numpy(grads),
        torch.from_numpy(mask), step,
        cur_rows=None if cur_rows is None else torch.from_numpy(cur_rows),
        created=torch.from_numpy(created))
    for got, ref, what in [(tv, jv, "values")] + [(ts[k], js[k], k)
                                                 for k in slot]:
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=SPARSE_RTOL * np.abs(ref).max(),
                                   err_msg=what)
    # masked lanes and untouched rows keep their values and slot rows
    keep = np.ones(CAP + 1, bool)
    keep[slots[mask]] = False
    np.testing.assert_array_equal(tv.numpy()[keep], values[keep])
    for k in slot:
        np.testing.assert_array_equal(ts[k].numpy()[keep], slot[k][keep])
    assert (tv.numpy()[~keep] != values[~keep]).any()


def test_sparse_registry():
    # every JAX optimizer is ported, under its JAX name
    assert set(tsopt.REGISTRY) == set(jsopt.REGISTRY)
    assert tsopt.make("adagrad_fused").name == "adagrad_fused"
    assert tsopt.make("adam_async", learning_rate=0.01).name == "adam_async"
    with pytest.raises(KeyError):
        tsopt.make("nope")


DENSE = {
    "adagrad": (lambda: optax.adagrad(0.05), lambda: tdense.Adagrad(0.05)),
    "adam": (lambda: optax.adam(0.002), lambda: tdense.Adam(0.002)),
    "sgd": (lambda: optax.sgd(0.05), lambda: tdense.SGD(0.05)),
    "momentum": (lambda: optax.sgd(0.05, momentum=0.9),
                 lambda: tdense.SGD(0.05, momentum=0.9)),
}


@pytest.mark.parametrize("which", list(DENSE))
def test_dense_optimizer_matches_optax(which):
    """Five steps of a small DCN's parameters under random gradients: the
    port's optimizer against optax's, parameters and state leaves."""
    rng = np.random.default_rng(3)
    names = ["C1", "C2"]
    jm = jctr.DCN(emb_names=names, cross_layers=2, deep_units=(6,))
    tm = tctr.DCN(names, 3, cross_layers=2, deep_units=(6,), dense_dim=2)
    emb = {n: jnp.ones((4, 3)) for n in names}
    params = jm.init(jax.random.key(0), jnp.ones((4, 2)), emb, train=False)
    tctr.load_flax_params(tm, [np.asarray(x) for x in
                               jax.tree_util.tree_leaves(params)])
    jopt, topt = (make() for make in DENSE[which])
    jstate = jopt.init(params)
    tparams = list(tm.parameters())
    tstate = topt.init(tparams)
    assert len(topt.flax_state_leaves(tm, tstate)) == topt.state_leaf_count(
        len(tctr.flax_leaves(tm)))
    treedef = jax.tree_util.tree_structure(params)
    for _ in range(5):
        gl = [rng.normal(size=np.shape(x)).astype(np.float32)
              for x in jax.tree_util.tree_leaves(params)]
        upd, jstate = jopt.update(jax.tree_util.tree_unflatten(
            treedef, [jnp.asarray(g) for g in gl]), jstate, params)
        params = optax.apply_updates(params, upd)
        for p, g in zip(tparams, tctr.load_flax_state(tm, gl, "grad")):
            p.grad = g
        topt.step(tparams, tstate)
    for a, b in zip(tctr.flax_leaves(tm), jax.tree_util.tree_leaves(params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=DENSE_ATOL)
    got = topt.flax_state_leaves(tm, tstate)
    ref = jax.tree_util.tree_leaves(jstate)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.shape == np.shape(b) and a.dtype == np.asarray(b).dtype
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6,
                                   atol=DENSE_ATOL)
    # and back: the optax leaves restore the port's state exactly
    back = topt.load_flax_state(tm, got)
    for a, b in zip(jax.tree_util.tree_leaves(tuple(back)),
                    jax.tree_util.tree_leaves(tuple(tstate))):
        assert torch.equal(a, b)
