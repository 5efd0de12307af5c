"""Port parity for the sparse optimizers ported last: sgd, adagrad_decay
(and v2), adam_fused, adam_async (with and without the RMSProp branch),
momentum (with and without Nesterov), proximal_gd, proximal_adagrad and
the group_lasso wrapper over two inner optimizers. One step each over the
same rows, slot rows and lanes (created, masked and null-row lanes among
them) as the JAX package's; the registry's twelve names; and
``permute_slot_state`` over an int32 row leaf, 0-d leaves and an empty
slot state."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeprec_tpu.checkpoint import format as jformat
from deeprec_tpu.optim import sparse as jsopt

from deeprec_tpu_torch.checkpoint import format as tformat
from deeprec_tpu_torch.optim import sparse as tsopt

torch.set_num_threads(1)

CAP, DIM, U = 64, 4, 40
# f32 arithmetic in another order (rsqrt, pow, the bias correction, the
# proximal operator): a result within 1e-6 of its array's largest
# magnitude, integer leaves bit-equal
RTOL = 1e-6
STEP = 25          # adagrad_decay: period 2 at decay step 10

CASES = {
    "sgd": (lambda m: m.sparse_sgd(0.05), 0),
    "adagrad_decay": (lambda m: m.sparse_adagrad_decay(
        0.05, accumulator_decay_step=10, accumulator_decay_rate=0.5,
        accumulator_baseline=0.2), 0),
    "adagrad_decay_v2": (lambda m: m.sparse_adagrad_decay_v2(
        0.05, accumulator_decay_step=10, accumulator_decay_rate=0.5), 0),
    "adam_fused": (lambda m: m.sparse_adam_fused(0.01), 2),
    "adam_async": (lambda m: m.sparse_adam_async(0.01), 0),
    "adam_async_rmsprop": (lambda m: m.sparse_adam_async(
        0.01, apply_sparse_rmsprop=True), 0),
    "momentum": (lambda m: m.sparse_momentum(0.05), 0),
    "momentum_nesterov": (lambda m: m.sparse_momentum(
        0.05, momentum=0.8, use_nesterov=True), 0),
    "proximal_gd": (lambda m: m.sparse_proximal_gradient_descent(
        0.05, l1_regularization_strength=0.3,
        l2_regularization_strength=0.5), 0),
    "proximal_adagrad": (lambda m: m.sparse_proximal_adagrad(
        0.05, l1_regularization_strength=0.2,
        l2_regularization_strength=0.4), 0),
    "group_lasso_adagrad": (lambda m: m.group_lasso(
        m.sparse_adagrad(0.05), 0.4), 0),
    "group_lasso_sgd": (lambda m: m.group_lasso(m.sparse_sgd(0.05), 0.6), 0),
}


def _fill_slots(init, rng):
    """Slot leaves as a trained table holds them: accumulators > 0, the
    decay's last periods 0..2 (a row two periods behind catches up on
    both), moments of either sign, beta powers some steps along."""
    def leaf(name, x):
        x = np.asarray(x)
        if x.ndim == 0:
            return np.asarray(x * 0.9 ** 3, np.float32)  # three applies in
        if x.dtype == np.int32:
            return rng.integers(0, 3, x.shape).astype(np.int32)
        if "acc" in name:
            return rng.uniform(0.05, 2.0, x.shape).astype(np.float32)
        if "'v'" in name:
            return rng.uniform(0.0, 0.1, x.shape).astype(np.float32)
        return (0.1 * rng.normal(size=x.shape)).astype(np.float32)
    return [leaf(n, x) for n, x in jformat.slot_leaf_names(init)]


def _unflatten(tree, leaves):
    """``leaves`` in the flatten order of the dict tree ``tree``."""
    it = iter(leaves)

    def rec(t):
        if isinstance(t, dict):
            return {k: rec(t[k]) for k in sorted(t)}
        if isinstance(t, tuple):
            return tuple(rec(v) for v in t)
        return next(it)
    return rec(tree)


@pytest.mark.parametrize("cur", [False, True], ids=["stored", "cur_rows"])
@pytest.mark.parametrize("case", list(CASES))
def test_sparse_optimizer_step_matches_jax(case, cur):
    make, fused = CASES[case]
    jopt, topt = make(jsopt), make(tsopt)
    assert topt.name == jopt.name and topt.fills == jopt.fills
    rng = np.random.default_rng(len(case) + 7 * cur)
    width = DIM * (1 + fused)
    values = rng.normal(size=(CAP + 1, width)).astype(np.float32)
    if fused:
        values[:, DIM + DIM:] = rng.uniform(0.0, 0.1, (CAP + 1, DIM))
    values[CAP] = 0.0                      # the null row
    slots = rng.permutation(CAP)[:U].astype(np.int32)
    slots[-4:] = CAP                       # overflow lanes: the null row
    mask = rng.random(U) < 0.8
    mask[-4:] = False                      # ... never admitted
    created = rng.random(U) < 0.3
    grads = rng.normal(size=(U, DIM)).astype(np.float32)
    cur_rows = rng.normal(size=(U, DIM)).astype(np.float32) if cur else None

    # init: the same leaves under the same save names, dtypes included
    jinit = jopt.init(jnp.asarray(values))
    tinit = topt.init(torch.from_numpy(values))
    jnames = jformat.slot_leaf_names(jinit)
    tnames = tformat.slot_leaf_names(tinit)
    assert [n for n, _ in tnames] == [n for n, _ in jnames]
    for (_, a), (_, b) in zip(tnames, jnames):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.numpy(), b)

    slot = _fill_slots(jinit, rng)
    jv, js = jopt.apply(
        jnp.asarray(values), _unflatten(jinit, [jnp.asarray(x)
                                                for x in slot]),
        jnp.asarray(slots), jnp.asarray(grads), jnp.asarray(mask),
        jnp.asarray(STEP, jnp.int32),
        cur_rows=None if cur_rows is None else jnp.asarray(cur_rows),
        created=jnp.asarray(created))
    tv, ts = topt.apply(
        torch.from_numpy(values.copy()),
        _unflatten(tinit, [torch.from_numpy(x.copy()) for x in slot]),
        torch.from_numpy(slots), torch.from_numpy(grads),
        torch.from_numpy(mask), STEP,
        cur_rows=None if cur_rows is None else torch.from_numpy(cur_rows),
        created=torch.from_numpy(created))
    got = [("values", tv)] + tformat.slot_leaf_names(ts)
    ref = [("values", jv)] + jformat.slot_leaf_names(js)
    assert [n for n, _ in got] == [n for n, _ in ref]
    for (name, a), (_, b) in zip(got, ref):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.dtype.kind == "i":
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=RTOL * np.abs(b).max(),
                                       err_msg=name)
    # masked lanes and untouched rows keep their values and slot rows
    keep = np.ones(CAP + 1, bool)
    keep[slots[mask]] = False
    np.testing.assert_array_equal(tv.numpy()[keep], values[keep])
    for (name, a), b in zip(tformat.slot_leaf_names(ts), slot):
        if b.ndim:
            np.testing.assert_array_equal(a.numpy()[keep], b[keep],
                                          err_msg=name)
    assert (tv.numpy()[~keep] != values[~keep]).any()


def test_adagrad_decay_catches_up_lazily():
    """Across a period boundary: a row last updated two periods ago decays
    twice (rate^2), one a period ago once, a current one not at all, and
    each row's last_period moves to the current period."""
    opt = tsopt.sparse_adagrad_decay(0.1, accumulator_decay_step=10,
                                     accumulator_decay_rate=0.5,
                                     accumulator_baseline=1e-7)
    values = torch.zeros(5, 1)
    slot = opt.init(values)
    slot["acc"].fill_(4.0)
    slot["last_period"].copy_(torch.tensor([0, 1, 2, 2, 0],
                                           dtype=torch.int32))
    slots = torch.tensor([0, 1, 2], dtype=torch.int32)
    grads = torch.zeros(3, 1)
    opt.apply(values, slot, slots, grads, torch.ones(3, dtype=torch.bool),
              20)
    np.testing.assert_array_equal(slot["acc"][:3, 0].numpy(),
                                  [1.0, 2.0, 4.0])
    np.testing.assert_array_equal(slot["last_period"].numpy(),
                                  [2, 2, 2, 2, 0])


@pytest.mark.parametrize("name", sorted(jsopt.REGISTRY))
def test_registry_builds_every_jax_name(name):
    """``make`` builds each of the JAX package's twelve names, with the
    JAX optimizer's name, fills and slot leaves."""
    assert set(tsopt.REGISTRY) == set(jsopt.REGISTRY)
    topt = tsopt.make(name, learning_rate=0.01)
    jopt = jsopt.make(name, learning_rate=0.01)
    assert topt.name == jopt.name and topt.fills == jopt.fills
    values = np.zeros((9, 3), np.float32)
    tl = tformat.slot_leaf_names(topt.init(torch.from_numpy(values)))
    jl = jformat.slot_leaf_names(jopt.init(jnp.asarray(values)))
    assert [(n, tuple(x.shape), x.numpy().dtype) for n, x in tl] == \
        [(n, tuple(np.shape(x)), np.asarray(x).dtype) for n, x in jl]


@pytest.mark.parametrize("name", ["adagrad_decay", "adam_async", "sgd"])
def test_permute_slot_state_matches_jax(name):
    """Growth and compaction carry an int32 row leaf (fresh rows take fill
    0), pass 0-d leaves through and leave an empty state empty, as the JAX
    package does."""
    from deeprec_tpu.optim.sparse import permute_slot_state as jperm
    rng = np.random.default_rng(3)
    jopt, topt = jsopt.make(name), tsopt.make(name)
    values = np.zeros((CAP + 1, DIM), np.float32)
    jinit = jopt.init(jnp.asarray(values))
    slot = _fill_slots(jinit, rng)
    o2n = np.full(CAP, 2 * CAP + 1, np.int64)
    keep = rng.permutation(CAP)[:CAP // 2]
    o2n[keep] = rng.permutation(2 * CAP)[:keep.size]
    jout = jperm(_unflatten(jinit, [jnp.asarray(x) for x in slot]),
                 jnp.asarray(o2n), 2 * CAP, fills=jopt.fills)
    tout = tsopt.permute_slot_state(
        _unflatten(topt.init(torch.from_numpy(values)),
                   [torch.from_numpy(x) for x in slot]),
        torch.from_numpy(o2n), 2 * CAP, fills=topt.fills)
    got, ref = tformat.slot_leaf_names(tout), jformat.slot_leaf_names(jout)
    assert [n for n, _ in got] == [n for n, _ in ref]
    for (n, a), (_, b) in zip(got, ref):
        assert a.numpy().dtype == np.asarray(b).dtype, n
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=n)
