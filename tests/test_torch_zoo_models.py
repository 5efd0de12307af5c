"""Port parity for the CTR zoo's dense side: the torch CrossNetV2 (full
and low-rank), FMInteraction, DCN, WDL, DeepFM and DSSM with flax weights
carried across by load_flax_params give the flax modules' outputs, and
the weights round-trip bit-exactly in the flax flatten order;
structured_forward gives the JAX one's scores; the SyntheticBehavior copy
is its source."""
import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeprec_tpu.data import behavior as jbehavior
from deeprec_tpu.models import ctr as jctr
from deeprec_tpu.models import layers as jlayers
from deeprec_tpu.models import structured as jstructured

from deeprec_tpu_torch.data import behavior as tbehavior
from deeprec_tpu_torch.models import ctr as tctr
from deeprec_tpu_torch.models import layers as tlayers
from deeprec_tpu_torch.models import structured as tstructured

torch.set_num_threads(1)

NAMES = ["C1", "C2", "C3"]
WIDE = ["W1", "W2", "W3"]
DIM, DENSE, B = 4, 3, 16
# (rtol, atol): f32 products and sums in another order; 11 cross layers
# compound the relative error of each product, and DSSM's cosine is
# scaled by 1 / temperature = 20
TOL = {"cross": (1e-4, 1e-5), "dssm": (0, 1e-4)}
DEFAULT_TOL = (0, 1e-5)


def _models(kind):
    """(flax module, torch module, model inputs)."""
    x0 = DENSE + len(NAMES) * DIM
    if kind == "cross":  # 11 layers: w_10 flattens before w_2
        return (jlayers.CrossNetV2(num_layers=11),
                tlayers.CrossNetV2(x0, num_layers=11), "x0")
    if kind == "cross_low_rank":
        return (jlayers.CrossNetV2(num_layers=3, low_rank=2),
                tlayers.CrossNetV2(x0, num_layers=3, low_rank=2), "x0")
    if kind == "fm":
        return jlayers.FMInteraction(), tlayers.FMInteraction(), "feats"
    if kind == "dcn":
        return (jctr.DCN(emb_names=NAMES, cross_layers=3, deep_units=(8, 6)),
                tctr.DCN(NAMES, DIM, cross_layers=3, deep_units=(8, 6),
                         dense_dim=DENSE), "model")
    if kind == "dcn_low_rank":
        return (jctr.DCN(emb_names=NAMES, cross_layers=2, low_rank=3,
                         deep_units=(8,)),
                tctr.DCN(NAMES, DIM, cross_layers=2, low_rank=3,
                         deep_units=(8,), dense_dim=DENSE), "model")
    if kind == "wdl":
        return (jctr.WDL(emb_names=NAMES, wide_names=WIDE, deep_units=(8, 6)),
                tctr.WDL(NAMES, WIDE, DIM, deep_units=(8, 6),
                         dense_dim=DENSE), "model")
    if kind == "deepfm":
        return (jctr.DeepFM(emb_names=NAMES, wide_names=WIDE,
                            deep_units=(8, 8, 8)),
                tctr.DeepFM(NAMES, WIDE, DIM, deep_units=(8, 8, 8),
                            dense_dim=DENSE), "model")
    if kind == "dssm":
        return (jctr.DSSM(user_emb_names=["C1", "C3"], item_emb_names=["C2"],
                          tower_units=(8, 6), out_dim=5),
                tctr.DSSM(["C1", "C3"], ["C2"], DIM, tower_units=(8, 6),
                          out_dim=5), "model")
    raise ValueError(kind)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(B, DENSE)).astype(np.float32)
    emb = {n: rng.normal(size=(B, DIM)).astype(np.float32) for n in NAMES}
    wide = {n: rng.normal(size=(B, 1)).astype(np.float32) for n in WIDE}
    return dense, emb, wide


def _args(kind, what, dense, emb, wide, t):
    """The positional and keyword inputs of one side (``t``: torch)."""
    conv = torch.from_numpy if t else jnp.asarray
    cv = {k: conv(v) for k, v in emb.items()}
    if what == "x0":
        return (conv(np.concatenate([dense] + [emb[n] for n in NAMES], -1)),
                ), {}
    if what == "feats":
        return (conv(np.stack([emb[n] for n in NAMES], 1)),), {}
    d = None if kind == "dssm" else conv(dense)
    kw = {"train": False}
    if kind in ("wdl", "deepfm"):
        kw["wide"] = {k: conv(v) for k, v in wide.items()}
    return (d, cv), kw


def _jax_paths(params):
    return [jax.tree_util.keystr(p).replace("['params']", "", 1)
            for p, _ in jax.tree_util.tree_flatten_with_path(params)[0]]


@pytest.mark.parametrize("kind", ["cross", "cross_low_rank", "fm", "dcn",
                                  "dcn_low_rank", "wdl", "deepfm", "dssm"])
def test_forward_matches_flax(kind):
    jm, tm, what = _models(kind)
    dense, emb, wide = _inputs()
    ja, jkw = _args(kind, what, dense, emb, wide, False)
    ta, tkw = _args(kind, what, dense, emb, wide, True)
    params = jm.init(jax.random.key(0), *ja, **jkw)
    leaves = jax.tree_util.tree_leaves(params)
    if kind in ("wdl", "deepfm"):  # the scalar bias, last, initialised 0
        leaves[-1] = jnp.asarray(0.25, jnp.float32)
        params = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(params), leaves)
    if what != "feats":  # FMInteraction has no parameters
        tctr.load_flax_params(tm, [np.asarray(x) for x in leaves])
    ref = np.asarray(jm.apply(params, *ja, **jkw))
    with torch.no_grad():
        got = tm(*ta, **tkw).numpy()
    assert got.shape == ref.shape
    rtol, atol = TOL.get(kind, DEFAULT_TOL)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)

    if what == "feats":
        return
    # the weights round-trip exactly, in flax's flatten order and names
    back = tctr.flax_leaves(tm)
    assert len(back) == len(leaves)
    for a, b in zip(back, leaves):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, np.asarray(b))
    assert [p for p, _, _ in tctr._flax_params(tm)] == _jax_paths(params)
    # and the optimizer-state carry is the identity on them
    per_param = tctr.load_flax_state(tm, back)
    for a, p in zip(per_param, tm.parameters()):
        assert torch.equal(a, p.detach())
    for a, b in zip(tctr.flax_state_leaves(tm, per_param), back):
        np.testing.assert_array_equal(a, b)


def test_dssm_all_zero_tower_input_has_a_finite_gradient():
    """An all-zero tower input (padding and overflow rows are zeros) with
    the zero biases of a flax init gives a zero tower output: the smooth
    norm keeps the gradient finite where ``linalg.norm`` gives NaN."""
    jm, tm, _ = _models("dssm")
    dense, emb, _ = _inputs()
    emb = {k: np.zeros_like(v) for k, v in emb.items()}
    cv = {k: jnp.asarray(v) for k, v in emb.items()}
    params = jm.init(jax.random.key(1), None, cv, train=False)
    tctr.load_flax_params(tm, [np.asarray(x) for x in
                               jax.tree_util.tree_leaves(params)])
    temb = {k: torch.from_numpy(v).requires_grad_(True)
            for k, v in emb.items()}
    out = tm(None, temb)
    out.sum().backward()
    jgrads = jax.grad(lambda p, e: jm.apply(p, None, e, train=False).sum(),
                      argnums=(0, 1))(params, cv)
    for g in [p.grad for p in tm.parameters()] + \
            [t.grad for t in temb.values()]:
        assert g is not None and bool(torch.isfinite(g).all())
    for a, b in zip(tctr.flax_state_leaves(tm, [p.grad for p in
                                                tm.parameters()]),
                    jax.tree_util.tree_leaves(jgrads[0])):
        # a gradient through rsqrt(1e-12) = 1e6: compare relatively
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-3)
    for k in emb:
        np.testing.assert_allclose(temb[k].grad.numpy(),
                                   np.asarray(jgrads[1][k]), rtol=1e-5,
                                   atol=1e-3)


@pytest.mark.parametrize("tree", [False, True], ids=["tensor", "dict"])
def test_structured_forward_matches_jax(tree):
    """Mirrors tests/test_api_misc.py: the user tower runs once per
    request; the scores equal the JAX function's."""
    calls = {"user": 0}
    b, i, d = 4, 6, 8

    def user_fn(x):
        calls["user"] += 1
        return x * 2.0

    def item_fn(x):
        return (x["a"] + x["b"] if tree else x) + 1.0

    u_in = np.ones((b, d), np.float32)
    i_in = np.arange(b * i * d, dtype=np.float32).reshape(b, i, d)
    items = ({"a": i_in, "b": 0.5 * i_in} if tree else i_in)
    conv_t = ({k: torch.from_numpy(v) for k, v in items.items()} if tree
              else torch.from_numpy(items))
    conv_j = ({k: jnp.asarray(v) for k, v in items.items()} if tree
              else jnp.asarray(items))
    got = tstructured.structured_forward(user_fn, item_fn,
                                         tstructured.dot_head,
                                         torch.from_numpy(u_in), conv_t)
    assert got.shape == (b, i) and calls["user"] == 1
    ref = jstructured.structured_forward(user_fn, item_fn,
                                         jstructured.dot_head,
                                         jnp.asarray(u_in), conv_j)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_behavior_copy_is_byte_identical(seed):
    kw = dict(batch_size=256, seed=seed)
    for a, b in zip(jbehavior.SyntheticBehavior(**kw).take(3),
                    tbehavior.SyntheticBehavior(**kw).take(3)):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            assert a[k].tobytes() == b[k].tobytes()
    assert tbehavior.FEATURES == jbehavior.FEATURES
    assert inspect.getsource(tbehavior.SyntheticBehavior) == \
        inspect.getsource(jbehavior.SyntheticBehavior)
