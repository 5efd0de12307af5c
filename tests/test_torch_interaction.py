"""DLRM's dot interaction (``deeprec_tpu_torch.ops.interaction``) on the
CPU: the op's forward and backward against the JAX package's
``DotInteraction`` and its ``jax.vjp``; the backward formula the card
kernel computes (``d_feats[b, i] = sum over j != i, ascending, of g(i, j)
feats[b, j]``) against autograd through ``bmm`` and the ``tril_indices``
gather at float64; ``DotInteractionFunction``'s autograd wiring against
today's gradients. The kernels themselves are tested on the card in
``test_torch_kernels_cuda.py``."""
import jax
import numpy as np
import pytest
import torch

from deeprec_tpu.models.layers import DotInteraction as JDot

from deeprec_tpu_torch.models.layers import DotInteraction as TDot
from deeprec_tpu_torch.ops import interaction
from deeprec_tpu_torch.ops.interaction import (
    DotInteractionFunction, dot_interaction, dot_interaction_backward,
    dot_interaction_plain, interact)

torch.set_num_threads(1)

# (B, F, d): a small odd shape, the benchmark's 27 x 16, the MLPerf width,
# and an empty batch
CASES = [(4, 6, 3), (5, 27, 16), (3, 27, 128), (0, 27, 16)]
IDS = [f"B{b}_F{f}_d{d}" for b, f, d in CASES]


def _feats(b, f, d, seed=0, dtype=np.float32):
    return np.random.default_rng(seed).normal(size=(b, f, d)).astype(dtype)


def _grad(b, f, seed, dtype=np.float32):
    return _feats(b, f * (f - 1) // 2, 1, seed, dtype)[..., 0]


def _pair(i, j):
    return i * (i - 1) // 2 + j if j < i else j * (j - 1) // 2 + i


def _kernel_order_backward(feats, g):
    """The backward kernel's formula, in its order: j ascending, j != i."""
    out = torch.zeros_like(feats)
    f = feats.shape[1]
    for i in range(f):
        for j in range(f):
            if j != i:
                out[:, i] += g[:, _pair(i, j), None] * feats[:, j]
    return out


def _autograd_backward(feats, g):
    """Today's gradient: autograd through the ``bmm`` and the gather."""
    x = feats.detach().clone().requires_grad_(True)
    dot_interaction_plain(x).backward(g)
    return x.grad


def _within(got, ref, mag, rtol):
    """``got`` within ``rtol`` of the magnitudes its sums add (``mag``)."""
    assert got.shape == ref.shape
    assert bool(((got - ref).abs() <= rtol * mag).all()), \
        float((got - ref).abs().max())


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_forward_matches_flax(case):
    feats = _feats(*case)
    ref = np.array(JDot().apply({}, feats))
    t = torch.from_numpy(feats)
    got = interact(t)
    assert tuple(got.shape) == ref.shape == (case[0], case[1] * (case[1] - 1)
                                             // 2)
    mag = dot_interaction_plain(t.abs())
    _within(got, torch.from_numpy(ref), mag, 1e-5)
    assert torch.equal(TDot()(t), got)  # the module runs the op


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_backward_matches_flax_vjp(case):
    """The kernel's formula and the module's CPU gradient against
    ``jax.vjp`` of the JAX ``DotInteraction`` on the same inputs and
    cotangent."""
    b, f, _ = case
    feats, g = _feats(*case, seed=3), _grad(b, f, seed=4)
    _, vjp = jax.vjp(lambda x: JDot().apply({}, x), feats)
    ref = torch.from_numpy(np.array(vjp(g)[0]))
    tf, tg = torch.from_numpy(feats), torch.from_numpy(g)
    mag = _autograd_backward(tf.abs(), tg.abs())
    _within(_kernel_order_backward(tf, tg), ref, mag, 1e-5)
    x = tf.clone().requires_grad_(True)
    TDot()(x).backward(tg)
    _within(x.grad, ref, mag, 1e-5)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_backward_formula_matches_autograd(case):
    b, f, _ = case
    feats = torch.from_numpy(_feats(*case, dtype=np.float64))
    g = torch.from_numpy(_grad(b, f, seed=1, dtype=np.float64))
    ref = _autograd_backward(feats, g)
    mag = _autograd_backward(feats.abs(), g.abs())
    _within(_kernel_order_backward(feats, g), ref, mag, 1e-12)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_function_gradients_match_today(case, monkeypatch):
    """``DotInteractionFunction`` with the kernels' wrappers swapped for
    the plain forward and the kernel's formula (the kernels need a card):
    its output and gradients equal today's autograd."""
    b, f, _ = case
    feats = torch.from_numpy(_feats(*case))
    g = torch.from_numpy(_grad(b, f, seed=2))
    calls = []
    monkeypatch.setattr(interaction, "dot_interaction",
                        lambda x: calls.append("f") or
                        dot_interaction_plain(x))
    monkeypatch.setattr(interaction, "dot_interaction_backward",
                        lambda x, gr: calls.append("b") or
                        _kernel_order_backward(x, gr))
    x = feats.clone().requires_grad_(True)
    y = DotInteractionFunction.apply(x)
    assert torch.equal(y, dot_interaction_plain(feats))
    y.backward(g)
    assert calls == ["f", "b"]
    ref = _autograd_backward(feats, g)
    mag = _autograd_backward(feats.abs(), g.abs())
    _within(x.grad, ref, mag, 1e-5)
    # the module on the CPU: today's ops under autograd, unchanged
    x2 = feats.clone().requires_grad_(True)
    TDot()(x2).backward(g)
    assert torch.equal(x2.grad, ref)
    assert calls == ["f", "b"]


@pytest.mark.parametrize("shape,dtype", [((2, 65, 16), torch.float32),
                                         ((2, 6, 12), torch.float32),
                                         ((2, 6, 16), torch.float64)],
                         ids=["F65", "d12", "float64"])
def test_kernel_limits_hold_on_the_card_only(shape, dtype):
    """Off the card every shape and dtype runs the plain version under
    autograd; on a CUDA tensor a dtype other than float32 raises and any
    F and d run the kernels (``test_torch_kernels_cuda.py``)."""
    feats = torch.randn(*shape, dtype=dtype, requires_grad=True)
    out = interact(feats)
    assert torch.equal(out, dot_interaction_plain(feats))
    out.sum().backward()
    assert feats.grad.shape == feats.shape


def test_cpu_path_launches_no_kernel():
    before = (dot_interaction.launches, dot_interaction_backward.launches)
    x = torch.randn(3, 27, 16, requires_grad=True)
    interact(x).sum().backward()
    assert (dot_interaction.launches,
            dot_interaction_backward.launches) == before


def test_backward_rejects_a_misshapen_gradient():
    feats = torch.randn(3, 6, 4)
    with pytest.raises(ValueError):
        dot_interaction_backward(feats, torch.randn(3, 14))


@pytest.mark.parametrize("call", ["forward", "backward"])
def test_kernel_wrappers_refuse_a_cpu_tensor(call):
    """The wrappers launch kernels only: a CPU tensor takes
    ``dot_interaction_plain`` (or ``interact``)."""
    feats = torch.randn(3, 6, 4)
    with pytest.raises(ValueError):
        if call == "forward":
            dot_interaction(feats)
        else:
            dot_interaction_backward(feats, torch.randn(3, 15))
