"""The GRU and AUGRU recurrence kernels (``ops/recurrence.py`` over
``csrc/gru_scan.cu``) against the modules' loop (``GRU._scan``,
``AUGRU._scan``), on the card: the states or the last state, and the
gradients of the input, the attention weights and the four parameters,
for masks with all-padded, length-1 and full-length rows and with holes, a
batch that is not a multiple of the kernels' 16-row tile, DIEN's widths
36/36 and the zoo tests' 8/16; a no-grad forward; two backward calls
bit-equal; one launch each way a call; the wrapper's refusals. A CUDA kernel
has no CPU mode, so those tests skip without a card. On the CPU the modules
run their loop and launch nothing, and the wrapper refuses a CPU tensor
and, before any launch, what the kernels do not take. This file imports no
JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_recurrence_cuda.py
"""
import pytest
import torch

from deeprec_tpu_torch.models.layers import AUGRU, GRU
from deeprec_tpu_torch.ops import recurrence
from deeprec_tpu_torch.ops.recurrence import gru_scan, gru_scan_backward

B, L = 37, 20  # 37: two whole 16-row tiles and a ragged one
# kernel against the loop: float32 sums in another order (over d + g terms
# a step, along up to L steps, and over all B L positions for the weights'
# gradients), so each reading is held to 1e-4 of its own magnitude plus
# 1e-5 of the tensor's largest; a wrong gate, mask or step is off by O(1)
RTOL, SCALE_ATOL = 1e-4, 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the recurrence kernels have no CPU "
                    "mode")
    return torch.device("cuda")


def _mask(case, b=B, seed=0):
    g = torch.Generator().manual_seed(seed)
    if case == "lengths":  # right-padded: none, 1, all, then random
        lens = torch.randint(1, L + 1, (b,), generator=g)
        lens[:3] = torch.tensor([0, 1, L])
        return torch.arange(L)[None, :] < lens[:, None]
    mask = torch.rand(b, L, generator=g) < 0.6  # holes anywhere
    mask[0], mask[1] = False, True
    return mask


def _inputs(d, case, device, b=B, seed=0):
    g = torch.Generator().manual_seed(seed + 1)
    xs = torch.randn(b, L, d, generator=g) * 0.5
    att = torch.rand(b, L, generator=g)
    return (xs.to(device).requires_grad_(True),
            att.to(device).requires_grad_(True),
            _mask(case, b, seed).to(device))


def _module(kind, d, g, device):
    torch.manual_seed(0)
    return (GRU(d, g) if kind == "gru" else AUGRU(d, g)).to(device)


def _call(m, kind, xs, att, mask):
    return m(xs, mask) if kind == "gru" else m(xs, att, mask)


def _loop(m, kind, xs, att, mask):
    return m._scan(xs, mask) if kind == "gru" else m._scan(xs, att, mask)


def _step(m, kind, run, xs, att, mask):
    """Output, the input gradients and the parameters' ``.grad`` of one
    forward and backward under a fixed upstream gradient."""
    m.zero_grad(set_to_none=True)
    xs.grad = att.grad = None
    out = run(m, kind, xs, att, mask)
    up = torch.linspace(-1, 1, out.numel(), device=out.device).view_as(out)
    (out * up).sum().backward()
    grads = [xs.grad] + ([att.grad] if kind == "augru" else [])
    return [out.detach()] + grads + [p.grad.clone() for p in m.parameters()]


def _close(got, ref):
    scale = ref.abs().max().item()
    torch.testing.assert_close(got, ref, rtol=RTOL, atol=SCALE_ATOL * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gru", "augru"])
@pytest.mark.parametrize("widths", [(36, 36), (8, 16)])
@pytest.mark.parametrize("case", ["lengths", "holes"])
def test_kernels_match_the_loop(cuda, kind, widths, case):
    d, g = widths
    m = _module(kind, d, g, cuda)
    xs, att, mask = _inputs(d, case, cuda)
    want = _step(m, kind, _loop, xs, att, mask)
    got = _step(m, kind, _call, xs, att, mask)
    for w, x in zip(want, got):
        _close(x, w)
    # a padded position passes nothing into the input or the attention
    assert not got[1][~mask].any()
    if kind == "augru":
        assert not got[2][~mask].any()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gru", "augru"])
def test_no_grad_forward_is_the_training_forward(cuda, kind):
    m = _module(kind, 36, 36, cuda)
    xs, att, mask = _inputs(36, "lengths", cuda)
    trained = _call(m, kind, xs, att, mask).detach()
    fwd, bwd = gru_scan.launches, gru_scan_backward.launches
    with torch.no_grad():
        out = _call(m, kind, xs, att, mask)
        ref = _loop(m, kind, xs, att, mask)
    assert (gru_scan.launches, gru_scan_backward.launches) == (fwd + 1, bwd)
    assert torch.equal(out, trained)
    _close(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gru", "augru"])
def test_two_backward_calls_are_bit_equal(cuda, kind):
    m = _module(kind, 36, 36, cuda)
    xs, att, mask = _inputs(36, "holes", cuda, b=300)
    first = _step(m, kind, _call, xs, att, mask)
    second = _step(m, kind, _call, xs, att, mask)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gru", "augru"])
def test_launches_move_once_per_call(cuda, kind):
    m = _module(kind, 8, 16, cuda)
    xs, att, mask = _inputs(8, "lengths", cuda)
    fwd, bwd = gru_scan.launches, gru_scan_backward.launches
    _step(m, kind, _call, xs, att, mask)
    assert (gru_scan.launches, gru_scan_backward.launches) == (fwd + 1,
                                                              bwd + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["float64", "d over the cap",
                                  "g over the cap"])
def test_the_card_refuses(cuda, what):
    d = recurrence.MAX_WIDTH + 1 if what == "d over the cap" else 8
    g = recurrence.MAX_WIDTH + 1 if what == "g over the cap" else 16
    m = _module("gru", d, g, cuda)
    xs, _, mask = _inputs(d, "lengths", cuda)
    if what == "float64":
        m, xs = m.double(), xs.double()
    with pytest.raises(ValueError):
        m(xs, mask)


@pytest.mark.parametrize("kind", ["gru", "augru"])
def test_module_runs_its_loop_on_the_cpu(kind):
    m = _module(kind, 8, 16, "cpu")
    xs, att, mask = _inputs(8, "holes", "cpu")
    fwd, bwd = gru_scan.launches, gru_scan_backward.launches
    want = _step(m, kind, _loop, xs, att, mask)
    got = _step(m, kind, _call, xs, att, mask)
    for w, x in zip(want, got):
        assert torch.equal(w, x)
    assert (gru_scan.launches, gru_scan_backward.launches) == (fwd, bwd)


def _cpu_args(what):
    """Arguments of ``gru_scan`` that it refuses before any launch."""
    d, g = 8, 16
    if what == "d over the cap":
        d = recurrence.MAX_WIDTH + 1
    if what == "g over the cap":
        g = recurrence.MAX_WIDTH + 1
    cell = _module("gru", d, g, "cpu").cell
    weights = tuple(w.detach() for w in cell.weights())
    xs, att, mask = (t.detach() for t in _inputs(d, "lengths", "cpu"))
    if what == "float64":
        xs = xs.double()
    if what == "mask not bool":
        mask = mask.float()
    if what == "att of another shape":
        att = att[:, 1:]
    if what == "weights of other widths":
        weights = (weights[0][:, 1:], *weights[1:])
    return xs, mask, weights, att


@pytest.mark.parametrize("what", [
    "a CPU tensor", "float64", "d over the cap", "g over the cap",
    "mask not bool", "att of another shape", "weights of other widths"])
def test_the_wrapper_refuses(what):
    xs, mask, weights, att = _cpu_args(what)
    fwd = gru_scan.launches
    with pytest.raises(ValueError):
        gru_scan(xs, mask, weights, att)
    assert gru_scan.launches == fwd
