"""DIN's attention unit as hand-written kernels (``ops/din_attention.py``
over ``csrc/din_attention.cu``) against the module's plain code
(``DINAttention._plain``), on the card: the weights and the gradients of
the query, the keys and the six parameters, for DIN (scores over sqrt(g))
and DIEN's ``DINAttentionScores`` (unscaled), with all-padded, length-1
and full-length rows and with holes, a batch that is not a multiple of
the kernels' 32-example block, DIEN's widths 36 / 80-40, the zoo tests'
8 / 16-8, widths that are not multiples of 4 and the widest the kernels
take (40 / 80-40); the benchmark cell's shape [16,384, 100, 36] with its
traffic's lengths; a no-grad forward; two backward calls bit-equal; one
launch each way a call; the module's and the wrapper's refusals of what
the kernels do not take. A CUDA kernel
has no CPU mode, so those tests skip without a card. This file imports no
JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_din_attention_cuda.py
"""
import json
import math
import os

import pytest
import torch

from deeprec_tpu_torch.models.layers import DINAttention
from deeprec_tpu_torch.models.sequence import DINAttentionScores
from deeprec_tpu_torch.ops import din_attention as da
from deeprec_tpu_torch.ops.din_attention import (din_attention,
                                                 din_attention_backward)

B, L = 37, 20  # 37: a whole 32-example block and a ragged one
# kernels against the plain code: float32 sums in another order (the first
# layer regrouped into the query's share and the key's, the parameter
# gradients over every valid position, the softmax's sums over a row), so
# each reading is held to 1e-4 of its own magnitude plus 1e-5 of the
# tensor's largest; a wrong weight, mask or position is off by O(1)
RTOL, SCALE_ATOL = 1e-4, 1e-5
# att_out's bias gradient is the sum of every score's gradient, zero but
# for round-off (a row's score gradients sum to 0): held to this share of
# the sum of their magnitudes
DB3_SHARE = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the attention kernels have no CPU "
                    "mode")
    return torch.device("cuda")


def _module(kind, g, hidden, device):
    torch.manual_seed(0)
    m = (DINAttention if kind == "din" else DINAttentionScores)(g, hidden)
    with torch.no_grad():  # scores spread over a few units, not ~0
        for p in m.parameters():
            p.mul_(3.0)
    return m.to(device)


def _mask(case, b, length, seed=0):
    g = torch.Generator().manual_seed(seed)
    if case == "lengths":  # right-padded: none, 1, all, then random
        lens = torch.randint(1, length + 1, (b,), generator=g)
        lens[:3] = torch.tensor([0, 1, length])
        return torch.arange(length)[None, :] < lens[:, None]
    mask = torch.rand(b, length, generator=g) < 0.4  # holes anywhere
    mask[0], mask[1] = False, True
    return mask


def _inputs(g, mask, device, seed=0):
    gen = torch.Generator().manual_seed(seed + 1)
    b, length = mask.shape
    q = torch.randn(b, g, generator=gen)
    k = torch.randn(b, length, g, generator=gen)
    return (q.to(device).requires_grad_(True),
            k.to(device).requires_grad_(True), mask.to(device))


def _params(m):
    return (m.att[0].weight, m.att[0].bias, m.att[1].weight, m.att[1].bias,
            m.att_out.weight, m.att_out.bias)


def _step(m, run, q, k, mask, up):
    """The weights, the query's and the keys' gradients and the
    parameters' ``.grad`` of one forward and backward under ``up``."""
    m.zero_grad(set_to_none=True)
    q.grad = k.grad = None
    w = run(q, k, mask)
    (w * up).sum().backward()
    return [w.detach(), q.grad, k.grad] + [p.grad.clone()
                                           for p in _params(m)]


def _up(mask, seed=2):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(mask.shape, generator=gen).to(mask.device)


def _held(m, got, want, up, mask, k):
    """Every reading within RTOL and SCALE_ATOL of the plain code's; the
    bias of att_out within DB3_SHARE of its terms' magnitudes."""
    w = want[0]
    scale = 1.0 / math.sqrt(k.shape[-1]) if m.scaled else 1.0
    ds = w * (up - (w * up).sum(1, keepdim=True)) * scale
    for i, (x, ref) in enumerate(zip(got, want)):
        if i == len(want) - 1:
            assert (x - ref).abs().item() <= DB3_SHARE * ds.abs().sum()
            continue
        torch.testing.assert_close(
            x, ref, rtol=RTOL, atol=SCALE_ATOL * ref.abs().max().item())
    # a padded position takes no weight and passes nothing to its key
    assert not got[0][~mask].any()
    assert not got[2][~mask].any()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["din", "scores"])
@pytest.mark.parametrize("widths", [(36, (80, 40)), (8, (16, 8)),
                                    (13, (7, 3)), (40, (80, 40))])
@pytest.mark.parametrize("case", ["lengths", "holes"])
def test_kernels_match_the_plain_code(cuda, kind, widths, case):
    g, hidden = widths
    m = _module(kind, g, hidden, cuda)
    q, k, mask = _inputs(g, _mask(case, B, L), cuda)
    up = _up(mask)
    want = _step(m, m._plain, q, k, mask, up)
    got = _step(m, m.weights, q, k, mask, up)
    _held(m, got, want, up, mask, k)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["din", "scores"])
def test_at_the_cells_shape(cuda, kind):
    """[16,384, 100, 36], the lengths drawn as the DIEN cell's traffic
    draws them (4-100, 13.8 % of the positions valid)."""
    from perfbench.generators.behavior import lengths

    with open(os.path.join(REPO, "perfbench", "traffic",
                           "amazon_books_behavior.json")) as f:
        mix = json.load(f)
    b, length, g = 16384, 100, 36
    gen = torch.Generator().manual_seed(3)
    lens = lengths(mix, torch.rand(b, generator=gen, dtype=torch.float64))
    mask = torch.arange(length)[None, :] < lens[:, None]
    m = _module(kind, g, (80, 40), cuda)
    q, k, mask = _inputs(g, mask, cuda, seed=3)
    up = _up(mask)
    want = _step(m, m._plain, q, k, mask, up)
    got = _step(m, m.weights, q, k, mask, up)
    _held(m, got, want, up, mask, k)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["din", "scores"])
def test_no_grad_forward_is_the_training_forward(cuda, kind):
    m = _module(kind, 36, (80, 40), cuda)
    q, k, mask = _inputs(36, _mask("lengths", B, L), cuda)
    trained = m.weights(q, k, mask).detach()
    fwd, bwd = din_attention.launches, din_attention_backward.launches
    with torch.no_grad():
        out = m.weights(q, k, mask)
    assert (din_attention.launches, din_attention_backward.launches) == (
        fwd + 1, bwd)
    assert torch.equal(out, trained)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["din", "scores"])
def test_two_backward_calls_are_bit_equal(cuda, kind):
    m = _module(kind, 36, (80, 40), cuda)
    q, k, mask = _inputs(36, _mask("holes", 300, 50), cuda)
    up = _up(mask)
    first = _step(m, m.weights, q, k, mask, up)
    second = _step(m, m.weights, q, k, mask, up)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_launches_move_once_per_call(cuda):
    m = _module("scores", 8, (16, 8), cuda)
    q, k, mask = _inputs(8, _mask("lengths", B, L), cuda)
    fwd, bwd = din_attention.launches, din_attention_backward.launches
    _step(m, m.weights, q, k, mask, _up(mask))
    assert (din_attention.launches, din_attention_backward.launches) == (
        fwd + 1, bwd + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["float64", "g over the cap",
                                  "hidden over the cap", "three layers",
                                  "mask not bool"])
def test_the_module_raises_outside_the_limits(cuda, what):
    """On a card the module runs the kernels or raises: it never falls
    back to the plain code."""
    g = da.MAX_WIDTH + 1 if what == "g over the cap" else 8
    hidden = {"hidden over the cap": (da.MAX_HIDDEN[0] + 1, 8),
              "three layers": (16, 8, 4)}.get(what, (16, 8))
    m = _module("din", g, hidden, cuda)
    q, k, mask = _inputs(g, _mask("holes", B, L), cuda)
    if what == "float64":
        m, q, k = m.double(), q.double(), k.double()
    if what == "mask not bool":
        mask = mask.float()
    fwd = din_attention.launches
    with pytest.raises(ValueError):
        m.weights(q, k, mask)
    assert din_attention.launches == fwd


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["float64", "g over the cap",
                                  "hidden over the cap", "keys on the cpu"])
def test_the_wrapper_refuses_on_the_card(cuda, what):
    g = da.MAX_WIDTH + 1 if what == "g over the cap" else 8
    hidden = ((da.MAX_HIDDEN[0] + 1, 8) if what == "hidden over the cap"
              else (16, 8))
    m = _module("din", g, hidden, cuda)
    q, k, mask = _inputs(g, _mask("holes", B, L), cuda)
    params = tuple(p.detach() for p in _params(m))
    q, k = q.detach(), k.detach()
    if what == "float64":
        q, k = q.double(), k.double()
    if what == "keys on the cpu":
        k = k.cpu()
    fwd = din_attention.launches
    with pytest.raises(ValueError):
        din_attention(q, k, mask, params, 1.0)
    assert din_attention.launches == fwd
