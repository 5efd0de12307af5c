"""The sequence models' recurrences replayed from CUDA graphs
(``models/layers.py`` ``graphed``): GRU and AUGRU give the outputs and
the gradients of their launched loop, bit for bit, on the first call (the
capture), on later calls with new inputs (replays) and through autograd
into the inputs and ``.grad``, with no warning of a gradient
accumulator on another stream; another input signature runs the loop.
The graphs exist only on a card, so those tests skip without one; on the
CPU the module runs its loop. This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_graphed_cuda.py
"""
import warnings

import pytest
import torch

from deeprec_tpu_torch.models.layers import AUGRU, GRU

B, L, D, G = 64, 12, 8, 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    return torch.device("cuda")


def _inputs(seed, device, b=B):
    g = torch.Generator().manual_seed(seed)
    xs = torch.randn(b, L, D, generator=g)
    att = torch.rand(b, L, generator=g)
    lens = torch.randint(1, L + 1, (b,), generator=g)
    mask = torch.arange(L)[None, :] < lens[:, None]
    return (xs.to(device).requires_grad_(True),
            att.to(device).requires_grad_(True), mask.to(device))


def _pair(kind, device):
    torch.manual_seed(0)
    eager = (GRU(D, G) if kind == "gru" else AUGRU(D, G)).to(device)
    eager.cuda_graph = False
    replayed = (GRU(D, G) if kind == "gru" else AUGRU(D, G)).to(device)
    replayed.load_state_dict(eager.state_dict())
    return eager, replayed


def _call(m, kind, xs, att, mask):
    return m(xs, mask) if kind == "gru" else m(xs, att, mask)


def _step(m, kind, seed, device, b=B):
    """Output, the input gradients and the parameters' ``.grad`` of one
    forward and backward under a fixed upstream gradient."""
    xs, att, mask = _inputs(seed, device, b)
    m.zero_grad(set_to_none=True)
    out = _call(m, kind, xs, att, mask)
    up = torch.linspace(-1, 1, out.numel(), device=device).view_as(out)
    (out * up).sum().backward()
    grads = [xs.grad] + ([att.grad] if kind == "augru" else [])
    return ([out.detach()] + grads
            + [p.grad.clone() for p in m.parameters()])


@pytest.mark.parametrize("kind", ["gru", "augru"])
def test_module_runs_its_loop_on_the_cpu(kind):
    m = GRU(D, G) if kind == "gru" else AUGRU(D, G)
    xs, att, mask = _inputs(0, "cpu")
    out = _call(m, kind, xs, att, mask)
    ref = m._scan(xs, mask) if kind == "gru" else m._scan(xs, att, mask)
    assert torch.equal(out, ref)
    assert getattr(m, "_captured", None) is None


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gru", "augru"])
def test_replay_is_bit_equal_to_the_loop(cuda, kind):
    eager, replayed = _pair(kind, cuda)
    for seed in (1, 2, 3):  # the capture, then two replays
        want = _step(eager, kind, seed, cuda)
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            got = _step(replayed, kind, seed, cuda)
        # no gradient accumulator left on another stream by the warm-up
        assert not [w for w in seen if "AccumulateGrad" in str(w.message)]
        for w, g in zip(want, got):
            assert torch.equal(w, g)
    assert replayed._captured is not None


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gru", "augru"])
def test_other_signature_and_no_grad_run_the_loop(cuda, kind):
    eager, replayed = _pair(kind, cuda)
    _step(replayed, kind, 1, cuda)
    cap = replayed._captured
    for w, g in zip(_step(eager, kind, 4, cuda, b=B // 2),
                    _step(replayed, kind, 4, cuda, b=B // 2)):
        assert torch.equal(w, g)
    with torch.no_grad():
        xs, att, mask = _inputs(5, cuda)
        assert torch.equal(_call(eager, kind, xs, att, mask),
                           _call(replayed, kind, xs, att, mask))
    assert replayed._captured is cap
