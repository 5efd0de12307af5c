"""DIN's attention unit off the card: the module's plain code
(``DINAttention._plain``, what the card's kernels are held to) against an
unfused formulation, a softmax over each example's valid positions alone,
forward and every gradient, for DIN (scores over sqrt(g)) and DIEN's
``DINAttentionScores`` (unscaled), with an all-padded row; the kernels'
regrouped sums (``csrc/din_attention.cu``: the first layer's query share
once an example, the parameter and query gradients from the example sums)
as the same mathematics in float64; the module's routing (a CPU tensor
runs the plain code and launches nothing) and the wrapper's refusals,
before any launch. This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_din_attention.py
"""
import math

import pytest
import torch

from deeprec_tpu_torch.models.layers import DINAttention
from deeprec_tpu_torch.models.sequence import DINAttentionScores
from deeprec_tpu_torch.ops import din_attention as da
from deeprec_tpu_torch.ops.din_attention import (din_attention,
                                                 din_attention_backward)

B, L, G, HIDDEN = 9, 12, 6, (10, 5)
# float64 on both sides: only the order of the sums differs
TOL = 1e-10


def _module(kind, g=G, hidden=HIDDEN, dtype=torch.float64):
    torch.manual_seed(0)
    m = (DINAttention if kind == "din" else DINAttentionScores)(g, hidden)
    with torch.no_grad():
        for p in m.parameters():
            p.mul_(3.0)
    return m.to(dtype)


def _inputs(case, g=G, dtype=torch.float64, seed=0):
    gen = torch.Generator().manual_seed(seed)
    if case == "lengths":
        lens = torch.randint(1, L + 1, (B,), generator=gen)
        lens[:3] = torch.tensor([0, 1, L])
        mask = torch.arange(L)[None, :] < lens[:, None]
    else:
        mask = torch.rand(B, L, generator=gen) < 0.4
        mask[0], mask[1] = False, True
    q = torch.randn(B, g, generator=gen, dtype=dtype).requires_grad_(True)
    k = torch.randn(B, L, g, generator=gen,
                    dtype=dtype).requires_grad_(True)
    up = torch.randn(B, L, generator=gen, dtype=dtype)
    return q, k, mask, up


def _params(m):
    return (m.att[0].weight, m.att[0].bias, m.att[1].weight, m.att[1].bias,
            m.att_out.weight, m.att_out.bias)


def _step(m, run, q, k, mask, up):
    m.zero_grad(set_to_none=True)
    q.grad = k.grad = None
    w = run(q, k, mask)
    (w * up).sum().backward()
    return [w.detach(), q.grad, k.grad] + [p.grad.clone()
                                           for p in _params(m)]


def _unfused(m, q, k, mask):
    """Each example's valid positions gathered, scored and normalised by
    their own softmax; zeros elsewhere (a row with none: all zeros)."""
    rows = []
    for b in range(q.shape[0]):
        idx = mask[b].nonzero()[:, 0]
        row = q.new_zeros(mask.shape[1])
        if len(idx):
            kb = k[b, idx]
            qb = q[b].expand_as(kb)
            x = torch.cat([qb, kb, qb - kb, qb * kb], -1)
            for layer in m.att:
                x = torch.sigmoid(layer(x))
            s = m.att_out(x)[:, 0]
            if m.scaled:
                s = s / math.sqrt(k.shape[-1])
            row = row.index_put((idx,), torch.softmax(s, 0))
        rows.append(row)
    return torch.stack(rows)


def _close(got, want, ds_sum=None):
    for i, (x, ref) in enumerate(zip(got, want)):
        atol = TOL * (ds_sum if i == len(want) - 1 and ds_sum is not None
                      else ref.abs().max().item())
        torch.testing.assert_close(x, ref, rtol=TOL, atol=atol)


@pytest.mark.parametrize("kind", ["din", "scores"])
@pytest.mark.parametrize("case", ["lengths", "holes"])
def test_plain_code_is_the_unfused_formulation(kind, case):
    m = _module(kind)
    q, k, mask, up = _inputs(case)
    want = _step(m, lambda *a: _unfused(m, *a), q, k, mask, up)
    got = _step(m, m._plain, q, k, mask, up)
    _close(got, want, ds_sum=1.0)
    assert not got[0][~mask].any() and not got[2][~mask].any()
    assert not got[0][0].any()  # the all-padded row


def _regrouped(m, q, k, mask, up):
    """The kernels' mathematics (``csrc/din_attention.cu``) written out:
    the weights and every gradient under ``up``."""
    w1, b1, w2, b2, w3, b3 = (p.detach() for p in _params(m))
    q, k = q.detach(), k.detach()
    g = k.shape[-1]
    scale = 1.0 / math.sqrt(g) if m.scaled else 1.0
    w1a, w1b, w1c, w1d = w1.split(g, 1)
    wp = torch.cat([w1b - w1c, w1d], 1)          # W' [h1, 2g]
    cb = q @ (w1a + w1c).T + b1                  # the query's share
    u = torch.cat([k, q[:, None] * k], -1)       # [k, q * k]
    h1 = torch.sigmoid(u @ wp.T + cb[:, None])
    h2 = torch.sigmoid(h1 @ w2.T + b2)
    s = ((h2 @ w3.T)[..., 0] + b3) * scale
    s = s.masked_fill(~mask, -math.inf)
    has = mask.any(1, keepdim=True)
    w = torch.where(has, torch.softmax(s.masked_fill(~has, 0.0), 1), 0.0)
    ds = w * (up - (w * up).sum(1, keepdim=True)) * scale
    da2 = ds[..., None] * w3[0] * (1 - h2) * h2
    da1 = (da2 @ w2) * (1 - h1) * h1
    du = da1 @ wp
    d_keys = du[..., :g] + q[:, None] * du[..., g:]
    dsum = da1.sum(1)                            # D, an example
    d_query = dsum @ (w1a + w1c) + (k * du[..., g:]).sum(1)
    s1 = torch.einsum("blh,blc->hc", da1, u)
    qg = dsum.T @ q
    dw1 = torch.cat([qg, s1[:, :g], qg - s1[:, :g], s1[:, g:]], 1)
    return [w, d_query, d_keys, dw1, dsum.sum(0),
            torch.einsum("blh,bln->hn", da2, h1), da2.sum((0, 1)),
            torch.einsum("bl,bln->n", ds, h2)[None], ds.sum()[None]], ds


@pytest.mark.parametrize("kind", ["din", "scores"])
def test_regrouped_sums_are_the_same_mathematics(kind):
    m = _module(kind)
    q, k, mask, up = _inputs("holes", seed=1)
    want = _step(m, m._plain, q, k, mask, up)
    got, ds = _regrouped(m, q, k, mask, up)
    _close(got, want, ds_sum=ds.abs().sum().item())


@pytest.mark.parametrize("kind", ["din", "scores"])
def test_module_runs_its_plain_code_on_the_cpu(kind):
    m = _module(kind, 8, (16, 8), torch.float32)
    q, k, mask, up = _inputs("holes", 8, torch.float32)
    fwd, bwd = din_attention.launches, din_attention_backward.launches
    want = _step(m, m._plain, q, k, mask, up)
    got = _step(m, m.weights, q, k, mask, up)
    for w, x in zip(want, got):
        assert torch.equal(w, x)
    assert (din_attention.launches, din_attention_backward.launches) == (
        fwd, bwd)


def _cpu_args(what):
    """Arguments of ``din_attention`` that it refuses before any launch."""
    g, hidden = 8, (16, 8)
    if what == "g over the cap":
        g = da.MAX_WIDTH + 1
    if what == "hidden over the cap":
        hidden = (da.MAX_HIDDEN[0] + 1, 8)
    if what == "second hidden over the cap":
        hidden = (16, da.MAX_HIDDEN[1] + 1)
    m = _module("din", g, hidden, torch.float32)
    q, k, mask, _ = _inputs("holes", g, torch.float32)
    params = tuple(p.detach() for p in _params(m))
    q, k = q.detach(), k.detach()
    if what == "float64":
        q, k = q.double(), k.double()
    if what == "mask not bool":
        mask = mask.float()
    if what == "query of another shape":
        q = q[1:]
    if what == "weights of other widths":
        params = (params[0][:, 1:], *params[1:])
    if what == "five parameters":
        params = params[:5]
    return q, k, mask, params


@pytest.mark.parametrize("what", [
    "a CPU tensor", "float64", "g over the cap", "hidden over the cap",
    "second hidden over the cap", "mask not bool", "query of another shape",
    "weights of other widths", "five parameters"])
def test_the_wrapper_refuses(what):
    q, k, mask, params = _cpu_args(what)
    fwd = din_attention.launches
    with pytest.raises(ValueError):
        din_attention(q, k, mask, params, 1.0)
    assert din_attention.launches == fwd
