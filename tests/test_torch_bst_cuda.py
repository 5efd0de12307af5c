"""BST's block on the card: ``MultiHeadSelfAttention`` through
``F.scaled_dot_product_attention`` (its memory-efficient backend) against
the module's plain softmax on the same card, forward and every gradient,
at a mid size (batch 256, 101 tokens, width 96, 8 heads) with histories
of one slot, of the middle and full; the whole model against the plain
reference (``perfbench/reference/bst.py``) in float64; the kernels the
attention launches (those ``perfbench/metrics/attention_ms.py`` matches,
and no dense score matrix); and two identical training steps, bit-equal.
SDPA's kernels have no CPU mode, so these tests skip without a card. This
file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_bst_cuda.py
"""
import pytest
import torch

from deeprec_tpu_torch.models.layers import MultiHeadSelfAttention
from deeprec_tpu_torch.models.sequence import BST
from perfbench.metrics import attention_ms
from perfbench.reference import bst as ref

pytestmark = pytest.mark.cuda

B, L, E, HEADS = 256, 100, 32, 8
D = 3 * E
# the kernel against the plain softmax, both float32 with TF32 off: the
# same sums in another order and blocking (the kernel's online softmax),
# so each tensor within 1e-5 of its largest value; a wrong mask or head
# is off by O(1)
SDPA_TOL = 1e-5
# the float32 model on the card against the float64 reference: float32
# round-off through two LayerNorms and the 9,728-wide tower's backward
MODEL_TOL = 1e-4
CFG = {"emb_dim": E, "heads": HEADS, "d_ff": 4 * D,
       "hidden_units": [1024, 512, 256], "candidate": ["item", "cate"],
       "history": ["hist_item", "hist_cate"], "context": ["uid"],
       "flags": ["--max_len", str(L), "--dropout", "0"]}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: SDPA's memory-efficient kernels "
                    "have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _lengths(n, device):
    """History lengths 1, full and everything between, then random."""
    g = torch.Generator().manual_seed(0)
    fixed = torch.tensor([0, 1, L // 2, L])
    rest = torch.randint(0, L + 1, (n - len(fixed),), generator=g)
    return torch.cat([fixed, rest]).to(device)


def _mask(n, device):
    """Key masks over the ``L + 1`` tokens; the last, the candidate,
    always valid."""
    pos = torch.arange(L + 1, device=device)
    return (pos[None, :] < _lengths(n, device)[:, None]) | (pos == L)


def _close(a, b, tol):
    scale = float(b.abs().max())
    assert float((a - b).abs().max()) <= tol * scale, \
        (float((a - b).abs().max()), scale)


def _attention_grads(m, x, mask, plain):
    x = x.clone().requires_grad_(True)
    if plain:
        q, k, v = m.qkv(x).view(B, L + 1, 3, HEADS, -1).permute(
            2, 0, 3, 1, 4)
        o = m._plain(q, k, v, mask)
        out = m.out(o.transpose(1, 2).reshape(B, L + 1, D))
    else:
        out = m(x, mask)
    g = torch.Generator(device=x.device).manual_seed(1)
    w = torch.randn(out.shape, generator=g, device=x.device)
    gs = torch.autograd.grad((out * w).sum(), [x] + list(m.parameters()))
    return out.detach(), gs


def test_sdpa_matches_the_plain_softmax(cuda):
    torch.manual_seed(0)
    m = MultiHeadSelfAttention(D, HEADS).to(cuda)
    x = torch.randn((B, L + 1, D), device=cuda)
    mask = _mask(B, cuda)
    out, gs = _attention_grads(m, x, mask, plain=False)
    pout, pgs = _attention_grads(m, x, mask, plain=True)
    _close(out, pout, SDPA_TOL)
    for a, b in zip(gs, pgs):
        _close(a, b, SDPA_TOL)


def test_the_attention_runs_the_memory_efficient_kernels(cuda):
    """The launches of a forward and backward: the memory-efficient
    kernels, which ``attention_ms`` matches, one each way, and no GEMM
    over the ``[B * heads, 101, 101]`` scores (the dense math backend)."""
    from torch.profiler import ProfilerActivity, profile
    m = MultiHeadSelfAttention(D, HEADS).to(cuda)
    x = torch.randn((B, L + 1, D), device=cuda, requires_grad=True)
    mask = _mask(B, cuda)
    m(x, mask).sum().backward()  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        m(x, mask).sum().backward()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    att = [n for n in names if attention_ms.ATTENTION.search(n)]
    print("attention kernels:", sorted(set(att)))
    assert len(att) == 2, sorted(set(names))
    assert any("cutlassF" in n for n in att)
    assert any("cutlassB" in n for n in att)
    assert not any("softmax" in n.lower() for n in names), sorted(set(names))


def _model_and_inputs(device):
    torch.manual_seed(0)
    m = BST("item", "hist_item", E, L, context_names=["uid"],
            candidate_context_names=["cate"],
            seq_context_names=["hist_cate"], heads=HEADS,
            dropout=0.0).to(device)
    g = torch.Generator().manual_seed(2)
    w = {}
    for name, shape, init in ref.params(CFG):
        x = torch.randn(shape, generator=g, dtype=torch.float64)
        w[name] = (x * float(torch.tensor(shape[1:]).prod()) ** -0.5
                   if init == "lecun" else
                   (1.0 if init == "ones" else 0.0) + 0.1 * x)
    with torch.no_grad():
        for n, p in m.named_parameters():
            p.copy_(w[n])
    lengths = _lengths(B, "cpu")
    mask = torch.arange(L)[None, :] < lengths[:, None]
    emb = torch.randn((B, 3, E), generator=g, dtype=torch.float64)
    seq = {c: torch.randn((B, L, E), generator=g, dtype=torch.float64)
           * mask[..., None] for c in CFG["history"]}
    y = (torch.rand((B,), generator=g) < 0.5).double()
    return m, w, emb, seq, mask, y


def _step(m, emb, seq, mask, y, device, dtype=torch.float32):
    emb = emb.to(device, dtype).requires_grad_(True)
    seq = {c: s.to(device, dtype).requires_grad_(True)
           for c, s in seq.items()}
    mask = mask.to(device)
    one = {n: emb[:, i] for i, n in enumerate(["item", "cate", "uid"])}
    z = m(None, one, {c: (s, mask) for c, s in seq.items()}, train=True)
    loss = torch.nn.functional.binary_cross_entropy_with_logits(
        z, y.to(device, dtype))
    gs = torch.autograd.grad(loss, list(m.parameters()) + [emb]
                             + list(seq.values()))
    return z.detach(), gs


def test_the_model_on_the_card_matches_the_reference(cuda):
    m, w, emb, seq, mask, y = _model_and_inputs(cuda)
    z, gs = _step(m, emb, seq, mask, y, cuda)
    wr = {k: v.to(cuda).requires_grad_(True) for k, v in w.items()}
    er = emb.to(cuda).requires_grad_(True)
    sr = {c: s.to(cuda).requires_grad_(True) for c, s in seq.items()}
    inputs = {"names": ["item", "cate", "uid"], "emb": er, "dense": None,
              "seq": {c: (s, mask.to(cuda)) for c, s in sr.items()}}
    rz, _ = ref.forward(CFG, wr, inputs, True)
    loss = torch.nn.functional.binary_cross_entropy_with_logits(
        rz, y.to(cuda))
    rgs = torch.autograd.grad(loss, list(wr.values()) + [er]
                              + list(sr.values()))
    _close(z.double(), rz.detach(), MODEL_TOL)
    for a, b in zip(gs, rgs):
        _close(a.double(), b, MODEL_TOL)


def test_two_identical_steps_are_bit_equal(cuda):
    m, _, emb, seq, mask, y = _model_and_inputs(cuda)
    z1, g1 = _step(m, emb, seq, mask, y, cuda)
    z2, g2 = _step(m, emb, seq, mask, y, cuda)
    assert torch.equal(z1, z2)
    names = [n for n, _ in m.named_parameters()] + ["emb", "hist_item",
                                                      "hist_cate"]
    differ = [n for n, a, b in zip(names, g1, g2) if not torch.equal(a, b)]
    assert not differ, differ
