"""The hand-written CUDA kernels K1 (row gather), K2 (gather+pool, forward
and backward), K3a (meta_scatter) and K3b (blocked_rmw_set) against their
plain PyTorch versions, on the card. A CUDA kernel has no
CPU mode, so every test here skips without a card. This file imports no
JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""
import pytest
import torch

from deeprec_tpu_torch.ops.fused_lookup import (
    fused_pooled_lookup, fused_pooled_lookup_backward,
    fused_pooled_lookup_backward_plain, fused_pooled_lookup_plain,
    pooled_lookup)
from deeprec_tpu_torch.ops.gather import gather_rows, gather_rows_plain
from deeprec_tpu_torch.ops.meta_scatter import (
    blocked_rmw_set, blocked_rmw_set_plain, meta_scatter, meta_scatter_plain,
    scatter_set)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _gen():
    return torch.Generator().manual_seed(0)


@pytest.mark.parametrize("rows,cols,d_out,dtype,idx", [
    (4097, 32, 16, torch.float32, torch.int64),   # fused-width table
    (1000, 16, 16, torch.float32, torch.int32),
    (333, 7, 5, torch.float32, torch.int64),      # unaligned: scalar loads
    (512, 128, 128, torch.float32, torch.int32),
    (300, 24, 24, torch.bfloat16, torch.int64),
])
def test_gather_rows_kernel_matches_plain(cuda, rows, cols, d_out, dtype,
                                          idx):
    g = _gen()
    values = torch.randn(rows, cols, generator=g).to(dtype)
    slots = torch.randint(-3, rows + 3, (2000,), generator=g).to(idx)
    ref = gather_rows_plain(values, slots, d_out)
    before = gather_rows.launches
    got = gather_rows(values.to(cuda), slots.to(cuda), d_out)
    torch.cuda.synchronize()
    assert gather_rows.launches == before + 1
    assert torch.equal(got.cpu(), ref)  # a copy: exact


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
@pytest.mark.parametrize("bags,w,d,ld,idx", [
    (26 * 512, 1, 16, 16, torch.int64),   # DLRM's width-1 columns
    (512, 8, 16, 32, torch.int64),        # multi-hot on a fused-width table
    (512, 8, 128, 128, torch.int32),
    (100, 5, 6, 9, torch.int64),          # unaligned: scalar loads
])
def test_fused_pooled_lookup_kernel_matches_plain(cuda, combiner, bags, w, d,
                                                  ld, idx):
    g = _gen()
    table = torch.randn(4096, ld, generator=g)
    values = table[:, :d]
    slots = torch.randint(-2, 4100, (bags, w), generator=g).to(idx)
    valid = torch.rand(bags, w, generator=g) < 0.7
    valid[0] = False
    ref = fused_pooled_lookup_plain(values, slots, valid, combiner)
    before = fused_pooled_lookup.launches
    got = fused_pooled_lookup(table.to(cuda)[:, :d], slots.to(cuda),
                              valid.to(cuda), combiner)
    torch.cuda.synchronize()
    assert fused_pooled_lookup.launches == before + 1
    # f32 sums of up to w rows in another order
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-5, atol=1e-6)
    assert torch.count_nonzero(got[0]) == 0


def test_fused_pooled_lookup_kernel_strided_slots(cuda):
    """slots/valid as transposed views, as the serving path passes them."""
    g = _gen()
    values = torch.randn(1000, 16, generator=g)
    inv = torch.randint(0, 1000, (3, 256), generator=g)
    val = torch.rand(3, 256, generator=g) < 0.6
    ref = fused_pooled_lookup_plain(values, inv.T, val.T, "mean")
    got = fused_pooled_lookup(values.to(cuda), inv.to(cuda).T,
                              val.to(cuda).T, "mean")
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-5, atol=1e-6)


def test_kernels_reject_bad_input_on_cuda(cuda):
    values = torch.zeros(8, 128, device=cuda)
    slots = torch.zeros(2, 3, dtype=torch.int64, device=cuda)
    valid = torch.ones(2, 3, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        fused_pooled_lookup(values, slots, valid, "Sum")
    with pytest.raises(ValueError):
        fused_pooled_lookup(values.double(), slots, valid, "sum")
    with pytest.raises(ValueError):
        gather_rows(values, slots[0].cpu())


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
@pytest.mark.parametrize("bags,w,d,n_rows,idx", [
    (26 * 512, 1, 16, 2000, torch.int32),  # DLRM: skewed, many adds a row
    (512, 8, 16, 4096, torch.int64),
    (300, 5, 6, 700, torch.int64),         # d not a power of two
])
def test_fused_pooled_lookup_backward_matches_plain(cuda, combiner, bags, w,
                                                    d, n_rows, idx):
    g = _gen()
    # a skewed draw, as Criteo's: a few rows take most of the adds
    slots = (torch.rand(bags, w, generator=g) ** 4 * (n_rows + 4) - 2)
    slots = slots.long().to(idx)
    valid = torch.rand(bags, w, generator=g) < 0.7
    valid[0] = False
    d_pooled = torch.randn(bags, d, generator=g)
    ref = fused_pooled_lookup_backward_plain(d_pooled, slots, valid,
                                             combiner, n_rows)
    bound = fused_pooled_lookup_backward_plain(d_pooled.abs(), slots, valid,
                                               combiner, n_rows)
    before = fused_pooled_lookup_backward.launches
    got = fused_pooled_lookup_backward(d_pooled.to(cuda), slots.to(cuda),
                                       valid.to(cuda), combiner, n_rows)
    torch.cuda.synchronize()
    assert fused_pooled_lookup_backward.launches == before + 1
    # f32 atomics add in a run-dependent order: the error of a sum of k
    # terms is at most ~k*eps of the sum of their magnitudes; 1e-4 of it
    # covers k up to ~800 adds in the worst case and far more in practice
    assert ((got.cpu() - ref).abs() <= 1e-4 * bound + 1e-7).all()


def test_pooled_lookup_autograd_on_card(cuda):
    """The autograd entry runs K2 forward and K2 backward on the card."""
    g = _gen()
    values = torch.randn(500, 16, generator=g)
    slots = torch.randint(0, 500, (64, 4), generator=g)
    valid = torch.rand(64, 4, generator=g) < 0.8
    w = torch.randn(64, 16, generator=g)
    vc = values.to(cuda).requires_grad_(True)
    f0, b0 = fused_pooled_lookup.launches, fused_pooled_lookup_backward.launches
    (pooled_lookup(vc, slots.to(cuda), valid.to(cuda), "mean")
     * w.to(cuda)).sum().backward()
    torch.cuda.synchronize()
    assert fused_pooled_lookup.launches == f0 + 1
    assert fused_pooled_lookup_backward.launches == b0 + 1
    vp = values.clone().requires_grad_(True)
    (pooled_lookup(vp, slots, valid, "mean") * w).sum().backward()
    torch.testing.assert_close(vc.grad.cpu(), vp.grad, rtol=1e-5, atol=1e-6)


def _meta_case(g, cap, u, idx):
    # unique slots, plus the null row cap, cap+1 and far out of range
    slots = torch.randperm(cap, generator=g)[:u]
    slots[:3] = torch.tensor([cap, cap + 1, cap + 1000])
    return slots.to(idx)


@pytest.mark.parametrize("idx", [torch.int32, torch.int64])
def test_meta_scatter_matches_plain(cuda, idx):
    g = _gen()
    cap, u = 1 << 16, 5000
    dest = _meta_case(g, cap, u, idx)
    mdest = _meta_case(g, cap, u, idx)
    counts = torch.randint(1, 9, (u,), generator=g, dtype=torch.int32)
    planes = [torch.randint(-1, 50, (cap + 1,), generator=g,
                            dtype=torch.int32) for _ in range(3)]
    ref = [p.clone() for p in planes]
    meta_scatter_plain(ref[0], dest, ref[1], ref[2], mdest, counts, 7, cap)
    got = [p.to(cuda) for p in planes]
    before = meta_scatter.launches
    meta_scatter(got[0], dest.to(cuda), got[1], got[2], mdest.to(cuda),
                 counts.to(cuda), 7)
    torch.cuda.synchronize()
    assert meta_scatter.launches == before + 1
    for a, b in zip(got, ref):
        assert torch.equal(a.cpu(), b)  # integer writes: bit-equal
    one = planes[0].to(cuda)
    scatter_set(one, dest.to(cuda), 11)
    ref1 = planes[0].clone()
    meta_scatter_plain(None, dest, ref1, None, dest, None, 11, cap)
    assert torch.equal(one.cpu(), ref1)


@pytest.mark.parametrize("cap,idx", [(1 << 16, torch.int64),
                                     ((1 << 14) + 3, torch.int32)])
def test_blocked_rmw_set_matches_plain(cuda, cap, idx):
    g = _gen()
    u = 3000
    slots = _meta_case(g, cap, u, idx)
    slots[3] = -4
    vals = torch.randint(-100, 100, (u,), generator=g, dtype=torch.int32)
    plane = torch.randint(-1, 50, (cap + 1,), generator=g, dtype=torch.int32)
    ref = blocked_rmw_set_plain(plane, slots, vals, cap)
    before = blocked_rmw_set.launches
    got = blocked_rmw_set(plane.to(cuda), slots.to(cuda), vals.to(cuda), cap)
    torch.cuda.synchronize()
    assert blocked_rmw_set.launches == before + 1
    assert got.shape == (cap,)
    assert torch.equal(got.cpu(), ref)
