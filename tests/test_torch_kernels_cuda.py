"""The hand-written CUDA kernels K1 (row gather), K2 (gather+pool, forward
and backward), K3a (lookup_meta, meta_scatter) and K3b (blocked_rmw_set)
against their
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
    blocked_rmw_set, blocked_rmw_set_plain, lookup_meta, lookup_meta_plain,
    meta_scatter, meta_scatter_plain, scatter_set)

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


# name: (bags, w, d, ld, column offset, slot dtype); offset 1 moves the
# base off 16-byte alignment (the float path), as an ld % 4 != 0 does
_FWD_CASES = {
    "w1_ragged_tail": (26 * 512 + 13, 1, 16, 16, 0, torch.int64),
    "w1_int32_fused_width": (26 * 512, 1, 16, 32, 0, torch.int32),
    "w1_d1": (1005, 1, 1, 1, 0, torch.int32),
    "w1_d3": (1005, 1, 3, 3, 0, torch.int64),
    "w1_d4": (1005, 1, 4, 4, 0, torch.int32),
    "w1_d17": (1005, 1, 17, 17, 0, torch.int64),
    "w1_d128": (1005, 1, 128, 128, 0, torch.int32),
    "w1_unaligned_base": (1005, 1, 16, 20, 1, torch.int64),
    "w1_unaligned_ld": (1005, 1, 16, 18, 0, torch.int32),
    "w1_all_invalid_run": (2000, 1, 16, 16, 0, torch.int32),
    "w1_out_of_range": (1005, 1, 16, 16, 0, torch.int64),
    "lane_major_w8": (300, 8, 16, 16, 0, torch.int64),
    "w3_d3": (777, 3, 3, 3, 0, torch.int32),
    "w5_d17": (777, 5, 17, 17, 0, torch.int64),
    "w8_d128_unaligned": (300, 8, 128, 132, 1, torch.int32),
    "w32_d16": (100, 32, 16, 16, 0, torch.int64),
    "w40_d16": (100, 40, 16, 16, 0, torch.int32),   # ids loaded 32 at a time
    "w33_d256": (50, 33, 256, 256, 0, torch.int64),  # and rows wider than
    "w0": (64, 0, 16, 16, 0, torch.int32),           # a warp's 32 vectors
}


def _fwd_case(g, case):
    """(table, values view, slots, valid, all-invalid bag rows)."""
    bags, w, d, ld, off, idx = _FWD_CASES[case]
    n_rows = 3000
    table = torch.randn(n_rows, ld, generator=g)
    lo, hi = (-1000, n_rows + 1000) if case == "w1_out_of_range" \
        else (-2, n_rows + 2)
    if case == "lane_major_w8":  # inv[o:o+w].T of a [W, B] inverse
        inv = torch.randint(lo, hi, (12, bags), generator=g)
        val = torch.rand(12, bags, generator=g) < 0.7
        slots, valid = inv[2:2 + w].T, val[2:2 + w].T
    else:
        slots = torch.randint(lo, hi, (bags, w), generator=g)
        valid = torch.rand(bags, w, generator=g) < 0.7
    empty = torch.zeros(bags, dtype=torch.bool)
    if w:
        empty[0] = True
        if case == "w1_all_invalid_run":  # whole warps' tiles and a ragged run
            empty[64:160] = True
            empty[1000:1037] = True
        valid = valid & ~empty[:, None]
    return table, (off, d), slots.to(idx), valid, empty


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
@pytest.mark.parametrize("case", list(_FWD_CASES))
def test_fused_pooled_lookup_forward_cases(cuda, combiner, case):
    """The warp-tiled forward: the w == 1 path (ragged tails, every D and
    vector width, unaligned views, out-of-range slots, all-invalid bags)
    and the multi-hot path (lane-major views, w past a warp's 32 ids, rows
    past its 32 vectors)."""
    table, (off, d), slots, valid, empty = _fwd_case(_gen(), case)
    ref = fused_pooled_lookup_plain(table[:, off:off + d], slots, valid,
                                    combiner)
    before = fused_pooled_lookup.launches
    got = fused_pooled_lookup(table.to(cuda)[:, off:off + d], slots.to(cuda),
                              valid.to(cuda), combiner)
    torch.cuda.synchronize()
    assert fused_pooled_lookup.launches == before + 1
    # one row at w == 1: exact. Else f32 sums of up to w = 40 rows in id
    # order against the plain version's order: two orders of k terms differ
    # by at most ~k*eps of the summed magnitudes (40 * 6e-8 < 1e-5)
    if slots.shape[1] <= 1:
        assert torch.equal(got.cpu(), ref)
    else:
        mag = fused_pooled_lookup_plain(table[:, off:off + d].abs(), slots,
                                        valid, combiner)
        assert ((got.cpu() - ref).abs() <= 1e-5 * mag + 1e-7).all()
    assert torch.count_nonzero(got[empty]) == 0


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


def _bwd_case(g, case):
    """(slots, valid, d_pooled, n_rows) for the backward. Bag 0 is
    all-invalid in every case."""
    n_rows, d, idx = 2000, 16, torch.int32
    if case.startswith("skewed"):  # a few rows take most of the adds
        bags, w, d, n_rows, idx = {
            "skewed": (26 * 512, 1, 16, 2000, torch.int32),  # DLRM
            "skewed_multihot": (512, 8, 16, 4096, torch.int64),
            "skewed_d6": (300, 5, 6, 700, torch.int64)}[case]
        slots = (torch.rand(bags, w, generator=g) ** 4 * (n_rows + 4) - 2)
        slots = slots.long()
        valid = torch.rand(bags, w, generator=g) < 0.7
    elif case in ("warp_one_row", "batch_one_row", "criteo_skew"):
        bags = 26 * 4096 if case == "criteo_skew" else 26 * 512
        if case == "warp_one_row":  # each 32-id window on one row
            slots = (torch.arange(bags) // 32 * 7 % n_rows).view(-1, 1)
        elif case == "batch_one_row":
            slots = torch.full((bags, 1), 7)
        else:  # the training shape, ~4,000 ids on the hottest row
            n_rows = 17750
            slots = (torch.rand(bags, 1, generator=g) ** 3 * n_rows).long()
        valid = torch.rand(bags, 1, generator=g) < 0.9
    elif case == "repeat_in_bag":  # w > 1, one slot twice in each bag
        bags, idx = 512, torch.int64
        slots = torch.randint(0, n_rows, (bags, 5), generator=g)
        slots[:, 3] = slots[:, 1]
        valid = torch.rand(bags, 5, generator=g) < 0.8
    elif case in ("d6", "d128"):
        bags, d = 300, int(case[1:])
        idx = torch.int64 if d == 6 else torch.int32
        slots = (torch.rand(bags, 4, generator=g) ** 4 * (n_rows + 4) - 2)
        slots = slots.long()
        valid = torch.rand(bags, 4, generator=g) < 0.7
    elif case == "strided_T":  # inv[o:o+w].T of a [W, B] inverse, d 5
        bags, d, idx = 256, 5, torch.int64
        inv = torch.randint(0, 300, (6, bags), generator=g)
        val = torch.rand(6, bags, generator=g) < 0.7
        slots, valid = inv[1:4].T, val[1:4].T
    else:  # "unaligned": d_pooled not 16-byte aligned, scalar path
        bags = 700
        slots = torch.randint(0, 50, (bags, 2), generator=g)
        valid = torch.rand(bags, 2, generator=g) < 0.7
    valid[0] = False
    d_pooled = torch.randn(bags, d, generator=g)
    if case == "unaligned":
        d_pooled = torch.randn(bags * d + 1, generator=g)[1:].view(bags, d)
    return slots.to(idx), valid, d_pooled, n_rows


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
@pytest.mark.parametrize("case", ["skewed", "skewed_multihot", "skewed_d6",
                                  "warp_one_row", "batch_one_row",
                                  "criteo_skew", "repeat_in_bag", "d6",
                                  "d128", "strided_T", "unaligned"])
def test_fused_pooled_lookup_backward_matches_plain(cuda, combiner, case):
    """The warp-grouped backward on skewed draws and where ids share rows:
    within a warp, across the batch, within a bag; over the vector widths
    (float4, float2, float), both index types and both id orders."""
    slots, valid, d_pooled, n_rows = _bwd_case(_gen(), case)
    ref = fused_pooled_lookup_backward_plain(d_pooled, slots, valid,
                                             combiner, n_rows)
    bound = fused_pooled_lookup_backward_plain(d_pooled.abs(), slots, valid,
                                               combiner, n_rows)
    before = fused_pooled_lookup_backward.launches
    got = fused_pooled_lookup_backward(d_pooled.to(cuda), slots.to(cuda),
                                       valid.to(cuda), combiner, n_rows)
    torch.cuda.synchronize()
    assert fused_pooled_lookup_backward.launches == before + 1
    # f32 atomics add a row's window sums in a run-dependent order and the
    # plain version adds its terms in id order; k sequential adds err by at
    # most ~k*eps of the summed magnitudes, with k up to ~12,000 terms in
    # batch_one_row (416 window sums on the card), and the error of such
    # random sums stays orders of magnitude below that bound: 1e-4 of the
    # magnitudes holds with a wide margin
    assert ((got.cpu() - ref).abs() <= 1e-4 * bound + 1e-7).all()
    assert not got.isnan().any()


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


# name: (readonly, planes written, add_freqs, filter_freq, index dtype)
_LOOKUP_CASES = {
    "metadata": (False, ("create_steps", "versions"), True, 1, torch.int32),
    "filter3": (False, ("create_steps", "versions"), True, 3, torch.int64),
    "readonly": (True, ("create_steps", "versions"), True, 2, torch.int32),
    "no_filter": (False, ("create_steps", "versions"), True, None,
                  torch.int32),
    "freqs_only": (False, (), True, None, torch.int64),
    "versions_only": (False, ("versions",), False, None, torch.int32),
    "filter_only": (False, (), False, 2, torch.int32),
}


@pytest.mark.parametrize("case", list(_LOOKUP_CASES))
def test_lookup_meta_matches_plain(cuda, case):
    """The fused K3a at the training shape's width (17,750 lanes): null-row
    lanes, lanes with no count, readonly batches, one plane or none, with
    and without the filter. Integer writes: bit-equal."""
    readonly, written, add_freqs, filter_freq, idx = _LOOKUP_CASES[case]
    g = _gen()
    cap, u = 1 << 16, 17750
    uslots = torch.randperm(cap, generator=g)[:u]
    uslots[torch.rand(u, generator=g) < 0.1] = cap
    counts = torch.randint(0, 4, (u,), generator=g, dtype=torch.int32)
    created = torch.rand(u, generator=g) < 0.4
    dest = torch.where(created & (not readonly), uslots, cap + 1)
    planes = {k: torch.randint(-1, 5, (cap + 1,), generator=g,
                               dtype=torch.int32)
              for k in ("create_steps", "versions", "freqs")}
    ro = torch.tensor(readonly)
    use_freqs = add_freqs or filter_freq is not None

    def run(planes, dev):
        p = {k: v.clone().to(dev) for k, v in planes.items()}
        fn = lookup_meta if dev != "cpu" else lookup_meta_plain
        adm = fn(uslots.to(idx).to(dev), counts.to(dev), ro.to(dev),
                 dest.to(idx).to(dev), 9, cap,
                 *(p[k] if k in written else None
                   for k in ("create_steps", "versions")),
                 p["freqs"] if use_freqs else None, add_freqs, filter_freq)
        return {k: v.cpu() for k, v in p.items()}, adm.cpu()
    want, want_adm = run(planes, "cpu")
    before = lookup_meta.launches
    got, got_adm = run(planes, cuda)
    torch.cuda.synchronize()
    assert lookup_meta.launches == before + 1
    for k in planes:
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(got_adm, want_adm)


def _rmw_case(g, case):
    """(plane, slots, vals, cap, offset): K3b's inputs; the kernel reads the
    plane from element ``offset`` on."""
    cap, u, idx = {"mixed": (1 << 16, 3000, torch.int64),
                   "mixed_odd_cap": ((1 << 14) + 3, 3000, torch.int32),
                   "small_cap": (1000, 300, torch.int32),
                   "cap_mod_4": ((1 << 16) + 3, 3000, torch.int64),
                   "no_updates": (5000, 0, torch.int32),
                   "all_out_of_range": (4096, 2000, torch.int64),
                   "benchmark_shape": (1 << 21, 17664, torch.int32),
                   "unaligned": ((1 << 12) + 1, 800, torch.int32)}[case]
    if case.startswith("mixed"):  # the null row, past it, and below 0
        slots = _meta_case(g, cap, u, idx)
        slots[3] = -4
    else:
        slots = torch.randperm(cap, generator=g)[:u]
        if case == "all_out_of_range":
            slots = torch.cat([-1 - slots[:u // 2], cap + slots[u // 2:]])
        slots = slots.to(idx)
    vals = torch.randint(-100, 100, (u,), generator=g, dtype=torch.int32)
    plane = torch.randint(-1, 50, (cap + 2,), generator=g, dtype=torch.int32)
    # a plane 4 bytes past alignment takes the element-wise copy
    return plane, slots, vals, cap, int(case == "unaligned")


@pytest.mark.parametrize("case", ["mixed", "mixed_odd_cap", "small_cap",
                                  "cap_mod_4", "no_updates",
                                  "all_out_of_range", "benchmark_shape",
                                  "unaligned"])
def test_blocked_rmw_set_matches_plain(cuda, case):
    """K3b's copy and dependent scatter at the edges of the copy's grid and
    of its int4 path, and at the benchmark's own shape (CAP 2^21, U
    17,664)."""
    plane, slots, vals, cap, offset = _rmw_case(_gen(), case)
    ref = blocked_rmw_set_plain(plane[offset:], slots, vals, cap)
    before = blocked_rmw_set.launches
    got = blocked_rmw_set(plane.to(cuda)[offset:], slots.to(cuda),
                          vals.to(cuda), cap)
    torch.cuda.synchronize()
    assert blocked_rmw_set.launches == before + 1
    assert got.shape == (cap,)
    assert torch.equal(got.cpu(), ref)  # integer copies and stores: exact
