"""The hand-written CUDA kernels K1 (row gather), K2 (gather+pool, forward
and backward, f32 and bf16), K3a (lookup_meta, meta_scatter), K3b
(blocked_rmw_set), K4 and K5 (the hash index's lookup and
lookup_or_insert_, in place and in its functional form) and DLRM's dot
interaction (forward and backward) against their plain PyTorch versions,
on the card; that two card runs of one training
stream are bit-equal (K2's backward adds in an order its inputs fix) on
both one-card engines, a multi-hash table and DIN; and the mesh engine's
step on a world-1 NCCL group against a CPU twin on gloo. A CUDA kernel has no CPU mode, so
every test here skips without a card. This file imports no JAX, so it
also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""
import numpy as np
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
from deeprec_tpu_torch.ops.hash_probe import (arbitration_words,
                                              hash_lookup,
                                              hash_lookup_or_insert_)
from deeprec_tpu_torch.sparse import hashtable as TH
import torch_hash_cases as HC
from torch_k2_order import K_BLOCK_LANES, k2_backward_in_order

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _gen():
    return torch.Generator().manual_seed(0)


_F32, _I32, _I64 = torch.float32, torch.int32, torch.int64
# name: (rows, cols, d_out, dtype, slot dtype, n, slots); slots "mixed":
# uniform over [-3, rows + 3), "out": every one below 0 or past the end,
# "view": mixed, the table passed as the strided view values[:, :d_out].
# The vector unit is the widest of 16, 8, 4, 2, 1 bytes dividing the row,
# the row stride and the base addresses; a row is row bytes / unit units.
_K1_CASES = {
    "fused_width": (4097, 32, 16, _F32, _I64, 2000, "mixed"),
    "d16": (1000, 16, 16, _F32, _I32, 2000, "mixed"),
    "unaligned": (333, 7, 5, _F32, _I64, 2000, "mixed"),  # unit 4
    "d128": (512, 128, 128, _F32, _I32, 2000, "mixed"),
    "bf16": (300, 24, 24, torch.bfloat16, _I64, 2000, "mixed"),
    "n0": (1000, 16, 16, _F32, _I64, 0, "mixed"),
    "n1": (1000, 16, 16, _F32, _I32, 1, "mixed"),
    "n_ragged": (1000, 16, 16, _F32, _I64, 1573, "mixed"),  # odd n
    "grid_stride": (1 << 16, 16, 16, _F32, _I32, (1 << 20) + 7, "mixed"),
    "unit1": (1000, 7, 7, torch.uint8, _I64, 2000, "mixed"),
    "unit2": (1000, 3, 3, torch.int16, _I32, 2000, "mixed"),
    "unit8_3_units": (1000, 6, 6, _F32, _I64, 2000, "mixed"),
    "unit16_3_units": (1000, 12, 12, _F32, _I32, 2000, "mixed"),
    "unit16_5_units": (1000, 20, 20, _F32, _I64, 2000, "mixed"),
    "unit16_33_units": (1000, 132, 132, _F32, _I32, 2000, "mixed"),
    "strided_view": (1000, 40, 24, _F32, _I64, 2000, "view"),
    "out_of_range_int32": (500, 16, 16, _F32, _I32, 2000, "out"),
    "out_of_range_int64": (500, 32, 16, _F32, _I64, 2000, "out"),
    "one_row_table": (1, 16, 16, _F32, _I64, 2000, "mixed"),
}


@pytest.mark.parametrize("case", list(_K1_CASES))
def test_gather_rows_kernel_matches_plain(cuda, case):
    rows, cols, d_out, dtype, idx, n, kind = _K1_CASES[case]
    g = _gen()
    values = (torch.randn(rows, cols, generator=g) * 50).to(dtype)
    if kind == "out":
        far = torch.randint(1, 1 << 30, (n,), generator=g)
        slots = torch.where(torch.arange(n) % 2 == 0, -far, rows - 1 + far)
    else:
        slots = torch.randint(-3, rows + 3, (n,), generator=g)
    slots = slots.to(idx)
    ref = gather_rows_plain(values, slots, d_out)
    table = values.to(cuda)
    before = gather_rows.launches
    if kind == "view":
        got = gather_rows(table[:, :d_out], slots.to(cuda))
    else:
        got = gather_rows(table, slots.to(cuda), d_out)
    torch.cuda.synchronize()
    assert gather_rows.launches == before + (n > 0)
    assert got.shape == (n, d_out) and got.dtype == dtype
    assert torch.equal(got.cpu(), ref)  # a copy: exact


def test_gather_rows_kernel_past_2_31_bytes(cuda):
    """A [2^25 + 16, 16] f32 table (2 GiB + 1 KiB): rows past 2^31 bytes
    need the 64-bit row offset."""
    rows = (1 << 25) + 16
    values = torch.arange(rows * 16, dtype=torch.int32,
                          device=cuda).view(rows, 16).view(torch.float32)
    g = _gen()
    slots = torch.cat([
        torch.randint(rows - 64, rows + 8, (3000,), generator=g),
        torch.randint(0, rows, (1000,), generator=g)])
    slots = slots.to(cuda)
    got = gather_rows(values, slots)
    ref = gather_rows_plain(values, slots, 16)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    assert int(got.view(torch.int32)[:, 0].max()) >= (1 << 31) // 4


def test_gather_rows_sees_writes_queued_before_it(cuda):
    """K1 is a programmatic dependent: its blocks may be scheduled while
    the work before it runs, so it must wait before it reads. A PyTorch
    in-place write to values (a 256 MB pass), then one to slots, queued
    right before it: it reads what they wrote."""
    rows = 1 << 22
    values = torch.arange(rows * 16, dtype=torch.float32,
                          device=cuda).view(rows, 16)
    g = _gen()
    slots = torch.randint(0, rows, (1 << 22,), generator=g).to(cuda)
    fresh = torch.randint(0, rows, (1 << 22,), generator=g).to(cuda)
    torch.cuda.synchronize()
    for i in range(3):
        values.mul_(-1.5)  # right before K1
        got_v = gather_rows(values, slots)
        # plain reads queued after K1 see the state K1 should have seen
        ref_v = gather_rows_plain(values, slots, 16)
        slots.copy_(fresh if i % 2 == 0 else fresh.flip(0))  # right before
        got_s = gather_rows(values, slots)
        ref_s = gather_rows_plain(values, slots, 16)
        torch.cuda.synchronize()
        assert torch.equal(got_v, ref_v)
        assert torch.equal(got_s, ref_s)


def test_k2_reads_the_rows_of_the_k1_before_it(cuda):
    """K2's forward launched right after K1 on K1's output, as the serving
    and host-index training paths run them: K1 lets K2's blocks be
    scheduled during its tail, and K2 must still read K1's rows."""
    g = _gen()
    table = torch.randn((1 << 20) + 1, 32, generator=g).to(cuda)
    inv = torch.randint(0, 106_496, (26 * 4096, 1), generator=g).to(cuda)
    valid = (torch.rand(26 * 4096, 1, generator=g) < 0.97).to(cuda)
    for _ in range(3):
        slots = torch.randint(-2, (1 << 20) + 3, (106_496,),
                              generator=g).to(cuda)
        got = fused_pooled_lookup(gather_rows(table, slots, 16), inv, valid,
                                  "sum")
        torch.cuda.synchronize()
        ref = fused_pooled_lookup_plain(gather_rows_plain(table, slots, 16),
                                        inv, valid, "sum")
        assert torch.equal(got, ref)  # one row a bag: the row's bits


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


BF16_STEP = 2.0 ** -7  # one bf16 step, relative to the value, at most

# bf16 rows: (bags, w, d, ld, column offset, slot dtype); offset 1 moves
# the base off 16-byte alignment (one bf16 a load), as ld % 8 != 0 does
_BF16_FWD_CASES = {
    "w1_criteo": (26 * 512 + 13, 1, 16, 16, 0, torch.int64),
    "w1_fused_width": (26 * 512, 1, 16, 32, 0, torch.int32),
    "w1_unaligned": (1005, 1, 16, 20, 1, torch.int64),
    "w1_d6": (1005, 1, 6, 6, 0, torch.int32),
    "w8_fused_width": (512, 8, 16, 32, 0, torch.int64),
    "w8_d128": (300, 8, 128, 128, 0, torch.int32),
    "w5_d6": (300, 5, 6, 9, 0, torch.int64),
    "w40_d16": (100, 40, 16, 16, 0, torch.int32),
    "w0": (64, 0, 16, 16, 0, torch.int32),
}


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
@pytest.mark.parametrize("case", list(_BF16_FWD_CASES))
def test_fused_pooled_lookup_bf16_forward(cuda, combiner, case):
    """bf16 rows, f32 sums and scale, one rounding: as the plain version,
    which computes the same in f32 and rounds once."""
    bags, w, d, ld, off, idx = _BF16_FWD_CASES[case]
    g = _gen()
    table = torch.randn(3000, ld, generator=g).to(torch.bfloat16)
    slots = torch.randint(-2, 3002, (bags, w), generator=g).to(idx)
    valid = torch.rand(bags, w, generator=g) < 0.7
    if w:
        valid[0] = False
    values = table[:, off:off + d]
    ref = fused_pooled_lookup_plain(values, slots, valid, combiner)
    before = fused_pooled_lookup.launches
    got = fused_pooled_lookup(table.to(cuda)[:, off:off + d], slots.to(cuda),
                              valid.to(cuda), combiner).cpu()
    assert fused_pooled_lookup.launches == before + 1
    assert got.dtype == torch.bfloat16
    if w <= 1:  # one row or none: a copy of its bits
        assert torch.equal(got.view(torch.int16), ref.view(torch.int16))
        return
    # the two f32 sums differ by order (~w*6e-8 of the magnitudes), which
    # can move the one rounding by one bf16 step: at most 2^-7 of the value
    # (8 significant bits)
    mag = fused_pooled_lookup_plain(values.float().abs(), slots, valid,
                                    combiner)
    err = (got.float() - ref.float()).abs()
    assert (err <= BF16_STEP * ref.float().abs() + 1e-5 * mag).all()
    assert torch.count_nonzero(got[0]) == 0


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
@pytest.mark.parametrize("case", ["skewed", "skewed_multihot", "skewed_d6",
                                  "criteo_skew", "repeat_in_bag", "d128",
                                  "strided_T", "unaligned"])
def test_fused_pooled_lookup_bf16_backward(cuda, combiner, case):
    """A bf16 d_pooled: f32 adds, one rounding to bf16 after them."""
    slots, valid, d_pooled, n_rows = _bwd_case(_gen(), case)
    d_pooled = d_pooled.to(torch.bfloat16)
    if case == "unaligned":  # a bf16 view 2 bytes past alignment
        flat = torch.randn(d_pooled.numel() + 1,
                           generator=_gen()).to(torch.bfloat16)
        d_pooled = flat[1:].view(d_pooled.shape)
    ref = fused_pooled_lookup_backward_plain(d_pooled, slots, valid,
                                             combiner, n_rows)
    mag = fused_pooled_lookup_backward_plain(d_pooled.float().abs(), slots,
                                             valid, combiner, n_rows)
    before = fused_pooled_lookup_backward.launches
    got = _bwd_twice(d_pooled.to(cuda), slots.to(cuda), valid.to(cuda),
                     combiner, n_rows)
    assert fused_pooled_lookup_backward.launches == before + 2
    assert got.dtype == torch.bfloat16
    _bwd_holds(got, ref, mag, d_pooled, slots, valid, combiner, n_rows)
    assert not got.isnan().any()


def test_pooled_lookup_bf16_autograd_on_card(cuda):
    """A bf16 table pools and takes its gradient on the card."""
    g = _gen()
    values = torch.randn(500, 16, generator=g).to(torch.bfloat16)
    slots = torch.randint(0, 500, (64, 4), generator=g)
    valid = torch.rand(64, 4, generator=g) < 0.8
    w = torch.randn(64, 16, generator=g).to(torch.bfloat16)
    vc = values.to(cuda).requires_grad_(True)
    (pooled_lookup(vc, slots.to(cuda), valid.to(cuda), "mean")
     * w.to(cuda)).float().sum().backward()
    vp = values.clone().requires_grad_(True)
    (pooled_lookup(vp, slots, valid, "mean") * w).float().sum().backward()
    assert vc.grad.dtype == torch.bfloat16
    torch.testing.assert_close(vc.grad.cpu().float(), vp.grad.float(),
                               rtol=BF16_STEP, atol=1e-3)


def test_kernels_reject_bad_input_on_cuda(cuda):
    values = torch.zeros(8, 128, device=cuda)
    slots = torch.zeros(2, 3, dtype=torch.int64, device=cuda)
    valid = torch.ones(2, 3, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        fused_pooled_lookup(values, slots, valid, "Sum")
    for dtype in (torch.float64, torch.float16):
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            fused_pooled_lookup(values.to(dtype), slots, valid, "sum")
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            fused_pooled_lookup_backward(values[:2].to(dtype), slots, valid,
                                         "sum", 8)
    with pytest.raises(ValueError):
        gather_rows(values, slots[0].cpu())


def _bits(t):
    return t.contiguous().view(torch.int16 if t.dtype == torch.bfloat16
                               else torch.int32)


def _bwd_twice(d_pooled, slots, valid, combiner, n_rows):
    """The card's backward, launched twice on the same inputs: the two
    results must be bit-equal (no float atomics: each row adds in an
    order its lanes fix). Returns the first, on the CPU."""
    a = fused_pooled_lookup_backward(d_pooled, slots, valid, combiner, n_rows)
    b = fused_pooled_lookup_backward(d_pooled, slots, valid, combiner, n_rows)
    torch.cuda.synchronize()
    assert torch.equal(_bits(a), _bits(b))
    return a.cpu()


def _bwd_holds(got, ref, mag, d_pooled, slots, valid, combiner, n_rows):
    """The card's backward against the order reference
    (``torch_k2_order.k2_backward_in_order``: the kernel's lane order and
    run tree, in plain PyTorch), bit-equal on every row, and against the
    plain version's ``ref`` (``mag``: the plain version of the gradient's
    magnitudes). A row of at most 32 valid lanes adds them in lane order
    on both sides (``index_add_`` on the CPU adds in index order), so it
    is bit-equal to ``ref``, at bf16 too (one rounding of the same f32
    sum). A longer row adds contiguous runs of its lanes, then the runs in
    order: k sequential f32 adds err by at most ~k*eps of the summed
    magnitudes, and random sums stay orders of magnitude below that, so
    1e-4 of the magnitudes holds with a wide margin; at bf16 that can move
    the one rounding by one bf16 step."""
    order = k2_backward_in_order(d_pooled, slots, valid, combiner, n_rows)
    assert torch.equal(_bits(got), _bits(order))
    lanes = torch.bincount(slots.clamp(0, n_rows - 1)[valid].long(),
                           minlength=n_rows)
    short = lanes <= 32
    assert torch.equal(_bits(got)[short], _bits(ref)[short])
    step = BF16_STEP if got.dtype == torch.bfloat16 else 0.0
    err = (got.float() - ref.float()).abs()[~short]
    assert (err <= step * ref.float().abs()[~short]
            + 1e-4 * mag[~short] + 1e-7).all()


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
    """The sorted backward on skewed draws and where ids share rows: within
    a warp, across the batch (batch_one_row: ~12,000 lanes on one row, the
    block's runs), within a bag; over the vector widths (float4, float2,
    float), both index types and both id orders; each result bit-equal to
    a second launch's."""
    slots, valid, d_pooled, n_rows = _bwd_case(_gen(), case)
    ref = fused_pooled_lookup_backward_plain(d_pooled, slots, valid,
                                             combiner, n_rows)
    bound = fused_pooled_lookup_backward_plain(d_pooled.abs(), slots, valid,
                                               combiner, n_rows)
    before = fused_pooled_lookup_backward.launches
    got = _bwd_twice(d_pooled.to(cuda), slots.to(cuda), valid.to(cuda),
                     combiner, n_rows)
    assert fused_pooled_lookup_backward.launches == before + 2
    _bwd_holds(got, ref, bound, d_pooled, slots, valid, combiner,
               n_rows)
    assert not got.isnan().any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("idx", [torch.int32, torch.int64])
@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
def test_fused_pooled_lookup_backward_criteo_skew_is_deterministic(
        cuda, combiner, idx, dtype):
    """Criteo's skew at the training shape: [26*4096, 1] bags onto 17,750
    rows, one row taking 1,400 lanes and a few more hundreds, at f32 and
    bf16, both slot types: two launches bit-equal, and the result held to
    the plain version (bit-equal on every row of at most 32 lanes)."""
    g = _gen()
    bags, n_rows = 26 * 4096, 17750
    slots = (torch.rand(bags, 1, generator=g) ** 3 * n_rows).long()
    slots[torch.randperm(bags, generator=g)[:1400]] = 4321
    slots[torch.randperm(bags, generator=g)[:300]] = 17
    valid = torch.rand(bags, 1, generator=g) < 0.9
    valid[0] = False
    lanes = torch.bincount(slots[valid], minlength=n_rows)
    assert int(lanes.max()) >= 1000
    d_pooled = torch.randn(bags, 16, generator=g).to(dtype)
    slots = slots.to(idx)
    ref = fused_pooled_lookup_backward_plain(d_pooled, slots, valid,
                                             combiner, n_rows)
    mag = fused_pooled_lookup_backward_plain(d_pooled.float().abs(), slots,
                                             valid, combiner, n_rows)
    got = _bwd_twice(d_pooled.to(cuda), slots.to(cuda), valid.to(cuda),
                     combiner, n_rows)
    assert got.dtype == dtype
    _bwd_holds(got, ref, mag, d_pooled, slots, valid, combiner, n_rows)
    untouched = lanes == 0
    assert torch.count_nonzero(got[untouched]) == 0


def test_fused_pooled_lookup_backward_dien_history(cuda):
    """DIEN's history lookup at the benchmark cell's shape, K2's backward's
    heaviest use on a path: 16,384 x 100 one-id bags, each example's first
    4-100 positions valid (mean ~14, so ~14 % of the lanes), rows drawn
    Zipf(1.1) over 20,000 unique rows, emb 18 (the float2 path), sum. The
    hottest rows take more than kBlockLanes lanes, spread over the whole
    batch, so they are sorted through the scratch over several bitmap
    windows. Two launches bit-equal, every row bit-equal to the order
    reference, and held to the plain version."""
    g = _gen()
    b, length, n_rows, d = 16384, 100, 20000, 18
    lens = (4 + torch.empty(b).exponential_(1 / 10.2, generator=g)).long()
    valid = (torch.arange(length)[None, :]
             < lens.clamp(max=length)[:, None]).view(-1, 1)
    zipf = torch.arange(1, n_rows + 1, dtype=torch.float64) ** -1.1
    rank = torch.multinomial(zipf, b * length, replacement=True, generator=g)
    slots = torch.randperm(n_rows, generator=g)[rank].view(-1, 1)
    assert 0.12 < float(valid.float().mean()) < 0.16
    lanes = torch.bincount(slots[valid], minlength=n_rows)
    assert int(lanes.max()) > K_BLOCK_LANES
    d_pooled = torch.randn(b * length, d, generator=g)
    ref = fused_pooled_lookup_backward_plain(d_pooled, slots, valid, "sum",
                                             n_rows)
    mag = fused_pooled_lookup_backward_plain(d_pooled.abs(), slots, valid,
                                             "sum", n_rows)
    got = _bwd_twice(d_pooled.to(cuda), slots.to(cuda), valid.to(cuda), "sum",
                     n_rows)
    _bwd_holds(got, ref, mag, d_pooled, slots, valid, "sum", n_rows)
    assert torch.count_nonzero(got[lanes == 0]) == 0


def _bwd_contended(d_pooled, slots, valid, combiner, n_rows):
    """The card's backward while elementwise kernels on a second stream
    hold the SMs, so its blocks run in another order and its atomics
    place lanes elsewhere in their rows' segments. Returns it on the
    CPU."""
    side = torch.cuda.Stream()
    busy = torch.ones(1 << 25, device=d_pooled.device)
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        for _ in range(8):
            busy.mul_(1.0000001)
    got = fused_pooled_lookup_backward(d_pooled, slots, valid, combiner,
                                       n_rows)
    torch.cuda.synchronize()
    return got.cpu()


def _rows_of(g, n, n_rows, sizes):
    """n slots onto n_rows rows: row i of ``sizes`` (row, lanes) takes
    exactly that many lanes, spread over the batch; the others draw
    uniformly from the rows not named."""
    named = torch.tensor([r for r, _ in sizes], dtype=torch.long)
    free = torch.ones(n_rows, dtype=torch.bool)
    free[named] = False
    others = free.nonzero().view(-1)
    slots = others[torch.randint(0, others.numel(), (n,), generator=g)]
    at = torch.randperm(n, generator=g)
    k = 0
    for r, lanes in sizes:
        slots[at[k:k + lanes]] = r
        k += lanes
    return slots


def _bwd_edge(g, case):
    """(slots, valid, d_pooled, n_rows) at an edge of the ordering or of
    the rows kernel. Every lane valid unless the case says otherwise, so
    the named rows take exactly their lanes."""
    d, dtype, idx = 16, torch.float32, torch.int64
    if case == "one_row":  # R = 1: every valid lane on row 0, > kBlockLanes
        bags, w, n_rows = 4096, 3, 1
        slots = torch.randint(-3, 4, (bags, w), generator=g)
        valid = torch.rand(bags, w, generator=g) < 0.7
        idx = torch.int32
    elif case == "all_invalid":
        bags, w, n_rows = 3000, 2, 500
        slots = torch.randint(0, n_rows, (bags, w), generator=g)
        valid = torch.zeros(bags, w, dtype=torch.bool)
    elif case == "lane_per_row":  # the multi-hash layout: slots = arange
        bags, w = 26 * 4096, 1
        n_rows = bags
        slots = torch.arange(bags).view(-1, 1)
        valid = torch.ones(bags, w, dtype=torch.bool)
    elif case.startswith("rows_"):  # R at the warps' and blocks' edges
        n_rows = int(case[5:])
        bags, w = 6000, 2
        slots = torch.randint(0, n_rows, (bags, w), generator=g)
        valid = torch.rand(bags, w, generator=g) < 0.8
        idx = torch.int32 if n_rows % 2 else torch.int64
    elif case == "row_classes":  # each side of 16, 32, 128 and 2048 lanes
        bags, w, n_rows = 20_000, 1, 9000
        sizes = [(3, 1), (11, 16), (12, 17), (13, 32), (14, 33), (15, 128),
                 (16, 129), (17, 2048), (18, 2049), (19, 4000)]
        slots = _rows_of(g, bags, n_rows, sizes).view(-1, 1)
        valid = torch.ones(bags, w, dtype=torch.bool)
        d = 6
    elif case == "half_batch":  # one row takes half of 106,496 lanes
        bags, w, n_rows = 26 * 4096, 1, 17750
        slots = _rows_of(g, bags, n_rows, [(4321, bags // 2)]).view(-1, 1)
        valid = torch.ones(bags, w, dtype=torch.bool)
        idx = torch.int32
    elif case == "windows":  # long rows spanning several 131,072-lane maps
        bags, w, n_rows = 300_000, 1, 5000
        slots = torch.randint(100, n_rows, (bags,), generator=g)
        slots[1001:299_000:2] = 6  # every other lane: contiguous windows
        slots[:1000] = 5  # three clusters: the empty spans are skipped
        slots[150_000:151_000] = 5
        slots[-1000:] = 5
        slots = slots.view(-1, 1)
        valid = torch.ones(bags, w, dtype=torch.bool)
        d = 4
    elif case == "w40":  # w > 32: a bag's lanes over two 32-lane loads
        bags, w, n_rows = 2048, 40, 3000
        slots = (torch.rand(bags, w, generator=g) ** 3 * n_rows).long()
        valid = torch.rand(bags, w, generator=g) < 0.75
        valid[5] = False
    else:  # "strided_bf16": inv.view(W, B)[o:o+w].T of an int32 inverse
        bags, w, n_rows = 4096, 3, 2500
        inv = (torch.rand(7, bags, generator=g) ** 3 * n_rows).long()
        val = torch.rand(7, bags, generator=g) < 0.8
        slots, valid = inv[2:5].to(torch.int32).T, val[2:5].T
        dtype, idx = torch.bfloat16, torch.int32
    d_pooled = torch.randn(bags, d, generator=g).to(dtype)
    if slots.dtype != idx:
        slots = slots.to(idx)
    return slots, valid, d_pooled, n_rows


_BWD_EDGES = ["one_row", "all_invalid", "lane_per_row", "rows_1", "rows_31",
              "rows_32", "rows_33", "rows_63", "rows_64", "rows_65",
              "rows_1023", "rows_1024", "rows_1025", "row_classes",
              "half_batch", "windows", "w40", "strided_bf16"]


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
@pytest.mark.parametrize("case", _BWD_EDGES)
def test_fused_pooled_lookup_backward_edges(cuda, case, combiner):
    """K2's backward at the edges of its counting sort and of its rows
    kernel: R = 1, an all-invalid batch, a row per lane, R on both sides
    of a warp's 32 rows in the ordering, a block's 64 in the rows kernel
    and the ordering's 1,024, rows of 16/17, 32/33, 128/129 and 2048/2049
    lanes (the thread group's, the warp's and the block's sorts, the
    scratch beyond), one row taking half the batch,
    rows whose lanes span several bitmap windows with empty spans between,
    w > 32, a strided bf16 case; int32 and int64 slots. Two launches
    bit-equal, rows of at most 32 lanes bit-equal to the plain version
    (longer within 1e-4 of the magnitudes), and bit-equal again while a
    second stream holds the SMs."""
    slots, valid, d_pooled, n_rows = _bwd_edge(_gen(), case)
    ref = fused_pooled_lookup_backward_plain(d_pooled, slots, valid,
                                             combiner, n_rows)
    mag = fused_pooled_lookup_backward_plain(d_pooled.float().abs(), slots,
                                             valid, combiner, n_rows)
    args = (d_pooled.to(cuda), slots.to(cuda), valid.to(cuda), combiner,
            n_rows)
    got = _bwd_twice(*args)
    assert got.dtype == d_pooled.dtype and got.shape == ref.shape
    _bwd_holds(got, ref, mag, d_pooled, slots, valid, combiner, n_rows)
    assert torch.equal(_bits(_bwd_contended(*args)), _bits(got))
    lanes = torch.bincount(slots.clamp(0, n_rows - 1)[valid].long(),
                           minlength=n_rows)
    assert torch.count_nonzero(got[lanes == 0]) == 0
    if case == "row_classes":
        assert lanes[11:20].tolist() == [16, 17, 32, 33, 128, 129, 2048,
                                         2049, 4000]


_SEGMENT_CASES = {  # name: (rows, trailing shape, segments, id draw)
    "dropped_and_empty": (3000, (16,), 700, "mixed"),
    "one_segment": (2500, (8,), 1, "zero"),
    "skewed_1d": (5000, (), 300, "skewed"),
    "matrix_rows": (1200, (3, 5), 400, "mixed"),
    "int16_ids": (2000, (16,), 900, "mixed"),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(_SEGMENT_CASES))
def test_segment_sum_on_card(cuda, case, dtype):
    """``segment_sum`` of float data on the card goes through K2's
    backward, one lane a row: bit-equal to itself, to the CPU's
    ``index_add_`` on every segment of at most 32 rows (f32; at bf16 the
    CPU rounds at each add, the card once), ids outside [0, n) dropped,
    empty segments zero; integer data stays ``index_add_`` (exact)."""
    from deeprec_tpu_torch.ops.segment import segment_sum
    n, tail, segs, draw = _SEGMENT_CASES[case]
    g = _gen()
    data = torch.randn((n,) + tail, generator=g)
    if draw == "zero":
        ids = torch.zeros(n, dtype=torch.int64)
    elif draw == "skewed":
        ids = (torch.rand(n, generator=g) ** 4 * segs).long()
    else:  # a tenth of the ids out of range, a quarter of the segments empty
        ids = torch.randint(-segs // 20, segs + segs // 20, (n,), generator=g)
        ids[(ids >= 0) & (ids % 4 == 3)] += 1
    if case == "int16_ids":
        ids = ids.to(torch.int16)
    before = fused_pooled_lookup_backward.launches
    a = segment_sum(data.to(dtype).to(cuda), ids.to(cuda), segs)
    b = segment_sum(data.to(dtype).to(cuda), ids.to(cuda), segs)
    torch.cuda.synchronize()
    assert fused_pooled_lookup_backward.launches == before + 2
    assert a.shape == (segs,) + tail and a.dtype == dtype
    assert torch.equal(_bits(a), _bits(b))
    wide = data.to(dtype).float()  # what the card sums, in f32
    ref = segment_sum(wide, ids, segs)  # the CPU: index_add_ in f32
    mag = segment_sum(wide.abs(), ids, segs)
    keep = (ids >= 0) & (ids < segs)
    count = torch.bincount(ids[keep].long(), minlength=segs)
    short = count <= 32
    got = a.cpu().float()
    if dtype == torch.float32:
        assert torch.equal(_bits(a.cpu())[short], _bits(ref)[short])
    else:
        assert torch.equal(_bits(a.cpu())[short], _bits(ref.to(dtype))[short])
    assert ((got - ref).abs() <= BF16_STEP * (dtype == torch.bfloat16)
            * ref.abs() + 1e-4 * mag + 1e-7).all()
    assert torch.count_nonzero(got[count == 0]) == 0
    counts = segment_sum(torch.ones(n, dtype=torch.int32).to(cuda),
                         ids.to(cuda), segs)
    assert fused_pooled_lookup_backward.launches == before + 2
    assert torch.equal(counts.cpu(), count.to(torch.int32))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
def test_segment_combine_gradient_on_card(cuda, combiner, weighted):
    """Autograd through ``segment_combine`` on the card (its float sums go
    through K2's backward inside an autograd function): the result has a
    ``grad_fn``, the gradients in ``data`` and the weights are bit-equal
    across two runs and within 1e-5 of the CPU's (``index_add_``'s
    autograd), relative to each element and to the gradient's largest
    magnitude (a weight's gradient under mean and sqrtn is a difference of
    two terms that cancel, each a sum over D whose order differs between
    the card and the CPU), ids outside [0, n) dropped."""
    from deeprec_tpu_torch.ops.segment import segment_combine
    n, tail, segs, _ = _SEGMENT_CASES["dropped_and_empty"]
    g = _gen()
    data = torch.randn((n,) + tail, generator=g)
    ids = torch.randint(-segs // 20, segs + segs // 20, (n,), generator=g)
    w = torch.rand(n, generator=g) + 0.1 if weighted else None
    ct = torch.randn((segs,) + tail, generator=g)

    def grads(dev):
        d = data.to(dev).requires_grad_()
        wt = None if w is None else w.to(dev).requires_grad_()
        out = segment_combine(d, ids.to(dev), segs, combiner, wt)
        assert out.grad_fn is not None
        (out * ct.to(dev)).sum().backward()
        return [x.grad.cpu() for x in (d, wt) if x is not None]
    before = fused_pooled_lookup_backward.launches
    one, two = grads(cuda), grads(cuda)
    assert fused_pooled_lookup_backward.launches > before
    ref = grads(torch.device("cpu"))
    for a, b, r in zip(one, two, ref):
        assert torch.equal(_bits(a), _bits(b))
        torch.testing.assert_close(a, r, rtol=1e-5,
                                   atol=1e-5 * r.abs().max().item())
    keep = (ids >= 0) & (ids < segs)
    assert torch.count_nonzero(one[0][~keep]) == 0


def test_segment_sum_card_dtypes(cuda):
    """float16 data on the card is summed in f32 and rounded once (within
    one f16 step of the CPU's f32 sum); float64 raises."""
    from deeprec_tpu_torch.ops.segment import segment_sum
    n, tail, segs, _ = _SEGMENT_CASES["dropped_and_empty"]
    g = _gen()
    data = torch.randn((n,) + tail, generator=g).half()
    ids = torch.randint(-segs // 20, segs + segs // 20, (n,), generator=g)
    got = segment_sum(data.to(cuda), ids.to(cuda), segs)
    assert got.dtype == torch.float16 and got.shape == (segs,) + tail
    ref = segment_sum(data.float(), ids, segs)
    mag = segment_sum(data.float().abs(), ids, segs)
    assert ((got.cpu().float() - ref).abs()
            <= 2.0 ** -10 * ref.abs() + 1e-4 * mag + 1e-7).all()
    with pytest.raises(ValueError, match="float64"):
        segment_sum(data.double().to(cuda), ids.to(cuda), segs)


def _zoo_case(g, case):
    """(values, slots, valid, d_pooled) at a CTR-zoo shape: the wide
    tables' [26*4096, 1] bags at D 1 (ids skewed onto 26,624 lanes, a few
    thousand on the hottest), DSSM's hist_item, [4096, 32] lane-major views of a
    [35, 4096] int32 inverse over 107,521 lanes with 4-32 valid ids a row
    and -1 padding (its lanes read the null slot and are not valid), or
    DIN's and DIEN's history expansion: [2*4096*32, 1] one-id bags over
    the 205,825 lanes of an int32 inverse, 4-32 valid ids an example
    shared by both histories, the padded ids on the null lane and not
    valid."""
    if case == "seq_expand":
        bags, u, d = 2 * 4096 * 32, 205825, 16
        lens = torch.randint(4, 33, (4096,), generator=g)
        pad = (torch.arange(32)[None, :] >= lens[:, None]).expand(2, -1, -1)
        slots = torch.randint(0, u - 1, (2, 4096, 32), generator=g)
        slots = torch.where(pad, u - 1, slots).to(torch.int32)
        return (torch.randn(u, d, generator=g), slots.reshape(-1, 1),
                ~pad.reshape(-1, 1), torch.randn(bags, d, generator=g))
    if case == "wide_d1":
        bags, u, d = 26 * 4096, 26624, 1
        slots = (torch.rand(bags, 1, generator=g) ** 3 * u).to(torch.int32)
        valid = torch.rand(bags, 1, generator=g) < 0.95
    else:
        bags, u, d = 4096, 107521, 16
        inv = torch.randint(0, u - 1, (35, bags), generator=g)
        lens = torch.randint(4, 33, (bags,), generator=g)
        pad = torch.arange(32)[None, :] >= lens[:, None]    # [B, 32]
        inv[3:35][pad.T] = u - 1
        slots, valid = inv.to(torch.int32)[3:35].T, ~pad
    values = torch.randn(u, d, generator=g)
    return values, slots, valid, torch.randn(bags, d, generator=g)


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
@pytest.mark.parametrize("case", ["wide_d1", "hist_w32", "seq_expand"])
def test_fused_pooled_lookup_zoo_shapes(cuda, combiner, case):
    """K2 and its backward at the shapes the CTR zoo adds: D = 1 (WDL's and
    DeepFM's wide tables), [B, 32] with padding (DSSM's mean-pooled
    history) and one-id bags with padding (DIN's and DIEN's histories,
    expanded with ``sum``; one id pools to a copy whatever the combiner),
    each against its plain version."""
    values, slots, valid, d_pooled = _zoo_case(_gen(), case)
    ref = fused_pooled_lookup_plain(values, slots, valid, combiner)
    f0, b0 = (fused_pooled_lookup.launches,
              fused_pooled_lookup_backward.launches)
    got = fused_pooled_lookup(values.to(cuda), slots.to(cuda),
                              valid.to(cuda), combiner)
    bref = fused_pooled_lookup_backward_plain(d_pooled, slots, valid,
                                              combiner, values.shape[0])
    bound = fused_pooled_lookup_backward_plain(d_pooled.abs(), slots, valid,
                                               combiner, values.shape[0])
    bgot = _bwd_twice(d_pooled.to(cuda), slots.to(cuda), valid.to(cuda),
                      combiner, values.shape[0])
    torch.cuda.synchronize()
    assert fused_pooled_lookup.launches == f0 + 1
    assert fused_pooled_lookup_backward.launches == b0 + 2
    if slots.shape[1] == 1:  # one row a bag: a copy
        assert torch.equal(got.cpu(), ref)
    else:  # f32 sums of up to 32 rows in another order (see above)
        mag = fused_pooled_lookup_plain(values.abs(), slots, valid, combiner)
        assert ((got.cpu() - ref).abs() <= 1e-5 * mag + 1e-7).all()
    # the backward's order, as in the test above; at D 1 the hottest row's
    # lanes are scalar adds
    _bwd_holds(bgot, bref, bound, d_pooled, slots, valid, combiner,
               values.shape[0])


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


@pytest.mark.parametrize("depth", [1, 3])
def test_pipeline_side_stream_copies(cuda, depth):
    """``HostStepPipeline``'s transfer stage: pinned host buffers copied on
    a side stream come out of ``take()`` equal to the host batch, and a
    pipeline running ahead of a slow device step (whose inputs are freed
    as soon as it is queued) corrupts none of them."""
    from deeprec_tpu_torch.host_index import ResolvedWire
    from deeprec_tpu_torch.train.pipeline import HostStepPipeline
    g = _gen()
    host = [torch.randn(1 << 18, generator=g) for _ in range(12)]
    wires = [torch.randint(0, 255, (4096,), generator=g, dtype=torch.uint8)
             for _ in host]

    def resolve(i):
        return (host[i].pin_memory(),
                {"emb": ResolvedWire(wires[i].pin_memory(), 1, 1, False,
                                     True)},
                (2 * host[i]).pin_memory())

    out = []

    def step(args):
        x, cats, y = args
        assert x.is_cuda and cats["emb"].buf.is_cuda and y.is_cuda
        torch.cuda._sleep(2_000_000)  # the device lags the host
        out.append((x + y, cats["emb"].buf.clone()))
    with HostStepPipeline(resolve, depth=depth, device=cuda) as pipe:
        assert pipe.run(range(len(host)), step, fence_every=5) == len(host)
    torch.cuda.synchronize()
    for i, (s, w) in enumerate(out):
        assert torch.equal(s.cpu(), 3 * host[i]), i
        assert torch.equal(w.cpu(), wires[i]), i


def _two_runs_trainer(kind, dev):
    """(trainer, batches) of one small training stream: bench.py's DLRM
    (B 1024, emb 16, --metadata, fused Adagrad) on the host-index engine,
    the same DLRM on the device-index engine (sparse Adagrad, CounterFilter
    (2)) or over a multi-hash table, or DIN (B 256, histories of 8, emb 8,
    Adam). Weights from torch's seed 0."""
    from deeprec_tpu_torch import config as cfg
    from deeprec_tpu_torch import feature_column as fc
    from deeprec_tpu_torch import feature_column_variants as fv
    from deeprec_tpu_torch.data.behavior import SyntheticBehavior
    from deeprec_tpu_torch.data.criteo import (CAT_NAMES, DENSE_NAMES,
                                               SyntheticCriteo)
    from deeprec_tpu_torch.host_index import HostIndexEmbeddingCollection
    from deeprec_tpu_torch.models import sequence
    from deeprec_tpu_torch.models.ctr import DLRM
    from deeprec_tpu_torch.optim.dense import Adagrad, Adam
    from deeprec_tpu_torch.optim.sparse import (sparse_adagrad,
                                                sparse_adagrad_fused,
                                                sparse_adam)
    from deeprec_tpu_torch.train.trainer import Trainer
    torch.manual_seed(0)
    init = cfg.Initializer("normal", scale=0.05)
    if kind == "din":
        bs, hist, dim = 256, 8, 8
        cat, emb = fc.CategoricalColumn, fc.EmbeddingColumn
        cols = [emb(cat("item", shared_embedding="item_space"), dim),
                emb(cat("cate", shared_embedding="cate_space"), dim),
                emb(cat("uid"), dim)]
        cols += [fc.SequenceEmbeddingColumn(cat(
            f"hist_{n}", max_length=hist, shared_embedding=f"{n}_space"),
            dim) for n in ("item", "cate")]
        coll = HostIndexEmbeddingCollection(
            cols, name="emb", capacity=1 << 14, initializer=init,
            max_unique=int((3 + 2 * hist) * bs * 0.75))
        model = sequence.DIN(
            emb_dim=dim, candidate_name="item", seq_name="hist_item",
            candidate_context_names=["cate"],
            seq_context_names=["hist_cate"], context_names=["uid"],
            hidden_units=(16, 8), att_units=(8, 4))
        tr = Trainer(model, [], {"emb": coll}, {"emb": sparse_adam(0.002)},
                     Adam(0.002), device=dev)
        return tr, list(SyntheticBehavior(batch_size=bs, max_len=hist,
                                          seed=3).take(10))
    cols = [fc.EmbeddingColumn(fc.CategoricalColumn(n), 16)
            for n in CAT_NAMES]
    if kind == "host_index":
        coll = HostIndexEmbeddingCollection(
            cols, name="emb", capacity=1 << 18, initializer=init,
            max_unique=26 * 1024 // 6, fused_slot_columns=16,
            fused_slot_init=0.1, counter_filter=cfg.CounterFilter(1),
            evict=cfg.GlobalStepEvict(1 << 30))
        opt = sparse_adagrad_fused(0.05)
    elif kind == "device_index":
        coll = fc.EmbeddingCollection(
            cols, name="emb", capacity=1 << 18, initializer=init,
            counter_filter=cfg.CounterFilter(2))
        opt = sparse_adagrad(0.05)
    else:
        coll = fv.MultiHashCollection(cols, name="emb",
                                      table_sizes=(1 << 12, 1 << 8))
        opt = sparse_adagrad(0.05)
    tr = Trainer(DLRM(CAT_NAMES, 16, dense_dim=len(DENSE_NAMES)),
                 [fc.NumericColumn(n, log_normalize=True)
                  for n in DENSE_NAMES], {"emb": coll}, {"emb": opt},
                 Adagrad(0.05), device=dev)
    return tr, list(SyntheticCriteo(batch_size=1024, seed=7).take(10))


def _state_bits(tr, st):
    """Every leaf of the tables' states and slot states, the parameters,
    the buffers and the dense optimizer's state, floats as their bits."""
    from deeprec_tpu_torch.utils.tree import leaves_with_paths
    out = []
    for name, b in st.tables.items():
        out += [(f"{name}{p}", x) for p, x in leaves_with_paths((b.ev, b.slot))
                if isinstance(x, torch.Tensor)]
    out += list(tr.model.named_parameters()) + list(tr.model.named_buffers())
    out += [(f"opt{p}", x) for p, x in leaves_with_paths(st.opt_state)
            if isinstance(x, torch.Tensor)]
    return [(n, _bits(x.detach()) if x.dtype.is_floating_point else x)
            for n, x in out]


@pytest.mark.parametrize("kind", ["host_index", "device_index", "multihash",
                                  "din"])
def test_two_card_runs_of_one_stream(cuda, kind):
    """Two card runs of one 10-step stream from one seeded state are
    bit-equal, as the JAX package's steps are: the host-index engines'
    key sets (the resolver's, in slot order) and wires, every integer and
    float leaf of the tables and slot states (rows, slot rows, key planes,
    freqs, versions), the parameters, the buffers and the dense
    optimizer's state. K2's backward adds in an order its inputs fix, and
    ``segment_sum`` (multi-hash) goes through the same kernel."""
    def run():
        tr, batches = _two_runs_trainer(kind, cuda)
        st, wires = tr.init(batches[0]), []
        for b in batches:
            d, c, lab = tr.prepare_batch(b)
            buf = getattr(c["emb"], "buf", None)
            if buf is not None:
                wires.append(buf.cpu())
            st = tr._train_step(st, d, c, lab)
        torch.cuda.synchronize()
        resolver = getattr(tr.collections["emb"], "_resolver", None)
        keys = None if resolver is None else resolver.export_keys()
        return keys, wires, [(n, x.cpu()) for n, x in _state_bits(tr, st)]
    k1, w1, s1 = run()
    k2, w2, s2 = run()
    if kind in ("host_index", "din"):
        assert k1 is not None and k1.size > 0
        assert np.array_equal(k1, k2)
    assert all(torch.equal(a, b) for a, b in zip(w1, w2))
    assert [n for n, _ in s1] == [n for n, _ in s2]
    differ = [n for (n, a), (_, b) in zip(s1, s2) if not torch.equal(a, b)]
    assert not differ, f"{kind}: two runs differ in {differ}"


@pytest.mark.parametrize("kind", ["din", "dien"])
def test_sequence_train_step_on_card(cuda, kind):
    """One DIN and one DIEN train step (B 256, histories of 8, emb 8) on
    the card against a CPU twin with the same weights: equal wires, the
    loss, rows, Adam's slot rows, the parameters and the Dice statistics
    within ROW_ATOL; the history expansion and its backward ran K2 and
    K2's backward, the row fetch K1."""
    from deeprec_tpu_torch import config as cfg
    from deeprec_tpu_torch import feature_column as fc
    from deeprec_tpu_torch.data.behavior import SyntheticBehavior
    from deeprec_tpu_torch.host_index import HostIndexEmbeddingCollection
    from deeprec_tpu_torch.models import ctr, sequence
    from deeprec_tpu_torch.optim.dense import Adam
    from deeprec_tpu_torch.optim.sparse import sparse_adam
    from deeprec_tpu_torch.train.trainer import Trainer
    ROW_ATOL = 1e-4  # chip_smoke.py's card-vs-CPU row tolerance
    bs, hist, dim = 256, 8, 8
    batch = next(SyntheticBehavior(batch_size=bs, max_len=hist,
                                   seed=3).take(1))
    kw = dict(candidate_name="item", seq_name="hist_item",
              candidate_context_names=["cate"],
              seq_context_names=["hist_cate"], context_names=["uid"],
              hidden_units=(16, 8), att_units=(8, 4))

    def trainer(dev):
        cat, emb = fc.CategoricalColumn, fc.EmbeddingColumn
        cols = [emb(cat("item", shared_embedding="item_space"), dim),
                emb(cat("cate", shared_embedding="cate_space"), dim),
                emb(cat("uid"), dim),
                fc.SequenceEmbeddingColumn(cat(
                    "hist_item", max_length=hist,
                    shared_embedding="item_space"), dim),
                fc.SequenceEmbeddingColumn(cat(
                    "hist_cate", max_length=hist,
                    shared_embedding="cate_space"), dim)]
        coll = HostIndexEmbeddingCollection(
            cols, name="emb", capacity=1 << 12,
            initializer=cfg.Initializer("normal", scale=0.05),
            max_unique=int((3 + 2 * hist) * bs * 0.75))
        torch.manual_seed(0)
        model = (sequence.DIN(emb_dim=dim, **kw) if kind == "din" else
                 sequence.DIEN(emb_dim=dim, gru_units=2 * dim, **kw))
        return Trainer(model, [], {"emb": coll}, {"emb": sparse_adam(0.002)},
                       Adam(0.002), forward=(None if kind == "din" else
                                             sequence.dien_forward),
                       device=dev)
    tg, tc = trainer(cuda), trainer("cpu")
    ctr.load_flax_params(tc.model, ctr.flax_leaves(tg.model))
    sg, sc = tg.init(batch), tc.init(batch)
    counters = (gather_rows, fused_pooled_lookup,
                fused_pooled_lookup_backward)
    before = [f.launches for f in counters]
    dg, cg, lg = tg.prepare_batch(batch)
    dc, cc, lc = tc.prepare_batch(batch)
    assert torch.equal(cg["emb"].buf.cpu(), cc["emb"].buf)
    sg = tg._train_step(sg, dg, cg, lg)
    sc = tc._train_step(sc, dc, cc, lc)
    torch.cuda.synchronize()
    # K2: the three width-1 columns and the two histories, two launches
    assert [f.launches - b for f, b in zip(counters, before)][1:] == [2, 2]
    assert gather_rows.launches > before[0]
    assert abs(sg.metrics.loss_sum.item() - sc.metrics.loss_sum.item()) \
        <= ROW_ATOL * bs
    eg, ec = sg.tables["emb"], sc.tables["emb"]
    for a, c in [(eg.ev.values, ec.ev.values)] + [
            (eg.slot[k], ec.slot[k]) for k in ec.slot]:
        assert (a.cpu() - c).abs().max().item() <= ROW_ATOL
    for a, c in zip(ctr.flax_leaves(tg.model), ctr.flax_leaves(tc.model)):
        assert np.abs(a - c).max() <= ROW_ATOL
    assert not np.allclose(ctr.flax_leaves(tg.model)[0], 0.0)  # stats moved


def test_nccl_exchange_step_matches_a_gloo_cpu_step(cuda):
    """The mesh engine's step on a world-1 NCCL group on the card equals
    the same step of a CPU twin on a gloo group of the same process: key
    planes and metadata bit-equal, losses and rows within the smoke's
    card-vs-CPU tolerance; K1, K2, K2's backward and K3a launched."""
    import socket
    import torch.distributed as dist
    from deeprec_tpu_torch.data.criteo import SyntheticCriteo
    from deeprec_tpu_torch.models import ctr
    from deeprec_tpu_torch.parallel import make_mesh, multihost
    from torch_mesh_worker import build
    ROW_ATOL = 1e-4  # chip_smoke.py's card-vs-CPU row tolerance
    spec = dict(cols=[(f"C{i}", 1, "mean") for i in range(1, 9)], dim=8,
                capacity=1 << 14, numeric=[f"I{i}" for i in range(1, 5)],
                fused=True, filter_freq=2, evict_steps=1 << 20,
                max_unique=8 * 512 // 4)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    multihost.initialize(f"127.0.0.1:{port}", 1, 0, backend="nccl",
                         timeout_s=60)
    try:
        card = make_mesh(1, device=cuda)
        cpu = make_mesh(1, group=dist.new_group([0], backend="gloo"),
                        device="cpu")
        tg, tc = build(spec, card), build(spec, cpu)
        ctr.load_flax_params(tc.model, ctr.flax_leaves(tg.model))
        batches = list(SyntheticCriteo(batch_size=512, seed=3).take(3))
        sg, sc = tg.init(batches[0]), tc.init(batches[0])
        counters = (gather_rows, fused_pooled_lookup,
                    fused_pooled_lookup_backward, lookup_meta)
        before = [f.launches for f in counters]
        for b in batches:
            sg, sc = tg.train_step(sg, b), tc.train_step(sc, b)
        torch.cuda.synchronize()
        assert all(f.launches > n for f, n in zip(counters, before))
        assert abs(sg.metrics.loss_sum.item() - sc.metrics.loss_sum.item()) \
            <= ROW_ATOL * 512 * len(batches)
        eg, ec = sg.tables["emb"].ev, sc.tables["emb"].ev
        for a, c in ((eg.index.keys, ec.index.keys), (eg.freqs, ec.freqs),
                     (eg.versions, ec.versions),
                     (eg.create_steps, ec.create_steps)):
            assert torch.equal(a.cpu(), c)
        assert (eg.values.cpu() - ec.values).abs().max().item() <= ROW_ATOL
        assert tg.table_health(sg) == tc.table_health(sc)
    finally:
        dist.destroy_process_group()


def test_host_sharded_step_matches_a_gloo_cpu_step(cuda):
    """The host-sharded engine's step on a world-1 NCCL group on the card
    equals the step of a CPU twin on a gloo group of the same process:
    the resolved wires and metadata bit-equal, losses and rows within the
    smoke's card-vs-CPU tolerance; K1, K2, K2's backward and K3a
    launched."""
    import socket
    import torch.distributed as dist
    from deeprec_tpu_torch.data.criteo import SyntheticCriteo
    from deeprec_tpu_torch.models import ctr
    from deeprec_tpu_torch.parallel import make_mesh, multihost
    from torch_mesh_worker import build
    ROW_ATOL = 1e-4  # chip_smoke.py's card-vs-CPU row tolerance
    spec = dict(cols=[(f"C{i}", 1, "mean") for i in range(1, 9)], dim=8,
                capacity=1 << 14, numeric=[f"I{i}" for i in range(1, 5)],
                fused=True, filter_freq=2, evict_steps=1 << 20,
                max_unique=8 * 512 // 4, engine="hs")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    multihost.initialize(f"127.0.0.1:{port}", 1, 0, backend="nccl",
                         timeout_s=60)
    try:
        card = make_mesh(1, device=cuda)
        cpu = make_mesh(1, group=dist.new_group([0], backend="gloo"),
                        device="cpu")
        tg, tc = build(spec, card), build(spec, cpu)
        ctr.load_flax_params(tc.model, ctr.flax_leaves(tg.model))
        batches = list(SyntheticCriteo(batch_size=512, seed=3).take(3))
        sg, sc = tg.init(batches[0]), tc.init(batches[0])
        counters = (gather_rows, fused_pooled_lookup,
                    fused_pooled_lookup_backward, lookup_meta)
        before = [f.launches for f in counters]
        for b in batches:
            dg, cg, lg = tg.prepare_batch(b)
            dc, cc, lc = tc.prepare_batch(b)
            assert torch.equal(cg["emb"].buf.cpu(), cc["emb"].buf)
            sg, sc = tg._train_step(sg, dg, cg, lg), tc._train_step(
                sc, dc, cc, lc)
        torch.cuda.synchronize()
        assert all(f.launches > n for f, n in zip(counters, before))
        assert abs(sg.metrics.loss_sum.item() - sc.metrics.loss_sum.item()) \
            <= ROW_ATOL * 512 * len(batches)
        n = tc.collections["emb"]._resolver.size
        eg, ec = sg.tables["emb"].ev, sc.tables["emb"].ev
        for a, c in ((eg.freqs, ec.freqs), (eg.versions, ec.versions),
                     (eg.create_steps, ec.create_steps)):
            assert torch.equal(a[:n].cpu(), c[:n])
        assert (eg.values[:n].cpu() - ec.values[:n]).abs().max().item() \
            <= ROW_ATOL
        assert tg.table_health(sg) == tc.table_health(sc)
    finally:
        dist.destroy_process_group()


def test_distributed_hash_table_on_card_matches_cpu(cuda):
    """DistributedHashTable on a world-1 NCCL group on the card: the ids,
    rows and trained rows of a CPU twin on gloo (K1 reads the rows)."""
    import socket
    import torch.distributed as dist
    from deeprec_tpu_torch.optim import sparse as sopt
    from deeprec_tpu_torch.parallel import DistributedHashTable, multihost
    from deeprec_tpu_torch.parallel import make_mesh
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    multihost.initialize(f"127.0.0.1:{port}", 1, 0, backend="nccl",
                         timeout_s=60)
    try:
        out = []
        g = torch.Generator().manual_seed(5)
        keys = torch.randint(0, 5000, (4096,), generator=g)
        ct = torch.randn(4096, 8, generator=g)
        for axis in (make_mesh(1, device=cuda),
                     make_mesh(1, group=dist.new_group([0], backend="gloo"),
                               device="cpu")):
            dht = DistributedHashTable(axis, capacity_per_shard=1 << 14,
                                       dim=8, bucket_cap=4096)
            opt = sopt.sparse_adagrad(0.05)
            st = dht.init()
            slot = dht.init_slot(opt, st)
            before = gather_rows.launches
            st, ids = dht.gen_ids(st, keys)
            st, slot, rows, valid = dht.apply_cotangent(st, opt, slot, keys,
                                                        ct, 0)
            if axis.device.type == "cuda":
                assert gather_rows.launches > before
            out.append((ids.cpu(), rows.cpu(), valid.cpu(),
                        st.table.rows.cpu()))
        (ig, rg, vg, tg), (ic, rc, vc, tc) = out
        assert torch.equal(ig, ic) and torch.equal(vg, vc)
        assert (rg - rc).abs().max().item() <= 1e-6
        assert (tg - tc).abs().max().item() <= 1e-5
    finally:
        dist.destroy_process_group()


# -- K4 (hash_lookup) and K5 (hash_lookup_or_insert) --------------------------
def _same_table(a, b):
    return (torch.equal(a.keys.cpu(), b.keys.cpu())
            and torch.equal(a.size.cpu(), b.size.cpu())
            and torch.equal(a.overflow.cpu(), b.overflow.cpu()))


FORMS = ["in_place", "functional"]


def _insert_matches_plain(table, keys, max_probes=32, form="in_place"):
    """K5 (through hashtable.lookup_or_insert_, or the functional
    lookup_or_insert) against the plain version on the same card tensors:
    key plane, size, overflow, slots and created bit-equal, one launch
    (none for no keys), the arbitration words all zero after the call.
    In place: the table's own tensors written where they lie; functional:
    new tensors, the input table as it was. Returns the kernel's table and
    slots."""
    before = TH.clone(table)
    ptrs = [t.data_ptr() for t in table]
    ref = TH.lookup_or_insert_plain(table, keys, max_probes)
    n0 = hash_lookup_or_insert_.launches
    if form == "in_place":
        got = TH.lookup_or_insert_(table, keys, max_probes)
    else:
        got = TH.lookup_or_insert(table, keys, max_probes)
    torch.cuda.synchronize()
    assert hash_lookup_or_insert_.launches == n0 + (keys.shape[0] > 0)
    assert _same_table(got[0], ref[0])
    assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])
    assert got[1].dtype == torch.int64 and got[2].dtype == torch.bool
    if form == "in_place":
        assert got[0] is table and [t.data_ptr() for t in table] == ptrs
    else:
        assert _same_table(table, before)
        assert not any(t.data_ptr() in ptrs for t in got[0])
    assert not bool(arbitration_words(table.keys.device,
                                      table.capacity).any())
    return got[0], got[1]


def _lookup_matches_plain(table, keys, max_probes=32):
    ref = TH.lookup_plain(table, keys, max_probes)
    n0 = hash_lookup.launches
    got = TH.lookup(table, keys, max_probes)
    torch.cuda.synchronize()
    assert hash_lookup.launches == n0 + (keys.shape[0] > 0)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    return got


def _random_keys(n, seed, n_empty=0, dev="cuda"):
    """n distinct int64 keys (no EMPTY) and n_empty EMPTY lanes, shuffled."""
    rng = np.random.default_rng(seed)
    ks = np.unique(rng.integers(-2 ** 62, 2 ** 62, n + n // 8 + 16))
    ks = ks[ks != -1][:n]
    out = np.concatenate([ks, np.full(n_empty, -1, np.int64)])
    rng.shuffle(out)
    return torch.from_numpy(out).to(dev)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("case", list(HC.CONTENTION))
def test_hash_kernels_contention(cuda, case, form):
    """The CPU contention cases: colliding claims, retries, full buckets,
    both bounds (overflow, max_probes 1); K4 then looks every key up."""
    cap, max_probes, sizes, spread = HC.CONTENTION[case]
    table, seen = TH.create(cap, cuda), []
    for keys in HC.batches(cap, len(case), sizes, spread):
        keys = torch.from_numpy(keys).to(cuda)
        table, _ = _insert_matches_plain(table, keys, max_probes, form)
        seen.append(keys)
    probe = torch.cat(seen + [torch.from_numpy(
        HC.colliding_keys(cap, 5, 99)).to(cuda)])
    _lookup_matches_plain(table, probe, max_probes)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("cap", [1, 2, 4])
def test_hash_kernels_tiny_tables(cuda, cap, form):
    """Tables of fewer slots than a bucket: one bucket of cap lanes."""
    table = TH.create(cap, cuda)
    for seed in range(3):
        table, _ = _insert_matches_plain(table, _random_keys(3, seed, 1),
                                         form=form)
    _lookup_matches_plain(table, _random_keys(6, 0, 2))


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("max_probes", [0, 1])
def test_hash_kernels_short_probe_bounds(cuda, max_probes, form):
    table = TH.create(256, cuda)
    for seed in range(2):
        table, _ = _insert_matches_plain(table, _random_keys(150, seed, 5),
                                         max_probes, form)
    _lookup_matches_plain(table, _random_keys(300, 0, 5), max_probes)


@pytest.mark.parametrize("form", FORMS)
def test_hash_kernels_device_index_shape(cuda, form):
    """The device-index engine's shape: 26,625 lanes (a few EMPTY) into
    2^21 slots, first step (all created) and steady (all found in the
    first round); K4 over them and over absent keys."""
    keys = _random_keys(26_000, 7, 625)
    table, slots = _insert_matches_plain(TH.create(1 << 21, cuda), keys,
                                         form=form)
    assert int(table.size) == 26_000 and int(table.overflow) == 0
    plane = table.keys.clone()
    again, slots2 = _insert_matches_plain(table, keys, form=form)
    assert torch.equal(slots2, slots) and torch.equal(again.keys, plane)
    _lookup_matches_plain(table, torch.cat([keys, _random_keys(5000, 8)]))


def test_hash_kernels_rebuild_growth(cuda):
    """rebuild from 2^16 to 2^17 slots (growth: K5 re-inserts the old
    plane's 2^16 lanes), against the plain rebuild on the CPU."""
    table = TH.create(1 << 16, cuda)
    for seed in range(4):  # ~0.8 load
        table, _ = _insert_matches_plain(table, _random_keys(13_000, seed))
    keep = torch.rand(1 << 16, generator=_gen()).to(cuda) < 0.9
    n0 = hash_lookup_or_insert_.launches
    got, gmap = TH.rebuild(table, keep, 1 << 17)
    torch.cuda.synchronize()
    assert hash_lookup_or_insert_.launches == n0 + 1
    assert not bool(arbitration_words(cuda, 1 << 17).any())
    cpu = TH.HashTable(*(t.cpu() for t in table))
    ref, rmap = TH.rebuild(cpu, keep.cpu(), 1 << 17)
    assert _same_table(got, ref) and torch.equal(gmap.cpu(), rmap)


def test_hash_kernels_no_keys(cuda):
    """n = 0: no launch, empty outputs, the table as it was."""
    table, _ = _insert_matches_plain(TH.create(64, cuda),
                                     _random_keys(20, 1))
    empty = torch.zeros((0,), dtype=torch.int64, device=cuda)
    n4, n5 = hash_lookup.launches, hash_lookup_or_insert_.launches
    t2, slots, created = TH.lookup_or_insert(table, empty)
    t3, slots3, created3 = TH.lookup_or_insert_(table, empty)
    s4, f4 = TH.lookup(table, empty)
    assert (hash_lookup.launches, hash_lookup_or_insert_.launches) == \
        (n4, n5)
    assert slots.shape == created.shape == s4.shape == f4.shape == (0,)
    assert slots3.shape == created3.shape == (0,)
    assert _same_table(t2, table) and t2.keys is not table.keys
    assert t3 is table


@pytest.mark.parametrize("form", FORMS)
def test_hash_kernels_beyond_one_wave(cuda, form):
    """2^20 + 5 lanes, several times the keys a resident wave of
    half-warps takes at once: the grid-stride loops."""
    keys = _random_keys((1 << 20) + 2, 3, 3)
    table, _ = _insert_matches_plain(TH.create(1 << 21, cuda), keys,
                                     form=form)
    table, _ = _insert_matches_plain(table, torch.cat(
        [keys[: 1 << 19], _random_keys(1 << 18, 4)]), form=form)
    _lookup_matches_plain(table, torch.cat([keys, _random_keys(1 << 18, 5)]))


def test_hash_insert_twice_is_identical(cuda):
    """Two launches from one input table under contention (a table near
    full) give identical planes, slots and counts."""
    base, _ = _insert_matches_plain(TH.create(1 << 12, cuda),
                                    _random_keys(3000, 1))
    keys = _random_keys(2000, 2, 7)
    a = TH.lookup_or_insert(base, keys)
    b = TH.lookup_or_insert(base, keys)
    assert _same_table(a[0], b[0])
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
    assert int(a[0].overflow) > 0


def test_hash_insert_sees_writes_queued_before_it(cuda):
    """K5 reads the key plane and the keys as the work queued right before
    it on the stream left them: a long kernel, then PyTorch writes of the
    plane (keys stored there) and of the key batch, then K5."""
    table, _ = _insert_matches_plain(TH.create(1 << 16, cuda),
                                     _random_keys(20_000, 1))
    for i in range(3):
        keys = _random_keys(8000, 10 + i, 3)
        free = torch.nonzero(table.keys == -1).squeeze(1)[:2000]
        planted = keys[:2000].clone()
        planted[planted == -1] = 12345 + i
        batch = torch.zeros_like(keys)
        torch.cuda.synchronize()
        torch.cuda._sleep(50_000_000)
        table.keys.index_put_((free,), planted)  # keys stored off-path
        batch.copy_(keys)
        got = TH.lookup_or_insert(table, batch)
        torch.cuda.synchronize()
        ref = TH.lookup_or_insert_plain(table, keys)
        assert _same_table(got[0], ref[0])
        assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])
        table = got[0]


def test_k3a_and_k1_read_the_slots_of_the_k5_before_them(cuda):
    """K3a and K1 are programmatic dependents launched right after K5 on
    its slots, as lookup_or_create_unique and gather run them: they must
    see every slot K5 wrote."""
    cap = 1 << 21
    table = TH.create(cap, cuda)
    values = torch.randn(cap + 1, 32, generator=_gen()).to(cuda)
    freqs = torch.zeros(cap + 1, dtype=torch.int32, device=cuda)
    ro = torch.zeros((1,), dtype=torch.bool, device=cuda)
    for i in range(3):
        keys = _random_keys(26_625, 20 + i // 2, 64)  # steps 1-2 repeat
        counts = torch.ones(keys.shape, dtype=torch.int32, device=cuda)
        ref_freqs = freqs.clone()
        ref, rslots, rcreated = TH.lookup_or_insert_plain(table, keys)
        torch.cuda.synchronize()
        # the step's order: the in-place insert, then K3a and K1 on its
        # slots, each launched right after the one before
        table, slots, created = TH.lookup_or_insert_(table, keys)
        dest = torch.where(created, slots, cap + 1)
        adm = lookup_meta(slots, counts, ro, dest, 3, cap, freqs=freqs,
                          add_freqs=True, filter_freq=2)
        rows = gather_rows(values, slots, 16)
        torch.cuda.synchronize()
        radm = lookup_meta_plain(rslots, counts, ro,
                                 torch.where(rcreated, rslots, cap + 1), 3,
                                 cap, freqs=ref_freqs, add_freqs=True,
                                 filter_freq=2)
        assert torch.equal(slots, rslots) and _same_table(table, ref)
        assert torch.equal(adm, radm) and torch.equal(freqs, ref_freqs)
        assert torch.equal(rows, gather_rows_plain(values, rslots, 16))


def test_hash_insert_alternating_capacities(cuda):
    """In-place inserts into tables of three capacities in turn, each with
    its own arbitration words (one buffer per device, capacity and
    stream): bit-equal to the plain version, every buffer all zero after
    every call, under contention (near-full tables) too."""
    tables = {cap: TH.create(cap, cuda) for cap in (64, 1 << 12, 1 << 16)}
    for step in range(4):
        for cap, table in tables.items():
            keys = _random_keys(int(cap * 0.3), 100 * step + cap % 97, 3)
            _insert_matches_plain(table, keys)
            for c in tables:
                assert not bool(arbitration_words(cuda, c).any())
    assert int(tables[64].overflow) > 0


def test_hash_insert_on_two_streams(cuda):
    """Inserts into two tables of one capacity, each on its own stream
    with both in flight: each stream has its own arbitration words, and
    both results equal the plain version's."""
    cap = 1 << 14
    tables = [TH.create(cap, cuda) for _ in range(2)]
    keys = [_random_keys(12_000, 40 + k, 5) for k in range(2)]
    refs = [TH.lookup_or_insert_plain(t, k) for t, k in zip(tables, keys)]
    streams = [torch.cuda.Stream() for _ in range(2)]
    torch.cuda.synchronize()
    out = []
    for t, k, st in zip(tables, keys, streams):
        with torch.cuda.stream(st):
            torch.cuda._sleep(20_000_000)
            out.append(TH.lookup_or_insert_(t, k))
    torch.cuda.synchronize()
    words = []
    for st in streams:
        with torch.cuda.stream(st):
            words.append(arbitration_words(cuda, cap))
    assert words[0].data_ptr() != words[1].data_ptr()
    for (t, s, c), (rt, rs, rc), w in zip(out, refs, words):
        assert _same_table(t, rt) and torch.equal(s, rs)
        assert torch.equal(c, rc) and not bool(w.any())


# K4 runs a half-warp over several keys: n below the run, n not a
# multiple of it, EMPTY lanes among the keys, absent keys
_K4_SIZES = {"n1": (1, 0), "n5": (5, 0), "n8": (8, 0), "n13": (13, 2),
             "n4099": (4097, 2), "n70003_empty": (60_000, 10_003)}


@pytest.mark.parametrize("case", list(_K4_SIZES))
def test_hash_lookup_key_runs(cuda, case):
    """K4 at run-ragged sizes, half the keys stored, the rest absent, EMPTY
    lanes mixed in."""
    n, n_empty = _K4_SIZES[case]
    keys = _random_keys(n, 5, n_empty)
    stored = keys[torch.arange(keys.shape[0], device=cuda) % 2 == 0]
    table, _ = _insert_matches_plain(TH.create(1 << 16, cuda), stored)
    slots, found = _lookup_matches_plain(table, keys)
    assert int(found.sum()) == int((stored != -1).sum())


@pytest.mark.parametrize("max_probes", [2, 32])
def test_hash_lookup_second_probe(cuda, max_probes):
    """K4 where home buckets are full: keys stored past their home bucket
    (found at the second probe or later), absent keys whose probes go on
    past a full bucket, in runs shared with keys found at home."""
    cap = 256
    table, seen = TH.create(cap, cuda), []
    for b in range(3):  # overfill buckets 0-2: keys land in later buckets
        keys = torch.from_numpy(HC.colliding_keys(cap, 24, 7 + b, b)).to(
            cuda)
        table, _ = _insert_matches_plain(table, keys, max_probes)
        seen.append(keys)
    spread = _random_keys(60, 11)
    table, _ = _insert_matches_plain(table, spread, max_probes)
    absent = torch.from_numpy(HC.colliding_keys(cap, 9, 99, 1)).to(cuda)
    probe = torch.cat(seen + [spread, absent, _random_keys(7, 12, 4)])
    probe = probe[torch.randperm(probe.shape[0], generator=_gen()).to(cuda)]
    slots, found = _lookup_matches_plain(table, probe, max_probes)
    w = TH.WINDOW
    home = (TH.K.hash32(probe) & (cap // w - 1)) * w
    far = found & (slots // w * w != home)
    assert int(far.sum()) > 0  # keys found past their home bucket


# -- DLRM's dot interaction ---------------------------------------------------
# (B, F, d): the benchmark's 27 x 16 and the MLPerf width 128 at one
# example, past one block's examples and at the benchmark's batch; other
# widths (8: the mesh tests' DLRM; 12, 24, 20: float4 rows of 3, 6 and 5
# units; 3, 5, 6: float rows), the fewest and more than 64 features, and
# rows past 48 KB of shared memory (d 512: the opt-in limit)
_DOT_CASES = [(b, 27, d) for d in (16, 128) for b in (1, 4097, 65536)] + [
    (4097, 2, 32), (333, 64, 64), (77, 64, 128), (4097, 39, 16),
    (4097, 9, 8), (513, 27, 4), (65, 64, 8), (4097, 27, 12),
    (4097, 27, 24), (1025, 27, 20), (4097, 27, 3), (1025, 13, 5),
    (1025, 27, 6), (257, 65, 16), (129, 100, 32), (33, 27, 512)]


def _dot_inputs(cuda, b, f, d, seed=0):
    g = torch.Generator().manual_seed(seed)
    feats = torch.randn(b, f, d, generator=g).to(cuda)
    grad = torch.randn(b, f * (f - 1) // 2, generator=g).to(cuda)
    return feats, grad


def _dot_plain_backward(feats, grad):
    """The plain backward: autograd through the ``bmm`` and the gather."""
    from deeprec_tpu_torch.ops.interaction import dot_interaction_plain
    x = feats.detach().clone().requires_grad_(True)
    dot_interaction_plain(x).backward(grad)
    return x.grad


@pytest.mark.parametrize("b,f,d", _DOT_CASES)
def test_dot_interaction_kernels_match_plain(cuda, b, f, d):
    """Both directions against their plain versions on the same card
    tensors, within 1e-5 of the magnitudes each sum adds (f32 sums in
    another order)."""
    from deeprec_tpu_torch.ops.interaction import (
        dot_interaction, dot_interaction_backward, dot_interaction_plain)
    feats, grad = _dot_inputs(cuda, b, f, d)
    got = dot_interaction(feats)
    torch.cuda.synchronize()
    ref = dot_interaction_plain(feats)
    mag = dot_interaction_plain(feats.abs())
    assert got.shape == ref.shape
    assert bool(((got - ref).abs() <= 1e-5 * mag).all())
    d_got = dot_interaction_backward(feats, grad)
    torch.cuda.synchronize()
    d_ref = _dot_plain_backward(feats, grad)
    d_mag = _dot_plain_backward(feats.abs(), grad.abs())
    assert bool(((d_got - d_ref).abs() <= 1e-5 * d_mag).all())


def test_dot_interaction_backward_is_bit_equal_across_calls(cuda):
    """At the benchmark's shape, and at float4 rows of 3 units (d 12) and
    float rows (d 3)."""
    from deeprec_tpu_torch.ops.interaction import (dot_interaction,
                                                   dot_interaction_backward)
    for d in (16, 12, 3):
        feats, grad = _dot_inputs(cuda, 65536, 27, d, seed=1)
        assert torch.equal(dot_interaction(feats), dot_interaction(feats))
        first = dot_interaction_backward(feats, grad)
        for _ in range(3):
            assert torch.equal(dot_interaction_backward(feats, grad).view(
                torch.int32), first.view(torch.int32))


def test_dot_interaction_module_gradients_on_card(cuda):
    """The DLRM layer on the card (the kernels, through the autograd
    function) against the plain ops under autograd, and its launches."""
    from deeprec_tpu_torch.models.layers import DotInteraction
    from deeprec_tpu_torch.ops.interaction import (dot_interaction,
                                                   dot_interaction_backward)
    feats, grad = _dot_inputs(cuda, 4097, 27, 16, seed=2)
    before = dot_interaction.launches, dot_interaction_backward.launches
    x = feats.clone().requires_grad_(True)
    DotInteraction()(x).backward(grad)
    assert (dot_interaction.launches - before[0],
            dot_interaction_backward.launches - before[1]) == (1, 1)
    ref = _dot_plain_backward(feats, grad)
    mag = _dot_plain_backward(feats.abs(), grad.abs())
    assert bool(((x.grad - ref).abs() <= 1e-5 * mag).all())
    with torch.no_grad():  # serving: the forward alone
        DotInteraction()(feats)
    assert dot_interaction_backward.launches - before[1] == 1


def test_dot_interaction_rejects_on_cuda(cuda):
    """Another dtype raises before a launch; rows past the card's shared
    memory (d 8192: 885 KB an example) are refused by the kernel's entry."""
    from deeprec_tpu_torch.ops.interaction import (dot_interaction,
                                                   dot_interaction_backward)
    for shape, dtype, err in (((2, 6, 16), torch.float64, ValueError),
                              ((2, 6, 16), torch.bfloat16, ValueError),
                              ((2, 27, 8192), torch.float32, RuntimeError)):
        feats = torch.zeros(shape, dtype=dtype, device=cuda)
        with pytest.raises(err):
            dot_interaction(feats)
        with pytest.raises(err):
            dot_interaction_backward(feats, torch.zeros(
                2, shape[1] * (shape[1] - 1) // 2, dtype=dtype, device=cuda))


def test_dot_interaction_empty_and_unaligned(cuda):
    from deeprec_tpu_torch.ops.interaction import (
        dot_interaction, dot_interaction_backward, dot_interaction_plain)
    empty = torch.zeros(0, 27, 16, device=cuda)
    assert dot_interaction(empty).shape == (0, 351)
    assert dot_interaction_backward(empty, torch.zeros(
        0, 351, device=cuda)).shape == (0, 27, 16)
    # a view 4 bytes past an aligned base: the wrapper copies it
    base, grad = _dot_inputs(cuda, 101, 27, 16, seed=3)
    feats = base.reshape(-1)[1:1 + 100 * 27 * 16].view(100, 27, 16)
    grad = grad[:feats.shape[0]]
    got = dot_interaction(feats)
    mag = dot_interaction_plain(feats.abs())
    assert bool(((got - dot_interaction_plain(feats)).abs()
                 <= 1e-5 * mag).all())
    d_mag = _dot_plain_backward(feats.abs(), grad.abs())
    assert bool(((dot_interaction_backward(feats, grad)
                  - _dot_plain_backward(feats, grad)).abs()
                 <= 1e-5 * d_mag).all())
