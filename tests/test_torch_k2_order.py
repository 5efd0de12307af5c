"""The order reference of K2's backward (``tests/torch_k2_order.py``) on
the CPU: a row the kernel adds in lane order is bit-equal to the plain
version (``index_add_`` adds in index order), a longer one within 1e-4 of
the magnitudes of it, and every row bit-equal to a literal loop over the
kernel's runs. Imports no JAX."""
import pytest
import torch

from deeprec_tpu_torch.ops.fused_lookup import \
    fused_pooled_lookup_backward_plain
from torch_k2_order import K_EXACT, K_WARP_LANES, k2_backward_in_order


def _case(bags, w, n_rows, d, dtype, idx=torch.int64):
    """Skewed draws: a few rows take hundreds of lanes, most a few; slots
    out of range on both sides (clamped), a fifth of the lanes invalid,
    bag 0 all-invalid."""
    g = torch.Generator().manual_seed(0)
    slots = (torch.rand(bags, w, generator=g) ** 4 * (n_rows + 4) - 2).long()
    valid = torch.rand(bags, w, generator=g) < 0.8
    valid[0] = False
    d_pooled = torch.randn(bags, d, generator=g).to(dtype)
    lanes = torch.bincount(slots.clamp(0, n_rows - 1)[valid],
                           minlength=n_rows)
    return slots.to(idx), valid, d_pooled, lanes


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
def test_order_reference_holds_to_plain(combiner, dtype):
    slots, valid, d_pooled, lanes = _case(3000, 2, 400, 16, dtype)
    short = lanes <= K_EXACT
    mid = ~short & (lanes <= K_WARP_LANES)
    assert bool((lanes[short] > 0).any() and mid.any()
                and (lanes > K_WARP_LANES).any())
    got = k2_backward_in_order(d_pooled, slots, valid, combiner, 400)
    ref = fused_pooled_lookup_backward_plain(d_pooled, slots, valid,
                                             combiner, 400)
    mag = fused_pooled_lookup_backward_plain(d_pooled.float().abs(), slots,
                                             valid, combiner, 400)
    assert got.dtype == dtype and got.shape == ref.shape
    assert torch.equal(_bits(got)[short], _bits(ref)[short])
    step = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    err = (got.float() - ref.float()).abs()[~short]
    assert (err <= step * ref.float().abs()[~short]
            + 1e-4 * mag[~short] + 1e-7).all()
    assert torch.count_nonzero(got[lanes == 0]) == 0


def _in_order(xs, acc):
    for x in xs:
        acc = acc + x
    return acc


def _loop(d_pooled, slots, valid, combiner, n_rows):
    """The kernel's sums written as loops over each row's sorted lanes:
    runs from +0, each warp's runs from its first, the warps from the
    first."""
    b, w = slots.shape
    g = d_pooled.float()
    n = valid.sum(1).clamp_min(1).float()
    scale = {"sum": None, "mean": n, "sqrtn": n.sqrt()}[combiner]
    rows = slots.reshape(-1).clamp(0, n_rows - 1).tolist()
    ok = valid.reshape(-1).tolist()
    out = torch.zeros(n_rows, d_pooled.shape[1])
    for r in range(n_rows):
        terms = [g[t // w] if scale is None else g[t // w] / scale[t // w]
                 for t in range(b * w) if ok[t] and rows[t] == r]
        runs = 1 if len(terms) <= 16 else 32 if len(terms) <= 128 else 256
        per = max(1, -(-len(terms) // runs))
        zero = torch.zeros(g.shape[1])
        sums = [_in_order(terms[q * per:(q + 1) * per], zero)
                for q in range(runs)]
        warps = [_in_order(sums[i + 1:i + 32], sums[i])
                 for i in range(0, runs, 32)]
        out[r] = _in_order(warps[1:], warps[0])
    return out.to(d_pooled.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
def test_order_reference_is_the_kernels_tree(combiner, dtype):
    """Rows of 16/17, 32/33 and 128/129 lanes and longer (a short run
    last, empty runs after it) against the literal loop."""
    g = torch.Generator().manual_seed(1)
    sizes = {0: 1, 1: 16, 2: 17, 3: 32, 4: 33, 5: 128, 6: 129, 7: 300,
             8: 517}
    slots = torch.cat([torch.full((k,), r) for r, k in sizes.items()]
                      + [torch.randint(9, 40, (201,), generator=g)])
    slots = slots[torch.randperm(slots.numel(), generator=g)]
    bags = slots.numel() // 3
    slots = slots[:bags * 3].view(bags, 3)
    # invalid lanes only off the named rows, which keep their counts
    valid = (slots < 9) | (torch.rand(bags, 3, generator=g) < 0.7)
    d_pooled = (torch.randn(bags, 3, generator=g) * 100).to(dtype)
    got = k2_backward_in_order(d_pooled, slots, valid, combiner, 41)
    want = _loop(d_pooled, slots, valid, combiner, 41)
    lanes = torch.bincount(slots[valid], minlength=41)
    assert lanes[:9].tolist() == list(sizes.values())
    assert torch.equal(_bits(got), _bits(want))
