"""The order in which K2's backward (``csrc/fused_pooled_lookup.cu``,
``rows_kernel``) adds each row's terms, as plain PyTorch. Shared by the
CPU tests (``test_torch_k2_order.py``), the card tests
(``test_torch_kernels_cuda.py``) and ``chip_smoke.py``, which hold the
card's backward bit-equal to it on every row. Imports no JAX.

A row's terms are its valid lanes' gradient rows, each divided by its
bag's scale (``mean``, ``sqrtn``), in f32 (a bf16 gradient is widened),
taken in lane order (lane ``b * w + k``). The kernel adds them so:

- a row of at most ``K_EXACT`` lanes: in lane order from +0;
- a row of at most ``K_WARP_LANES``: 32 contiguous runs of
  ceil(len / 32) lanes (the last ones short or empty), each summed in
  order from +0, then the 32 run sums added in run order;
- a longer row: 256 such runs; each warp's 32 run sums added in order,
  then the 8 warps' sums in warp order;

each row rounded once to the gradient's dtype, and a row with no valid
lane zero."""
import torch

K_EXACT = 16        # kExact: a short row's most lanes
K_WARP_LANES = 128  # kWarpLanes: a medium row's (a warp's) most lanes
K_BLOCK_RUNS = 256  # kBwdThreads: a long row's runs, a thread each
K_BLOCK_LANES = 2048  # kBlockLanes: sorted in shared memory, beyond in scratch
WARP = 32


def _in_order(parts):
    """``parts [m, n, D]`` added along n in order, from ``parts[:, 0]``."""
    tot = parts[:, 0]
    for j in range(1, parts.shape[1]):
        tot = tot + parts[:, j]
    return tot


def k2_backward_in_order(d_pooled: torch.Tensor, slots: torch.Tensor,
                         valid: torch.Tensor, combiner: str,
                         n_rows: int) -> torch.Tensor:
    """``[n_rows, D]`` gradient of the pooled lookup with respect to its
    values, summed in the card kernel's order; arguments as
    ``fused_pooled_lookup_backward``'s, on the CPU."""
    d = d_pooled.shape[1]
    g = d_pooled.float()
    if combiner != "sum":
        n = valid.sum(1, keepdim=True).clamp_min(1).float()
        g = g / (n if combiner == "mean" else n.sqrt())
    w = slots.shape[1]
    lane = valid.reshape(-1).nonzero().view(-1)          # lane order
    rows = slots.reshape(-1)[lane].long().clamp(0, n_rows - 1)
    order = torch.argsort(rows, stable=True)             # each row in order
    rows, terms = rows[order], g[lane[order] // w]
    count = torch.bincount(rows, minlength=n_rows)
    pos = torch.arange(rows.numel()) - (count.cumsum(0) - count)[rows]
    length = count[rows]
    out = torch.zeros(n_rows, d, dtype=torch.float32)
    for runs, lo, hi in ((1, 1, K_EXACT), (WARP, K_EXACT + 1, K_WARP_LANES),
                         (K_BLOCK_RUNS, K_WARP_LANES + 1, rows.numel())):
        mine = (length >= lo) & (length <= hi)
        if not bool(mine.any()):
            continue
        r, p, n, t = rows[mine], pos[mine], length[mine], terms[mine]
        which = ((count >= lo) & (count <= hi)).nonzero().view(-1)
        at = torch.empty(n_rows, dtype=torch.long)
        at[which] = torch.arange(which.numel())
        per = (n + runs - 1) // runs
        run, k = p // per, p % per
        sums = torch.zeros(which.numel(), runs, d)
        for j in range(int(k.max()) + 1):  # each run's j-th lane, in order
            sel = k == j
            i = (at[r[sel]], run[sel])
            sums[i] = sums[i] + t[sel]
        if runs == K_BLOCK_RUNS:  # each warp's runs, then the warps
            sums = _in_order(sums.view(-1, runs // WARP, WARP, d)
                             .flatten(0, 1)).view(-1, runs // WARP, d)
        out[which] = _in_order(sums)
    return out.to(d_pooled.dtype)
