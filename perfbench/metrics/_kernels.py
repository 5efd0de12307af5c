"""Which device operations belong to which layer, by kernel name (the
traced window records no CPU ops; the names were matched against the
launching ops in a trace that recorded both, on the card, torch 2.11).
PERF.md lists the names."""
import re

# the port's kernels of the embedding functions: K1 (gather_rows), K2 and
# its backward (ordering, rows), K3a (lookup_meta)
EMBEDDING = re.compile(r"\b(gather_rows_kernel|pooled_lookup_w1_kernel|"
                       r"pooled_lookup_kernel|order_kernel|rows_kernel|"
                       r"lookup_meta_kernel)\b")
# K5 (the hash index's insert) and K4 (its lookup); the dedup's sort, the
# step's only aten::sort: cub's radix-sort passes and torch's
# sort_postprocess. The tower's index backward sorts its 351 positions in
# one single-tile pass, left out.
INDEX = re.compile(r"\b(lookup_or_insert_kernel|lookup_kernel|"
                   r"sort_postprocess_kernel)\b|DeviceRadixSort(?!SingleTile)"
                   r"\w*Kernel")
# cuBLAS and CUTLASS GEMM and GEMV kernels, and cuBLASLt's split-K
# reduction of a GEMM's partial sums
GEMM = re.compile(r"gemm|gemv|xmma|cutlass|splitKreduce|nvjet",
                  re.IGNORECASE)


def embedding(op) -> bool:
    return op.cat == "kernel" and EMBEDDING.search(op.name) is not None


def index(op) -> bool:
    return op.cat == "kernel" and INDEX.search(op.name) is not None


def gemm(op) -> bool:
    return op.cat == "kernel" and GEMM.search(op.name) is not None


def ms_per_step(ctx, pred):
    ops = [o for o in ctx.trace.ops if pred(o)]
    if not ops:
        return None
    return sum(o.dur for o in ops) / 1e3 / ctx.steps
