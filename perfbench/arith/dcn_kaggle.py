"""Operations of a DCN-v2 training step (``configs/dcn_kaggle.json``).

The matrix products an example takes, as multiply-adds of the forward:
each cross layer ``x0 * x0``, each deep layer and the last one ``in *
out``. The backward takes two products of each: ``x0`` holds the
embeddings, so every first layer's input needs its gradient. Two FLOPs a
multiply-add.
"""
from perfbench.reference.ctr import layers


def forward_macs(cfg: dict) -> int:
    return sum(a * b for _, a, b in layers(cfg))


def train_flops_per_example(cfg: dict) -> int:
    return 2 * 3 * forward_macs(cfg)
