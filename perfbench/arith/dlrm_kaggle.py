"""Operations of a DLRM training step (``configs/dlrm_kaggle.json``).

The matrix products an example takes, as multiply-adds of the forward:
each dense layer ``in * out``; the interaction's Gram matrix
``F * F * d`` over the ``F = columns + 1`` vectors. The backward takes
two products of each (the input's gradient and the weight's), except the
input gradient of the first bottom layer, whose input (the dense
features) needs none. Two FLOPs a multiply-add.
"""
from perfbench.reference.ctr import layers


def forward_macs(cfg: dict) -> int:
    f = cfg["categorical_columns"] + 1
    return sum(a * b for _, a, b in layers(cfg)) + f * f * cfg["emb_dim"]


def train_flops_per_example(cfg: dict) -> int:
    first = layers(cfg)[0]
    return 2 * (3 * forward_macs(cfg) - first[1] * first[2])
