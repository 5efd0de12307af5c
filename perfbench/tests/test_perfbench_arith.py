"""The step's operations and the embedding bytes, against hand counts."""
from perfbench import arith
from perfbench.arith import embedding
from perfbench.core import session


def test_dlrm_counts_by_hand():
    cfg = session.load_json("configs", "dlrm_kaggle")
    a = arith.load("dlrm_kaggle")
    bottom = 13 * 512 + 512 * 256 + 256 * 16
    top = 367 * 1024 + 1024 * 1024 + 1024 * 512 + 512 * 256 + 256 * 1
    gram = 27 * 27 * 16
    assert a.forward_macs(cfg) == bottom + top + gram == 2_233_488
    assert a.train_flops_per_example(cfg) == \
        2 * (3 * 2_233_488 - 13 * 512) == 13_387_616


def test_dcn_counts_by_hand():
    cfg = session.load_json("configs", "dcn_kaggle")
    a = arith.load("dcn_kaggle")
    cross = 3 * 429 * 429
    deep = 429 * 1024 + 1024 * 512 + 512 * 256
    assert a.forward_macs(cfg) == cross + deep + 685 == 1_647_464
    assert a.train_flops_per_example(cfg) == 6 * 1_647_464 == 9_884_784


def test_embedding_bytes_by_hand():
    lanes, width, nu, d, row = 10, 4, 3, 2, 4
    fetch = 4 * 8 + 3 * 2 * 4 + 4 * 2 * 4
    pool = 10 * 9 + 3 * 2 * 4 + 10 * 2 * 4
    bwd = 10 * 2 * 4 + 10 * 9 + 4 * 2 * 4
    opt = 4 * 8 + 3 * 4 * 4 + 4 * 4 * 4
    meta = 4 * 20 + 3 * 24 + 4
    assert embedding.step_bytes(lanes, width, nu, d, row) == \
        fetch + pool + bwd + opt + meta
