"""The numbers that decide ``correct``, on hand-made readings."""
import math

import numpy as np

from perfbench.core import compare

REF = {"loss": [0.5, 0.4, 0.3],
       "grad": {"a": 1.0, "b": 2.0, "c": 4.0, "still": 1e-6},
       "change": {"a": 0.1, "b": 0.2, "c": 0.4, "still": 1.0},
       "index_misses": 0, "freqs": np.array([2, 4, 6])}


def _side(**kw):
    return {**REF, "grad": dict(REF["grad"]), "change": dict(REF["change"]),
            **kw}


def test_equal_readings_read_zero():
    assert compare.numbers(_side(), REF) == {
        "loss_gap": 0.0, "grad_gap": 0.0, "change_gap": 0.0,
        "index_misses": 0, "freq_misses": 0}


def test_gaps_are_over_the_larger_of_the_leaf_and_the_median_leaf():
    side = _side(grad={**REF["grad"], "still": 0.015},
                 change={**REF["change"], "b": 0.23})
    n = compare.numbers(side, REF)
    # median reference gradient 1.5: the still leaf's gap is over it
    assert math.isclose(n["grad_gap"], (0.015 - 1e-6) / 1.5, rel_tol=1e-9)
    # the still leaf is left out of the change; b's gap is over its own 0.2
    assert math.isclose(n["change_gap"], 0.03 / 0.2, rel_tol=1e-6)
    assert compare.worst_leaves(side, REF) == {"grad": "still",
                                               "change": "b"}


def test_a_missing_number_fails():
    side = _side(loss=[0.5, float("nan"), 0.3],
                 freqs=np.array([2, 5, 6]), index_misses=3)
    n = compare.numbers(side, REF)
    assert n["loss_gap"] == float("inf")
    assert (n["index_misses"], n["freq_misses"]) == (3, 1)
    assert not compare.verdict(n, {k: 1.0 for k in compare.NUMBERS})
