"""The traffic generator: one pool from one seed, ids within each
column's count, the Zipf head's share, the rank -> id bijection, and each
column's exponent fitted to its count."""
import math

import numpy as np
import pytest
import torch

from perfbench.core import traffic

MIX = traffic.load_mix("criteo_kaggle_zipf")


def test_pool_is_a_function_of_the_seed():
    a = traffic.make_pool(MIX, 512, 128, 2 ** 31 + 7, "cpu")
    b = traffic.make_pool(MIX, 512, 128, 2 ** 31 + 7, "cpu")
    c = traffic.make_pool(MIX, 512, 128, 2 ** 31 + 8, "cpu")
    for x, y in zip(a.batches, b.batches):
        assert x.keys() == y.keys()
        assert all(np.array_equal(x[k], y[k]) for k in x)
    assert not np.array_equal(a.batches[0]["C3"], c.batches[0]["C3"])
    assert len(a.batches) == 4 and len(a.batches[0]["C1"]) == 128


def test_each_column_is_a_space_of_its_own():
    p = traffic.make_pool(MIX, 256, 128, 5, "cpu")
    assert [s.columns for s in p.spaces] == [[c] for c in MIX["columns"]]
    for s, v in zip(p.spaces, MIX["column_counts"]):
        assert s.count == v and list(s.ends) == [0, 128, 256]
        assert np.array_equal(s.ids, np.concatenate(
            [b[s.name] for b in p.batches]))
    assert p.lanes == [26 * 128] * 2 and p.width == 26


def test_pool_holds_the_program_input_columns():
    p = traffic.make_pool(MIX, 256, 128, 5, "cpu")
    b = p.batches[1]
    assert set(b) == {"label", *MIX["dense_names"], *MIX["columns"]}
    assert b["C3"].dtype == np.int64 and b["I1"].dtype == np.float32
    assert set(np.unique(b["label"])) <= {0.0, 1.0}
    assert (b["I5"] >= 0).all()


def test_ids_stay_within_each_column_count():
    ids, _, _ = traffic.draw(MIX, 20000, 11, "cpu")
    for c, v in enumerate(MIX["column_counts"]):
        assert int(ids[c].min()) >= 0 and int(ids[c].max()) < v


COLUMNS = list(zip(MIX["column_counts"], traffic.exponents(MIX)))


@pytest.mark.parametrize("v,a", [COLUMNS[8], COLUMNS[19], COLUMNS[0],
                                 COLUMNS[2], (10131227, 1.2)])
def test_zipf_head_share_matches_the_formula(v, a):
    n = 400_000
    g = torch.Generator().manual_seed(v)
    u = torch.rand((n,), generator=g, dtype=torch.float64)
    ranks = traffic._zipf_ranks(u, v, a, MIX["zipf_head"])
    k = np.arange(1, min(v, 10 ** 7) + 1, dtype=np.float64)
    norm = np.sum(k ** -a) + (0.0 if v <= 10 ** 7 else
                              ((10 ** 7 + .5) ** (1 - a)
                               - (v + .5) ** (1 - a)) / (a - 1))
    for r in (0, 1, 2):
        if r >= v:
            break
        p = (r + 1) ** -a / norm
        got = float((ranks == r).double().mean())
        assert abs(got - p) < 5 * math.sqrt(p * (1 - p) / n), (r, got, p)
    assert int(ranks.max()) <= v - 1


@pytest.mark.parametrize("v", [3, 4, 10, 24, 583, 5683])
def test_rank_to_id_is_a_bijection(v):
    r = torch.arange(v)
    ids = (r * traffic.multiplier(v) + v // 3) % v
    assert sorted(ids.tolist()) == list(range(v))


def test_distinct_per_batch_counts_column_id_pairs():
    ids, _, _ = traffic.draw(MIX, 512, 3, "cpu")
    got = traffic.distinct_per_batch(ids, 256)
    want = [sum(len(np.unique(ids[c, s:s + 256].numpy()))
                for c in range(ids.shape[0])) for s in (0, 256)]
    assert got == want


@pytest.mark.parametrize("v,a", COLUMNS)
def test_each_exponent_is_the_fit_to_its_count(v, a):
    """Draws as many as the dataset's rows show the column's count of
    distinct ids: the exponent is the root, to a ten-thousandth."""
    n = MIX["rows"]
    assert traffic.expected_distinct(a * (1 - 1e-4), n) > v
    assert traffic.expected_distinct(a * (1 + 1e-4), n) < v


def test_the_fit_recovers_a_known_exponent():
    want = 1.3
    v = traffic.expected_distinct(want, 10 ** 6)
    assert traffic.fit_exponent(round(v), 10 ** 6) == \
        pytest.approx(want, abs=1e-3)
