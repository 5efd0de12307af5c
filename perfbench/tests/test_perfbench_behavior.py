"""The behaviour generator (``generators/behavior.py``), found by the
mix's ``generator``: the zoo's format, one pool from one seed, histories
right-padded within the mix's lengths, categories a function of the item,
each space's exponent fitted to its count, and the pool's spaces, lanes
and distinct keys."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench.core import traffic
from perfbench.generators import behavior

MIX = json.loads((Path(__file__).resolve().parent / "data" / "traffic"
                  / "behavior_tiny.json").read_text())


def test_a_mix_names_its_generator():
    assert traffic.generator("behavior") is behavior
    p = traffic.make_pool(MIX, 256, 64, 2 ** 31 + 9, "cpu")
    assert set(p.batches[0]) == {"uid", "item", "cate", "hist_item",
                                 "hist_cate", "label"}
    assert p.batches[0]["hist_item"].shape == (64, MIX["max_len"])
    assert p.width == 3 + 2 * MIX["max_len"] and len(p.batches) == 4


def test_pool_is_a_function_of_the_seed():
    a = traffic.make_pool(MIX, 256, 64, 2 ** 31 + 9, "cpu")
    b = traffic.make_pool(MIX, 256, 64, 2 ** 31 + 9, "cpu")
    c = traffic.make_pool(MIX, 256, 64, 2 ** 31 + 10, "cpu")
    for x, y in zip(a.batches, b.batches):
        assert all(np.array_equal(x[k], y[k]) for k in x)
    assert not np.array_equal(a.batches[0]["hist_item"],
                              c.batches[0]["hist_item"])


@pytest.mark.parametrize("exponent", [0.5, 0.0])
def test_histories_are_right_padded_within_the_lengths(exponent):
    mix = {**MIX, "length_exponent": exponent, "min_len": 2}
    cols = behavior.draw(mix, 20000, 5, "cpu")
    h = cols["hist_item"]
    valid = h >= 0
    n = valid.sum(1)
    assert int(n.min()) >= 2 and int(n.max()) <= mix["max_len"]
    # right-padded: every valid position precedes every padded one
    assert torch.equal(valid, torch.arange(h.shape[1])[None, :]
                       < n[:, None])
    assert torch.equal(cols["hist_cate"] >= 0, valid)
    share = torch.bincount(n - 2, minlength=mix["max_len"] - 1).double() \
        / len(n)
    k = torch.arange(1, mix["max_len"], dtype=torch.float64)
    want = k ** -exponent
    want = want / want.sum()
    assert torch.allclose(share, want, atol=0.015), (share, want)


def test_categories_are_a_function_of_the_item():
    cols = behavior.draw(MIX, 5000, 11, "cpu")
    (vi, ai), (vc, ac) = [(s["count"], a) for s, a in
                          zip(MIX["spaces"], MIX["zipf_exponents"])][:2]
    head = MIX["zipf_head"]
    items = torch.arange(vi)
    table = behavior.categories(items, vc, ac, head)
    assert int(table.min()) >= 0 and int(table.max()) < vc
    assert torch.equal(cols["cate"], table[cols["item"]])
    h = cols["hist_item"]
    valid = h >= 0
    assert torch.equal(cols["hist_cate"][valid], table[h[valid]])
    for name, v in (("uid", MIX["spaces"][2]["count"]), ("item", vi)):
        assert int(cols[name].min()) >= 0 and int(cols[name].max()) < v


@pytest.mark.parametrize("i", [0, 1, 2])
def test_each_exponent_is_the_fit_to_its_count(i):
    v, a = MIX["spaces"][i]["count"], MIX["zipf_exponents"][i]
    n = MIX["rows"]
    assert traffic.expected_distinct(a * (1 - 1e-4), n) > v
    assert traffic.expected_distinct(a * (1 + 1e-4), n) < v


def test_spaces_lanes_and_distinct_keys():
    p = traffic.make_pool(MIX, 256, 64, 2 ** 31 + 9, "cpu")
    assert [s.columns for s in p.spaces] == \
        [["item", "hist_item"], ["cate", "hist_cate"], ["uid"]]
    for b, batch in enumerate(p.batches):
        lanes, distinct = 0, 0
        for s in p.spaces:
            ids = np.concatenate([batch[c].reshape(-1) for c in s.columns])
            ids = ids[ids >= 0]
            assert sorted(s.ids[s.ends[b]:s.ends[b + 1]]) == sorted(ids)
            lanes += len(ids)
            distinct += len(np.unique(ids))
        assert p.lanes[b] == lanes and p.unique_counts[b] == distinct
