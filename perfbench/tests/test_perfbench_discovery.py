"""Cells, configurations, traffic mixes, arith modules and per-layer
readers are found by the names ``BENCHMARK.json`` gives, and the file
keeps the contract's shape."""
import json
import re
from pathlib import Path

import pytest

from perfbench import arith, metrics
from perfbench.core import compare, session

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_is_found_by_name(w):
    cell = session.load_json("cells", w["name"])
    assert cell["name"] == w["name"]
    assert (cell["config"], cell["traffic"], cell.get("chips", 1)) == \
        (w["config"], w["traffic"], w["chips"])
    cfg = session.load_json("configs", cell["config"])
    mix = session.load_json("traffic", cell["traffic"])
    assert cfg["name"] == w["config"] and mix["name"] == w["traffic"]
    assert set(cell["limits"]) == set(compare.NUMBERS)
    assert cell["pool_examples"] % cell["batch"] == 0
    assert cell["pool_examples"] // cell["batch"] > 3 + cell["warm_steps"]
    assert len(mix["columns"]) == cfg["categorical_columns"] == \
        len(mix["column_counts"])
    assert mix["dense_names"] == cfg["dense_names"]


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_each_config_has_its_file_and_arith(c):
    cfg = json.loads((ROOT / c["file"]).read_text())
    assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    assert cfg["source"] == c["source"]
    assert arith.load(c["name"]).train_flops_per_example(cfg) > 0


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_each_per_layer_metric_has_a_reader(m):
    assert callable(metrics.load(m["name"]).read)
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert set(m.get("workloads", [])) <= {w["name"]
                                           for w in BENCH["workloads"]}


def test_benchmark_json_keeps_the_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all("\n" not in x and len(x) <= 200 for x in layers)
    assert all(len(w["why"]) <= 200 for w in BENCH["workloads"])
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    assert len(json.dumps(BENCH)) < 64 * 1024


DATA = Path(__file__).resolve().parent / "data"
CONFIGS = [json.loads((ROOT / c["file"]).read_text())
           for c in BENCH["configs"]] + [
    session.load_json("configs", "dcn_kaggle"),
    json.loads((DATA / "configs" / "dien_tiny.json").read_text())]


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c["name"])
def test_a_reference_is_found_by_the_configuration_model(cfg):
    """``reference/<model>.py`` lists the program model's parameters by
    name and shape, in its order (``program.load_weights`` holds them to
    it), and ``flags`` reach the entry's argv last."""
    from perfbench.core import program
    from perfbench.reference import ctr
    ref = ctr.model(cfg)
    assert ref.__name__ == f"perfbench.reference.{cfg['model']}"
    tr, args = program.build({**cfg, "capacity": 1 << 10,
                              "flags": ["--prefetch_depth", "3"]},
                             64, 0.5, 7, "cpu")
    assert args.prefetch_depth == 3
    assert [(n, tuple(p.shape)) for n, p in tr.model.named_parameters()] \
        == [(n, tuple(s)) for n, s, _ in ref.params(cfg)]
