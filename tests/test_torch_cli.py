"""The port's modelzoo entry points on the CPU: each of the seven models
trains through ``train.cli.run`` with ``--host_index --device cpu`` and
on the device-index engine (no ``--host_index``), which also runs
``--micro_batch 2`` and ``--ev_storage hbm_dram``; the CLI refuses what
the port does not run, naming the ROADMAP item;
fences fall on every multiple of ``--log_steps``; ``--checkpoint``
resumes the step count and ``--workqueue`` the queue position; a JAX CLI
save continues in the port's CLI as it continues in the JAX CLI, and a
port CLI save in the JAX CLI, on both engines; and the server's builder
answers an HTTP predict as the port's Predictor does."""
import importlib
import json
import os
import shutil
import sys
import threading
import urllib.request

import numpy as np
import pytest
import torch

from deeprec_tpu_torch.checkpoint import format as tformat
from deeprec_tpu_torch.data.criteo import SyntheticCriteo
from deeprec_tpu_torch.serving import Predictor
from deeprec_tpu_torch.serving.server import build_server
from deeprec_tpu_torch.train import cli
from deeprec_tpu_torch.train.summary import read_events

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)  # the JAX package's modelzoo/ for the parity runs

torch.set_num_threads(1)

MODELS = ["DLRM", "WDL", "DCN", "DeepFM", "DSSM", "DIN", "DIEN"]
# each model with another --optimizer: all ten choices among the runs
OPTIMIZER = {"DLRM": "adagrad_decay", "WDL": "momentum", "DCN": "sgd",
             "DeepFM": "proximal_gd", "DSSM": "adagrad_decay_v2",
             "DIN": "proximal_adagrad", "DIEN": "adam_async"}
SMALL = ["--batch_size", "32", "--emb_dim", "4", "--capacity", "8192",
         "--eval_steps", "1", "--synthetic_items", "500",
         "--synthetic_users", "50", "--prefetch_depth", "2",
         "--prefetch_workers", "2", "--log_steps", "100", "--host_index",
         "--jit_cache", ""]
DEVICE_INDEX = [a for a in SMALL if a != "--host_index"]


def _port(name, argv):
    mod = importlib.import_module(f"deeprec_tpu_torch.modelzoo.{name}.train")
    parser = mod.parser() if hasattr(mod, "parser") else \
        cli.base_parser(name)
    args = parser.parse_args(argv + ["--device", "cpu"])
    return mod, args


def _run(name, argv):
    mod, args = _port(name, argv)
    return cli.run(mod.build(args), args)


@pytest.mark.parametrize("name", MODELS)
def test_model_trains_through_the_cli(name, tmp_path):
    out = _run(name, SMALL + ["--steps", "3", "--optimizer",
                              OPTIMIZER[name], "--summary_dir",
                              str(tmp_path)])
    assert out["model"] == name and out["steps"] == 3
    assert 0.0 < out["train_loss"] < 10.0
    assert np.isfinite([out["train_auc"], out["eval_auc"]]).all()
    # the summary's last record is the held-out eval
    assert read_events(str(tmp_path))[-1]["phase"] == "eval"


def test_bf16_towers_train(tmp_path):
    out = _run("DCN", SMALL + ["--steps", "2", "--bf16"])
    assert out["steps"] == 2 and 0.0 < out["train_loss"] < 10.0


def test_profile_writes_a_trace(tmp_path):
    out = _run("DSSM", SMALL + ["--steps", "2", "--profile",
                                str(tmp_path)])
    trace = tmp_path / "DSSM_trace.json"
    assert out["steps"] == 2 and trace.stat().st_size > 0
    assert "traceEvents" in json.loads(trace.read_text())


@pytest.mark.parametrize("flags,item", [
    pytest.param(["--micro_batch", "2"], "C6", id="flags1-C6")])
def test_cli_refuses_what_is_not_ported(flags, item):
    with pytest.raises(NotImplementedError, match=item):
        _run("DLRM", SMALL + ["--steps", "1"] + flags)


@pytest.mark.parametrize("name", MODELS)
def test_model_trains_on_the_device_index_engine(name):
    """No --host_index: the device-index engine (the default optimizer,
    adagrad or adam, puts its slots in fused value columns)."""
    mod, args = _port(name, DEVICE_INDEX + ["--steps", "2"])
    spec = mod.build(args)
    out = cli.run(spec, args)
    assert out["model"] == name and out["steps"] == 2
    assert 0.0 < out["train_loss"] < 10.0
    assert np.isfinite([out["train_auc"], out["eval_auc"]]).all()
    emb = spec.collections["emb"]
    assert type(emb).__name__ == "EmbeddingCollection"
    assert emb.config.fused_slot_columns == \
        {"adagrad": 1, "adam": 2}[args.optimizer] * args.emb_dim


def test_device_index_micro_batch_trains():
    mod, args = _port("DLRM", DEVICE_INDEX + ["--steps", "3",
                                              "--micro_batch", "2"])
    out = cli.run(mod.build(args), args)
    assert out["steps"] == 3 and 0.0 < out["train_loss"] < 10.0


def test_device_index_hbm_dram_demotes(capsys):
    """--ev_storage hbm_dram with a device row budget below the live rows:
    the TieredTrainer demotes at every fence, and the summary is finite."""
    argv = DEVICE_INDEX + ["--steps", "6", "--ev_storage", "hbm_dram",
                           "--ev_hbm_capacity", "200", "--demote_steps",
                           "2"]
    i = argv.index("--log_steps")
    argv[i + 1] = "2"
    mod, args = _port("DLRM", argv)
    out = cli.run(mod.build(args), args)
    assert out["steps"] == 6 and np.isfinite(out["train_loss"])
    tiers = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("host tier rows: emb=")]
    assert len(tiers) == 3 and all(int(ln.split("=")[1]) > 0
                                   for ln in tiers)


def test_cli_device_defaults_to_the_card(monkeypatch):
    """``--device`` defaults to cuda and raises where torch sees no card:
    the CLI never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module("deeprec_tpu_torch.modelzoo.DCN.train")
    args = cli.base_parser("t").parse_args(SMALL + ["--steps", "1"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.run(mod.build(args), args)


def test_fences_fall_on_every_multiple_of_log_steps(tmp_path):
    """Pipeline depth 3, a fence every 5 steps over 20: the fences (the
    summary's metric records) are at steps 5, 10, 15 and 20, each on a
    drained pipeline (the fence's step count is the trainer's)."""
    argv = [a for a in SMALL] + ["--steps", "20", "--summary_dir",
                                 str(tmp_path)]
    i = argv.index("--log_steps")
    argv[i + 1] = "5"
    i = argv.index("--prefetch_depth")
    argv[i + 1] = "3"
    out = _run("DLRM", argv)
    fences = [e["step"] for e in read_events(str(tmp_path))
              if "phase" not in e and "loss" in e]
    health = [e["step"] for e in read_events(str(tmp_path))
              if e.get("phase") == "health"]
    assert fences == [5, 10, 15, 20] and health == fences
    assert out["steps"] == 20


def test_checkpoint_resumes_the_step_count(tmp_path):
    argv = SMALL + ["--steps", "3", "--checkpoint", str(tmp_path)]
    assert _run("WDL", argv)["steps"] == 3
    assert _run("WDL", argv)["steps"] == 6
    saves = tformat.list_saves(str(tmp_path))
    assert [m["step"] for m in saves][-1] == 6


def _criteo_file(path, seed, rows=8):
    b = next(iter(SyntheticCriteo(batch_size=rows, seed=seed)))
    with open(path, "w") as f:
        for r in range(rows):
            dense = [str(int(b[f"I{i}"][r] * 10)) for i in range(1, 14)]
            cats = [f"{int(b[f'C{i}'][r]) & 0xFFFFFFFF:08x}"
                    for i in range(1, 27)]
            f.write("\t".join([str(int(b["label"][r]))] + dense + cats)
                    + "\n")


def test_workqueue_position_resumes_after_a_restart(tmp_path):
    """--data_location over three written files (the last the holdout)
    with --workqueue and --checkpoint: the save carries the queue's
    claims; a restart rewinds the queue to them before any claim (a file
    claimed after the save is served again) and resumes the step count."""
    files = [str(tmp_path / f"day{i}.tsv") for i in range(3)]
    for i, f in enumerate(files):
        _criteo_file(f, i)
    qdir, cdir = str(tmp_path / "q"), str(tmp_path / "c")
    argv = SMALL + ["--steps", "3", "--batch_size", "4", "--data_location",
                    ",".join(files), "--workqueue", qdir, "--checkpoint",
                    cdir, "--prefetch_workers", "1"]
    assert _run("DLRM", argv)["steps"] == 3
    save = tformat.list_saves(cdir)[-1]["path"]
    with open(os.path.join(save, "aux_workqueue.json")) as f:
        snap = json.load(f)
    assert snap["items"] == files[:2] and snap["claims"]
    # a claim after the save, then a crash
    from deeprec_tpu_torch.data.work_queue import WorkQueue
    WorkQueue(files[:2], path=qdir, num_epochs=1000).take()
    assert len(os.listdir(os.path.join(qdir, "claims"))) > \
        len(snap["claims"])
    mod, args = _port("DLRM", argv)
    stream = cli.criteo_train_stream(args)
    assert sorted(os.listdir(os.path.join(qdir, "claims"))) == \
        sorted(snap["claims"])
    del stream
    assert _run("DLRM", argv)["steps"] == 6


# -- a JAX CLI save continued in both CLIs ---------------------------------
PARITY = {  # model -> optimizer
    "DLRM": "adagrad_decay",   # an int32 slot leaf
    "WDL": "momentum",         # FTRL wide, momentum deep, optax.sgd trace
    "DSSM": "adam_async",      # 0-d beta-power leaves, optax.adam
    "DIN": "proximal_adagrad",  # Dice statistics in the dense leaves
}
# rows, slot rows and dense leaves after 4 continued steps: f32 sums in
# another order, compounded over the steps (measured: at most 2.4e-7)
ROW_ATOL, DENSE_ATOL = 1e-6, 1e-6


def _by_key(table):
    order = np.argsort(table["keys"], kind="stable")
    return {k: (np.asarray(v)[order] if k not in ("cbf",) and
                np.ndim(v) and len(v) == len(order) else np.asarray(v))
            for k, v in table.items()}


def _assert_same_saves(pa, pb):
    """The newest saves of two directories: the same tables and columns,
    integer columns (keys, planes, int32 slot leaves) bit-equal by key,
    float ones within ROW_ATOL; the same dense leaves within DENSE_ATOL
    (the step bit-equal)."""
    sa, sb = tformat.list_saves(pa)[-1], tformat.list_saves(pb)[-1]
    assert sa["step"] == sb["step"]
    with open(os.path.join(sa["path"], "manifest.json")) as f:
        tables = sorted(json.load(f)["tables"])
    with open(os.path.join(sb["path"], "manifest.json")) as f:
        assert sorted(json.load(f)["tables"]) == tables
    for tname in tables:
        ref = _by_key(tformat.read_table(sa["path"], tname))
        got = _by_key(tformat.read_table(sb["path"], tname))
        assert sorted(ref) == sorted(got), tname
        for col, r in ref.items():
            g = got[col]
            assert g.dtype == r.dtype and g.shape == r.shape, col
            if r.dtype.kind in "iu":
                np.testing.assert_array_equal(g, r, err_msg=col)
            else:
                np.testing.assert_allclose(g, r, rtol=0, atol=ROW_ATOL,
                                           err_msg=f"{tname} {col}")
    da = tformat.read_dense(sa["path"])
    db = tformat.read_dense(sb["path"])
    assert len(da) == len(db)
    for x, y in zip(db, da):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        if y.dtype.kind in "iu":
            np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_allclose(x, y, rtol=0, atol=DENSE_ATOL)
    return sa["step"]


def _continue_in_both(name, optimizer, first, tmp_path, engine=SMALL):
    """``first`` ("jax" or "port") trains 4 steps into A, A is copied to
    B; the JAX CLI continues 4 steps in A (or B when the port went
    first), the port's CLI in the other. ``engine``: the flags with or
    without --host_index. Returns (dir A, dir B)."""
    from deeprec_tpu.train import cli as jcli
    # every flag a zoo __main__ sets a default for is given here, so the
    # JAX base parser and the port's model parser read the same run
    argv = engine + ["--steps", "4", "--optimizer", optimizer,
                    "--learning_rate", "0.01", "--max_unique_ratio", "0",
                    "--prefetch_workers", "1"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    jmod = importlib.import_module(f"modelzoo.{name}.train")

    def jax_run(d):
        args = jcli.base_parser(name).parse_args(argv + ["--checkpoint", d])
        return jcli.run(jmod.build(args), args)

    def port_run(d):
        return _run(name, argv + ["--checkpoint", d])
    runs = {"jax": jax_run, "port": port_run}
    other = "port" if first == "jax" else "jax"
    assert runs[first](a)["steps"] == 4
    shutil.copytree(a, b)
    assert runs[first](a)["steps"] == runs[other](b)["steps"] == 8
    return a, b


@pytest.mark.parametrize("name", list(PARITY))
def test_port_cli_continues_a_jax_cli_save(name, tmp_path):
    a, b = _continue_in_both(name, PARITY[name], "jax", tmp_path)
    assert _assert_same_saves(a, b) == 8


@pytest.mark.parametrize("name,optimizer", [
    ("DLRM", "adagrad_decay"), ("DSSM", "adam_async"),
    ("DCN", "sgd")])  # an empty slot state, optax.sgd without state
def test_jax_cli_continues_a_port_cli_save(name, optimizer, tmp_path):
    a, b = _continue_in_both(name, optimizer, "port", tmp_path)
    assert _assert_same_saves(a, b) == 8


@pytest.mark.parametrize("first", ["jax", "port"])
def test_device_index_cli_saves_continue_both_ways(first, tmp_path):
    """The device-index engine: DLRM with --optimizer adagrad (both CLIs
    rewrite it to fused accumulator columns), a save of either CLI
    continued in the other."""
    a, b = _continue_in_both("DLRM", "adagrad", first, tmp_path,
                             engine=DEVICE_INDEX)
    assert _assert_same_saves(a, b) == 8


def test_server_builder_answers_as_the_predictor(tmp_path):
    """``server.build_server`` on port 0 serves a port CLI save; its HTTP
    predict equals the port's Predictor on the same save."""
    ck = str(tmp_path / "ck")
    _run("DLRM", SMALL + ["--steps", "3", "--checkpoint", ck])
    srv, _ = build_server(["--model", "DLRM", "--ckpt_dir", ck, "--host",
                           "127.0.0.1", "--port", "0", "--", "--emb_dim",
                           "4", "--capacity", "8192", "--device", "cpu"])
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        batch = next(iter(SyntheticCriteo(batch_size=6, seed=5)))
        batch.pop("label")
        body = json.dumps({"inputs": {k: v.tolist() for k, v in
                                      batch.items()}}).encode()
        port = srv.server_address[1]
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/predict", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            got = json.loads(r.read())
    finally:
        srv.shutdown()
        srv.server_close()
    mod, args = _port("DLRM", SMALL + ["--emb_dim", "4"])
    spec = mod.build(args)
    pred = Predictor(spec.model, spec.numeric_columns, spec.collections, ck,
                     device="cpu")
    assert got["step"] == 3
    np.testing.assert_array_equal(np.asarray(got["predictions"],
                                             np.float32),
                                  np.asarray(pred.predict(batch), np.float32))
