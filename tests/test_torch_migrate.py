"""Port parity: DeepRec checkpoint migration (``checkpoint.bundle_reader``,
``checkpoint.migrate``) against the JAX package's, on bundles written by
TensorFlow's own ``SaveV2`` (the op DeepRec's Saver lowers to).

- The reader and migrate's numpy code are the JAX package's source.
- ``scan`` and ``load_ev_arrays`` equal the JAX ones on
  ``tests/test_migrate.py``'s bundle shape (a partitioned EV, a slot EV in
  its own key order missing keys, a second EV, dense tensors, a string).
- ``import_tables`` into a port ``Trainer`` equals the JAX import (rows by
  key bit-equal: keys, values, versions, freqs, create steps, slot rows),
  with plain and fused Adagrad, and the imported state trains; variant
  collections are reported unmatched, as in the JAX package.
- ``import_dense`` onto a torch model equals the JAX import onto params,
  kernels transposed; a shape mismatch raises.
- The offline CLI writes the JAX CLI's npz files and report.
- The committed fixture (``tests/torch_fixtures/deeprec_bundle``) reads
  equal to ``tf.train.load_checkpoint`` and to the arrays its script draws.

TensorFlow runs in one child process for the whole run
(:func:`tf_files`), so no test worker loads its runtime beside JAX's and
torch's. The module skips where TensorFlow is not installed.
"""
import importlib.util
import inspect
import json
import os
import subprocess
import sys

import filelock
import numpy as np
import pytest
import torch

if importlib.util.find_spec("tensorflow") is None:
    pytest.skip("TensorFlow is not installed: it writes the reference "
                "bundles", allow_module_level=True)

import jax  # noqa: E402
import optax  # noqa: E402

import deeprec_tpu as dr  # noqa: E402
from deeprec_tpu import feature_column as jfc  # noqa: E402
from deeprec_tpu.checkpoint import bundle_reader as jbr  # noqa: E402
from deeprec_tpu.checkpoint import migrate as jmig  # noqa: E402
from deeprec_tpu.checkpoint.saver import \
    table_snapshot_host as jsnap  # noqa: E402
from deeprec_tpu.models import ctr as jctr  # noqa: E402
from deeprec_tpu.optim import sparse as jsopt  # noqa: E402
from deeprec_tpu.train.trainer import Trainer as JTrainer  # noqa: E402

from deeprec_tpu_torch import config as tcfg  # noqa: E402
from deeprec_tpu_torch import feature_column as tfc  # noqa: E402
from deeprec_tpu_torch import feature_column_variants as tfv  # noqa: E402
from deeprec_tpu_torch.checkpoint import bundle_reader as tbr  # noqa: E402
from deeprec_tpu_torch.checkpoint import migrate as tmig  # noqa: E402
from deeprec_tpu_torch.checkpoint.saver import \
    table_snapshot_host as tsnap  # noqa: E402
from deeprec_tpu_torch.models import ctr as tctr  # noqa: E402
from deeprec_tpu_torch.optim import dense as tdense  # noqa: E402
from deeprec_tpu_torch.optim import sparse as tsopt  # noqa: E402
from deeprec_tpu_torch.train.trainer import Trainer as TTrainer  # noqa: E402

from tests.torch_fixtures import make_bundle  # noqa: E402

torch.set_num_threads(1)

DIM = 8
NAME_MAP = {"emb": {"C1": "dnn/C1/weights", "C2": "dnn/C2/weights"}}


_TF_CHILD = r"""
import json, sys
import numpy as np
import tensorflow as tf
for mode, spec_path in zip(sys.argv[1::2], sys.argv[2::2]):
    with open(spec_path) as f:
        spec = json.load(f)
    if mode == "save":
        with np.load(spec_path + ".npz") as z:
            tensors = [tf.constant(t["value"]) if t["string"]
                       else tf.constant(z[f"t{i}"])
                       for i, t in enumerate(spec["tensors"])]
        tf.raw_ops.SaveV2(prefix=spec["prefix"],
                          tensor_names=[t["name"] for t in spec["tensors"]],
                          shape_and_slices=[t["slice"]
                                            for t in spec["tensors"]],
                          tensors=tensors)
        continue
    ck = tf.train.load_checkpoint(spec["prefix"])
    names = sorted(ck.get_variable_to_shape_map())
    out = {}
    for i, n in enumerate(names):
        v = np.asarray(ck.get_tensor(n))
        if v.dtype.kind not in "OSU":
            out[f"t{i}"] = v
    np.savez(spec_path + ".npz", **out)
    spec["names"] = names
    with open(spec_path, "w") as f:
        json.dump(spec, f)
"""


def _in_tf(jobs, workdir):
    """Run ``_TF_CHILD`` once, in a child Python process, over ``jobs``:
    ``(mode, spec, arrays or None)``, passing arrays through files in
    ``workdir``. ``save`` writes a bundle with ``tf.raw_ops.SaveV2`` (the
    op DeepRec's Saver lowers to), ``load`` reads every tensor with
    ``tf.train.load_checkpoint``. Returns each job's spec and the arrays
    the child wrote for it."""
    argv, paths = [], []
    for mode, spec, arrays in jobs:
        path = os.path.join(str(workdir), f"{mode}.json")
        with open(path, "w") as f:
            json.dump(spec, f)
        if arrays is not None:
            np.savez(path + ".npz", **arrays)
        argv += [mode, path]
        paths.append(path)
    subprocess.run([sys.executable, "-c", _TF_CHILD, *argv],
                   check=True, capture_output=True, timeout=300)
    return [_tf_result(p) for p in paths]


def _tf_result(path):
    with open(path) as f:
        spec = json.load(f)
    with np.load(path + ".npz") as z:
        return spec, {k: z[k] for k in z.files}


def _save_job(prefix, tensors):
    """``tensors``: ``(name, slice_spec, array or str)``; a str is a
    DT_STRING tensor."""
    spec = {"prefix": prefix, "tensors": [
        {"name": n, "slice": sl, "string": isinstance(t, str),
         "value": t if isinstance(t, str) else None}
        for n, sl, t in tensors]}
    return ("save", spec,
            {f"t{i}": np.asarray(t) for i, (_, _, t) in enumerate(tensors)
             if not isinstance(t, str)})


def _ev_quad(name, keys, values, versions=None, freqs=None):
    n = len(keys)
    versions = np.asarray(versions if versions is not None
                          else np.arange(n), np.int64)
    freqs = np.asarray(freqs if freqs is not None else np.ones(n), np.int64)
    return [(name + "-keys", "", np.asarray(keys, np.int64)),
            (name + "-values", "", np.asarray(values, np.float32)),
            (name + "-versions", "", versions),
            (name + "-freqs", "", freqs)]


def _reference_bundle(prefix):
    """``tests/test_migrate.py``'s bundle: a partitioned EV with an Adagrad
    slot EV (its own order, two keys missing), a second EV with keys above
    2^32 and negative keys, a DCN head kernel, global_step, a string.
    Returns its tensors and the two EVs' keys."""
    rng = np.random.default_rng(42)
    c1_keys = np.arange(10, dtype=np.int64) * 7 + 1
    c1_vals = rng.standard_normal((10, DIM)).astype(np.float32)
    c1_vers = np.arange(100, 110, dtype=np.int64)
    c1_freqs = rng.integers(1, 50, 10).astype(np.int64)
    perm = rng.permutation(10)[:8]
    c2_keys = np.array([3, 5, (1 << 35) + 9, -11], np.int64)
    tensors = []
    tensors += _ev_quad("dnn/C1/weights/part_0", c1_keys[:6], c1_vals[:6],
                        c1_vers[:6], c1_freqs[:6])
    tensors += _ev_quad("dnn/C1/weights/part_1", c1_keys[6:], c1_vals[6:],
                        c1_vers[6:], c1_freqs[6:])
    tensors += _ev_quad("dnn/C1/weights/Adagrad", c1_keys[perm],
                        rng.uniform(0.1, 2.0, (8, DIM)).astype(np.float32))
    tensors += _ev_quad("dnn/C2/weights", c2_keys,
                        rng.standard_normal((4, DIM)).astype(np.float32))
    # the DCN of _pair: x0 = 1 dense + 2 x 8, deep 8 -> head over 17 + 8
    tensors.append(("head/kernel", "",
                    rng.standard_normal((25, 1)).astype(np.float32)))
    tensors.append(("deep/dense_0/bias", "",
                    rng.standard_normal(8).astype(np.float32)))
    tensors.append(("global_step", "", np.int64(500)))
    tensors.append(("ckpt/path", "", "unused-string"))
    return tensors, c1_keys, c2_keys


@pytest.fixture(scope="module")
def tf_files(tmp_path_factory):
    """The directory of the run's one TensorFlow child: it writes the
    reference bundle (``model.ckpt-500``) and reads the committed fixture
    (``load.json``). Test workers share it: the first to get here runs the
    child under a file lock, the others read its files."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    d = base / "tf_reference"
    with filelock.FileLock(str(d) + ".lock"):
        if not (d / "done").exists():
            d.mkdir(exist_ok=True)
            tensors, _, _ = _reference_bundle(str(d / "model.ckpt-500"))
            _in_tf([_save_job(str(d / "model.ckpt-500"), tensors),
                    ("load", {"prefix": make_bundle.PREFIX}, None)], d)
            (d / "done").write_text("")
    return d


@pytest.fixture(scope="module")
def deeprec_ckpt(tf_files):
    """The reference bundle's prefix and its two EVs' keys."""
    prefix = str(tf_files / "model.ckpt-500")
    _, c1_keys, c2_keys = _reference_bundle(prefix)
    return dict(prefix=prefix, c1_keys=c1_keys, c2_keys=c2_keys)


def _module_members(mod):
    return [n for n, v in vars(mod).items()
            if (inspect.isfunction(v) or inspect.isclass(v))
            and v.__module__ == mod.__name__]


def test_bundle_reader_copy_is_the_source():
    names = _module_members(jbr)
    assert set(names) == set(_module_members(tbr))
    for name in names:
        assert inspect.getsource(getattr(tbr, name)) == \
            inspect.getsource(getattr(jbr, name)), name
    ref = {k: v for k, v in jbr._DTYPES.items() if k != 14}
    assert tbr._DTYPES == ref and 14 not in tbr._DTYPES
    for const in ("TABLE_MAGIC", "FOOTER_LEN", "DT_STRING"):
        assert getattr(tbr, const) == getattr(jbr, const)


def test_migrate_numpy_code_is_the_source():
    for name in ("scan", "_aligned_rows", "_read_group_rows",
                 "load_ev_arrays", "_leaf_name_for_key", "_main", "EVGroup",
                 "BundleCatalog"):
        assert inspect.getsource(getattr(tmig, name)) == \
            inspect.getsource(getattr(jmig, name)), name
    assert tmig._SLOT_ORDER == jmig._SLOT_ORDER
    assert tmig._KNOWN_SLOT_SUFFIXES == jmig._KNOWN_SLOT_SUFFIXES
    assert tmig._PART_RE.pattern == jmig._PART_RE.pattern


def test_scan_and_ev_arrays_match_jax(deeprec_ckpt):
    jr, tr_ = (jbr.BundleReader(deeprec_ckpt["prefix"]),
               tbr.BundleReader(deeprec_ckpt["prefix"]))
    jcat, tcat = jmig.scan(jr), tmig.scan(tr_)
    assert tcat.dense == jcat.dense and tcat.skipped == jcat.skipped
    assert set(tcat.evs) == set(jcat.evs) == {"dnn/C1/weights",
                                              "dnn/C2/weights"}
    for base, jg in jcat.evs.items():
        tg = tcat.evs[base]
        assert (tg.parts, tg.dim, tg.rows, sorted(tg.slots)) == \
            (jg.parts, jg.dim, jg.rows, sorted(jg.slots))
        slot_map = [("Adagrad", "acc")]
        ja = jmig.load_ev_arrays(jr, jg, slot_map, {"acc": 0.1}, True)
        ta = tmig.load_ev_arrays(tr_, tg, slot_map, {"acc": 0.1}, True)
        assert sorted(ta) == sorted(ja)
        for k in ja:
            assert ta[k].dtype == ja[k].dtype
            np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)


def _pair(fused=False, kind="ev"):
    def cols(fcm):
        return [fcm.EmbeddingColumn(fcm.CategoricalColumn("C1"), DIM),
                fcm.EmbeddingColumn(fcm.CategoricalColumn("C2"), DIM)]
    kw = dict(name="emb", capacity=64, track_version=True)
    if fused:
        kw.update(fused_slot_columns=DIM, fused_slot_init=0.1)
    jinit = dr.Initializer(kind="normal", scale=0.05)
    tinit = tcfg.Initializer(kind="normal", scale=0.05)
    if kind == "ev":
        jcoll = jfc.EmbeddingCollection(cols(jfc), initializer=jinit, **kw)
        tcoll = tfc.EmbeddingCollection(cols(tfc), initializer=tinit, **kw)
    else:  # a variant collection: no single reference EV quad
        from deeprec_tpu import feature_column_variants as jfv
        jcoll = jfv.MultiHashCollection(cols(jfc), name="emb",
                                        table_sizes=(16, 8))
        tcoll = tfv.MultiHashCollection(cols(tfc), name="emb",
                                        table_sizes=(16, 8))
    jopt = (jsopt.sparse_adagrad_fused(0.05) if fused
            else jsopt.sparse_adagrad(0.05, initial_accumulator_value=0.1))
    topt = (tsopt.sparse_adagrad_fused(0.05) if fused
            else tsopt.sparse_adagrad(0.05, initial_accumulator_value=0.1))
    jt = JTrainer(model=jctr.DCN(emb_names=["C1", "C2"], cross_layers=1,
                                 deep_units=(8,)),
                  numeric_columns=[jfc.NumericColumn("I1")],
                  collections={"emb": jcoll},
                  sparse_optimizers={"emb": jopt},
                  dense_optimizer=optax.adagrad(0.05))
    tt = TTrainer(tctr.DCN(["C1", "C2"], DIM, cross_layers=1,
                           deep_units=(8,), dense_dim=1),
                  [tfc.NumericColumn("I1")], {"emb": tcoll}, {"emb": topt},
                  tdense.Adagrad(0.05), device="cpu")
    return jt, tt


def _batch(c1, c2):
    n = len(c1)
    return {"I1": np.ones(n, np.float32), "C1": np.asarray(c1, np.int64),
            "C2": np.asarray(c2, np.int64), "label": np.ones(n, np.float32)}


def _init(jt, tt):
    b = _batch([0] * 4, [0] * 4)
    return jt.init(jax.random.PRNGKey(0), b), tt.init(b)


def _by_key(snap):
    order = np.argsort(snap["keys"])
    return {k: np.asarray(v)[order] for k, v in snap.items()
            if np.ndim(v) and len(v) == len(order)}


@pytest.mark.parametrize("fused", [False, True], ids=["adagrad", "fused"])
def test_import_tables_matches_jax(deeprec_ckpt, fused):
    jt, tt = _pair(fused)
    js, ts = _init(jt, tt)
    js, jrep = jmig.import_tables(jt, js, deeprec_ckpt["prefix"],
                                  name_map=NAME_MAP, validate=True)
    ts, trep = tmig.import_tables(tt, ts, deeprec_ckpt["prefix"],
                                  name_map=NAME_MAP, validate=True)
    assert trep == jrep
    assert trep["imported"]["emb"]["rows"] == 14
    assert trep["slots"]["emb"] == ([] if fused else ["Adagrad->acc"])
    jc, tc = jt.collections["emb"].config, tt.collections["emb"].config
    assert tc.capacity == jc.capacity
    ja = _by_key(jsnap(jc, js.tables["emb"].ev, js.tables["emb"].slot,
                       evict=False))
    ta = _by_key(tsnap(tc, ts.tables["emb"].ev, ts.tables["emb"].slot,
                       evict=False))
    assert sorted(ta) == sorted(ja)
    for k in ja:
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
    # the index holds the JAX package's key plane
    from deeprec_tpu.sparse import keys as jkeys
    np.testing.assert_array_equal(
        ts.tables["emb"].ev.index.keys.numpy(),
        jkeys.to_numpy(js.tables["emb"].ev.index.stored_keys))
    # the imported state trains alike: one step on imported keys
    b = _batch(deeprec_ckpt["c1_keys"][:4], deeprec_ckpt["c2_keys"])
    tctr.load_flax_params(tt.model, [np.asarray(x) for x in
                                     jax.tree_util.tree_leaves(js.params)])
    ts = ts._replace(opt_state=tt.dense_optimizer.load_flax_state(
        tt.model, [np.asarray(x)
                   for x in jax.tree_util.tree_leaves(js.opt_state)]))
    js2, ts2 = jt.train_step(js, b), tt.train_step(ts, b)
    assert abs(float(js2.metrics.loss_sum) - float(ts2.metrics.loss_sum)) \
        <= 1e-5
    np.testing.assert_allclose(ts2.tables["emb"].ev.values.numpy(),
                               np.asarray(js2.tables["emb"].ev.values),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("mapping", ["unknown_ev", "variant"])
def test_import_unmatched_matches_jax(deeprec_ckpt, mapping):
    kind = "variant" if mapping == "variant" else "ev"
    jt, tt = _pair(kind=kind)
    js, ts = _init(jt, tt)
    name_map = {"emb": "no/such/ev"} if mapping == "unknown_ev" else NAME_MAP
    _, jrep = jmig.import_tables(jt, js, deeprec_ckpt["prefix"], name_map)
    ts2, trep = tmig.import_tables(tt, ts, deeprec_ckpt["prefix"], name_map)
    assert trep == jrep
    assert trep["unmatched_collections"] == ["emb"] and not trep["imported"]
    assert ts2.tables["emb"] is ts.tables["emb"]


def test_import_dense_matches_jax(deeprec_ckpt):
    jt, tt = _pair()
    js, _ = _init(jt, tt)
    tctr.load_flax_params(tt.model, [np.asarray(x) for x in
                                     jax.tree_util.tree_leaves(js.params)])
    name_map = {"head/kernel": "['params']['head']['kernel']",
                "deep/dense_0/bias": "['params']['MLPTower_0']['dense_0']"
                                     "['bias']",
                "nope": "['params']['head']['bias']",
                "global_step": "['params']['no']['such']"}
    jparams, jmiss = jmig.import_dense(js.params, deeprec_ckpt["prefix"],
                                       name_map)
    model, tmiss = tmig.import_dense(tt.model, deeprec_ckpt["prefix"],
                                     name_map)
    assert model is tt.model and tmiss == jmiss == ["nope", "global_step"]
    ref = [np.asarray(x) for x in jax.tree_util.tree_leaves(jparams)]
    got = tctr.flax_leaves(tt.model)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    # the path without the leading ['params'] names the same leaf
    w = tt.model.head.weight.detach().clone()
    with torch.no_grad():
        tt.model.head.weight.zero_()
    tmig.import_dense(tt.model, deeprec_ckpt["prefix"],
                      {"head/kernel": "['head']['kernel']"})
    assert torch.equal(tt.model.head.weight, w)


def test_import_dense_shape_mismatch(deeprec_ckpt):
    _, tt = _pair()
    with pytest.raises(ValueError, match="shape"):
        tmig.import_dense(tt.model, deeprec_ckpt["prefix"],
                          {"head/kernel": "['params']['MLPTower_0']"
                                          "['dense_0']['kernel']"})


def test_offline_cli_matches_jax(deeprec_ckpt, tmp_path):
    outs = {}
    for name, mod in (("jax", jmig), ("port", tmig)):
        out = str(tmp_path / name)
        assert mod._main(["--prefix", deeprec_ckpt["prefix"], "--out", out,
                          "--validate"]) == 0
        outs[name] = out
    files = sorted(os.listdir(outs["jax"]))
    assert sorted(os.listdir(outs["port"])) == files
    assert "migration_report.json" in files and "dense.npz" in files
    for f in files:
        a, b = (os.path.join(outs[n], f) for n in ("jax", "port"))
        if f.endswith(".json"):
            with open(a) as fa, open(b) as fb:
                assert json.load(fa) == json.load(fb)
            continue
        with np.load(a) as za, np.load(b) as zb:
            assert sorted(za.files) == sorted(zb.files)
            for k in za.files:
                assert za[k].dtype == zb[k].dtype
                np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


def test_committed_fixture_reads_as_tensorflow_and_its_script(tf_files):
    prefix = make_bundle.PREFIX
    r = tbr.BundleReader(prefix)
    spec, arrays = _tf_result(str(tf_files / "load.json"))
    assert spec["prefix"] == prefix
    names = r.keys()
    assert names == spec["names"]
    for i, name in enumerate(names):
        if name == "ckpt/path":
            assert f"t{i}" not in arrays
            with pytest.raises(NotImplementedError):
                r.get_tensor(name)
            continue
        got, want = r.get_tensor(name, validate=True), arrays[f"t{i}"]
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    a = make_bundle.fixture_arrays()
    cat = tmig.scan(r)
    assert len(cat.evs) == make_bundle.N_COLUMNS
    g1 = cat.evs[make_bundle.ev_name(1)]
    assert len(g1.parts) == 2 and sorted(g1.slots) == ["Adagrad"]
    for c, ev in a["evs"].items():
        arrays = tmig.load_ev_arrays(r, cat.evs[make_bundle.ev_name(c)])
        for f in ("keys", "values", "versions", "freqs"):
            np.testing.assert_array_equal(arrays[f], ev[f], err_msg=f)
    for name, want in a["dense"].items():
        np.testing.assert_array_equal(r.get_tensor(name), want)
    assert int(r.get_tensor("global_step")) == a["global_step"]
    # the bottom-MLP names map onto the port's full-width DLRM
    from deeprec_tpu_torch.data.criteo import CAT_NAMES
    model = tctr.DLRM(CAT_NAMES, 16)
    _, missing = tmig.import_dense(
        model, prefix, dict(make_bundle.bottom_names()))
    assert missing == []
    np.testing.assert_array_equal(
        model.bottom.hidden[0].weight.detach().numpy().T,
        a["dense"]["dlrm/bottom_mlp/dense_0/kernel"])
    size = sum(os.path.getsize(os.path.join(os.path.dirname(prefix), f))
               for f in os.listdir(os.path.dirname(prefix)))
    assert size <= 1 << 20
