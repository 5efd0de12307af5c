"""The port must run where JAX is not installed: every module of
deeprec_tpu_torch imports with jax, flax, optax, ml_dtypes and the JAX
package blocked. Its copies of framework-free JAX-package code stay
verbatim copies."""
import inspect
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import sys
for name in ("jax", "jaxlib", "flax", "optax", "ml_dtypes", "deeprec_tpu"):
    sys.modules[name] = None  # any import of these raises ImportError
import importlib, pkgutil
import deeprec_tpu_torch
names = [m.name for m in pkgutil.walk_packages(deeprec_tpu_torch.__path__,
                                               "deeprec_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "flax", "optax", "ml_dtypes",
                                       "deeprec_tpu")
                and sys.modules[m] is not None)
assert not leaked, leaked
print(" ".join(names))
"""


def test_port_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 40  # every module was walked
    # the zoo's modules among them, the sequence models too
    assert {f"deeprec_tpu_torch.{m}" for m in (
        "models.ctr", "models.layers", "models.structured",
        "models.sequence", "optim.sparse", "optim.dense",
        "data.behavior")} <= names
    # the entry points: the CLI, its data plumbing, the zoo, the server
    assert {f"deeprec_tpu_torch.{m}" for m in (
        "train.cli", "train.summary", "data.criteo", "data.work_queue",
        "data.prefetch", "serving.server")} <= names
    assert {f"deeprec_tpu_torch.modelzoo.{m}.train" for m in (
        "DLRM", "WDL", "DCN", "DeepFM", "DSSM", "DIN", "DIEN")} <= names
    # the device-index engine's own modules
    assert {f"deeprec_tpu_torch.{m}" for m in (
        "ops.segment", "sparse.tiered", "train.tiered_trainer",
        "train.estimator")} <= names
    # the variant tables, the reference-name API and checkpoint migration
    assert {f"deeprec_tpu_torch.{m}" for m in (
        "sparse.multihash", "sparse.dynamicdim", "sparse.adaptive",
        "sparse.hash_table_api", "feature_column_variants", "api",
        "checkpoint.bundle_reader", "checkpoint.migrate")} <= names
    # the mesh engine: neither jax nor deeprec_tpu under parallel/
    assert {f"deeprec_tpu_torch.{m}" for m in (
        "parallel", "parallel.multihost", "parallel.sharded",
        "parallel.trainer")} <= names
    # the host-sharded engine and its host exchange, the tiered mesh, the
    # sharded hash table
    assert {f"deeprec_tpu_torch.{m}" for m in (
        "parallel.host_sharded", "parallel.host_exchange",
        "parallel.tiered", "parallel.hash_table")} <= names
    # the long-run checks: the soak and the sequence-fidelity bisect
    assert {f"deeprec_tpu_torch.{m}" for m in (
        "harness", "harness.soak", "harness.behavior_oracle",
        "harness.sequence_fidelity")} <= names
    # the design probes, the step bisect among them
    assert {f"deeprec_tpu_torch.{m}" for m in (
        "probes.kernel_probe", "probes.step_bisect")} <= names


def test_resolver_binding_copy_is_the_source():
    """utils/native.py copies the resolver and tier half of the JAX
    package's binding: the wire layout, the resolver class (with its
    Python fallback), the tier stores (with their dict fallback) and the
    hash its bloom gate uses are the same source."""
    from deeprec_tpu.sparse import keys as jkeys
    from deeprec_tpu.utils import native as jnative
    from deeprec_tpu_torch.sparse import keys as tkeys
    from deeprec_tpu_torch.utils import native as tnative
    for name in ("HostIndexResolver", "wire_layout", "HostKV", "TierStack",
                 "criteo_parse_chunk"):
        assert inspect.getsource(getattr(tnative, name)) == \
            inspect.getsource(getattr(jnative, name)), name
    assert inspect.getsource(tkeys.hash32_np) == \
        inspect.getsource(jkeys.hash32_np)


def test_entry_point_copies_are_the_source():
    """The framework-free modules the CLI needs are verbatim copies: the
    WorkQueue and its input producer, the summary writer and reader, the
    Criteo readers and their token hash; the prefetcher's worker loop,
    turnstile, consumer and close are the JAX code (only its default
    device_put differs: the identity, not jax.device_put)."""
    from deeprec_tpu.data import criteo as jcriteo
    from deeprec_tpu.data import prefetch as jprefetch
    from deeprec_tpu.data import work_queue as jwq
    from deeprec_tpu.train import summary as jsummary
    from deeprec_tpu_torch.data import criteo as tcriteo
    from deeprec_tpu_torch.data import prefetch as tprefetch
    from deeprec_tpu_torch.data import work_queue as twq
    from deeprec_tpu_torch.train import summary as tsummary
    pairs = [(twq, jwq, ("WorkQueue", "input_producer")),
             (tsummary, jsummary, ("SummaryWriter", "read_events")),
             (tcriteo, jcriteo, ("_mix64", "_hash_token", "read_criteo",
                                 "read_criteo_native", "_pack_arrays",
                                 "_pack", "SyntheticCriteo"))]
    for tmod, jmod, names in pairs:
        for name in names:
            assert inspect.getsource(getattr(tmod, name)) == \
                inspect.getsource(getattr(jmod, name)), name
    for meth in ("_run", "_emit", "__next__", "close"):
        assert inspect.getsource(getattr(tprefetch.Prefetcher, meth)) == \
            inspect.getsource(getattr(jprefetch.Prefetcher, meth)), meth
    assert inspect.getsource(tprefetch.staged) == \
        inspect.getsource(jprefetch.staged)
