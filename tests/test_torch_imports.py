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
print(len(names))
"""


def test_port_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 30  # every module was walked


def test_resolver_binding_copy_is_the_source():
    """utils/native.py copies the resolver half of the JAX package's
    binding: the wire layout, the resolver class (with its Python
    fallback) and the hash its bloom gate uses are the same source."""
    from deeprec_tpu.sparse import keys as jkeys
    from deeprec_tpu.utils import native as jnative
    from deeprec_tpu_torch.sparse import keys as tkeys
    from deeprec_tpu_torch.utils import native as tnative
    for name in ("HostIndexResolver", "wire_layout"):
        assert inspect.getsource(getattr(tnative, name)) == \
            inspect.getsource(getattr(jnative, name)), name
    assert inspect.getsource(tkeys.hash32_np) == \
        inspect.getsource(jkeys.hash32_np)
