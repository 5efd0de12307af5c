"""What a run loads: no module whose top-level name is ``jax``,
``jaxlib``, ``flax`` or ``deeprec_tpu`` (compared whole: the port's
``deeprec_tpu_torch`` begins with the JAX package's name), and a
reference that imports nothing of the port."""
import ast
import json
import subprocess
import sys
from pathlib import Path

from perfbench.core import session

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / "perfbench"


def _loaded_after(code: str) -> list:
    prog = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); {code}; "
            "import json; print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_top_level_names_are_compared_whole():
    assert session.forbidden_modules(["deeprec_tpu_torch",
                                      "deeprec_tpu_torch.ops", "jaxtyping",
                                      "flaxen"]) == []
    assert session.forbidden_modules(["deeprec_tpu.sparse", "jax.numpy",
                                      "jaxlib", "flax.linen"]) == \
        ["deeprec_tpu", "flax", "jax", "jaxlib"]


def test_nothing_a_run_loads_is_jax_or_the_jax_package():
    mods = _loaded_after(
        "import perfbench.run, perfbench.calibrate; "
        "from perfbench.core import session, program; "
        "from perfbench import metrics, arith; "
        "[metrics.load(m['name']) for m in session.benchmark()['per_layer']]; "
        "[arith.load(c['name']) for c in session.benchmark()['configs']]; "
        "import perfbench.generators.behavior, perfbench.reference.dien; "
        "import deeprec_tpu_torch.train.cli, "
        "deeprec_tpu_torch.modelzoo.DLRM.train, "
        "deeprec_tpu_torch.modelzoo.DCN.train, "
        "deeprec_tpu_torch.modelzoo.DIEN.train, "
        "deeprec_tpu_torch.sparse.hashtable")
    assert "deeprec_tpu_torch" in mods
    assert session.forbidden_modules(mods) == []


def test_the_reference_imports_nothing_of_the_port():
    mods = _loaded_after("import perfbench.reference.train, "
                         "perfbench.reference.ctr, perfbench.reference.keys, "
                         "perfbench.reference.dien")
    assert not [m for m in mods if m.split(".")[0] in
                ("deeprec_tpu_torch", "deeprec_tpu", "jax", "flax")]
    for f in sorted((PB / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            assert all(n.split(".")[0] in ("torch", "numpy", "math",
                                           "contextlib", "typing", "importlib",
                                           "__future__") for n in names), \
                (f.name, names)
