"""Nothing of the benchmark imports JAX or the JAX package, by top-level
names compared whole (``netsdb_tpu_torch`` begins with ``netsdb_tpu``),
and the yardstick imports nothing of the program."""

import ast
import subprocess
import sys

from perfbench import run
from perfbench.manifest import PKG_DIR

#: the yardstick: data, references, counts, traffic, trace reading and
#: the comparison. Only ``systems/``, ``run.py``, ``calibrate.py`` and the
#: readers that time the program's kernels reach the program.
YARDSTICK = ("arithmetic.py", "devtrace.py", "judge.py", "manifest.py",
             "traffic.py", "kinds")


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources():
    return [p for p in PKG_DIR.rglob("*.py") if ".cache" not in p.parts]


def test_no_module_imports_jax_or_the_jax_package():
    found = [(str(p), name) for p in _sources() for name in _imports(p)
             if name.split(".", 1)[0] in run.FORBIDDEN]
    assert found == []


def test_the_yardstick_imports_nothing_of_the_program():
    for p in _sources():
        rel = p.relative_to(PKG_DIR).parts
        if rel[0] in YARDSTICK:
            assert not [n for n in _imports(p)
                        if n.split(".", 1)[0] == "netsdb_tpu_torch"], p


def test_forbidden_names_are_compared_whole():
    names = ["netsdb_tpu_torch", "netsdb_tpu_torch.client", "netsdb_tpu",
             "netsdb_tpu.ops.matmul", "jax", "jax.numpy", "jaxlib",
             "jaxtyping", "flax", "flaxen", "perfbench"]
    assert run.forbidden_modules(names) == [
        "flax", "jax", "jax.numpy", "jaxlib", "netsdb_tpu",
        "netsdb_tpu.ops.matmul"]


def test_a_run_loads_no_jax():
    """A whole run of a tiny cell on the CPU, then the process's modules."""
    code = (
        "import sys, tempfile, pathlib\n"
        "from perfbench.tests.conftest import tiny_benchmark\n"
        "from perfbench import run\n"
        "man = tiny_benchmark(pathlib.Path(tempfile.mkdtemp()))\n"
        "for cell in ('ff.tiny', 'layer.tiny'):\n"
        "    assert run.measure(man, cell, 5, 0.1, False, 'cpu')['correct']\n"
        "print(run.forbidden_modules(list(sys.modules)))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=PKG_DIR.parent,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"
