"""Nothing the benchmark runs imports JAX or the JAX package, and the plain
reference imports nothing of the program."""

import ast
import subprocess
import sys

from benchmark.manifest import ROOT

BENCH = ROOT / "benchmark"
FORBIDDEN = {"jax", "jaxlib", "flax", "nsgp_tpu"}  # whole top-level names: nsgp_tpu_torch passes
# What the comparison decides on may not come from the program under test.
YARDSTICK = ("reference.py", "inputs.py", "counts.py", "manifest.py", "traced.py")


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_jax_anywhere():
    for path in BENCH.rglob("*.py"):
        assert not top_level_imports(path) & FORBIDDEN, path


def test_yardstick_imports_nothing_of_the_program():
    for name in YARDSTICK:
        assert "nsgp_tpu_torch" not in top_level_imports(BENCH / name), name


def test_a_run_loads_no_jax():
    """A whole run of a small cell on the CPU leaves no JAX module loaded."""
    code = (
        "import sys, time\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from benchmark.manifest import Manifest\n"
        "from benchmark import run\n"
        "from benchmark.tests.small import OVERRIDES\n"
        "r = run.run_cell(Manifest(), 'ep_piano_100k', 5, 0.1, False, 'cpu', time.time(),\n"
        "                 dict(OVERRIDES['ep_piano_100k'], T=120))\n"
        "print(run.forbidden_modules())\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"
