"""Nothing the benchmark runs imports JAX or the JAX package (top-level
module names compared whole: the port's name begins with the JAX
package's), and the reference imports nothing of the port."""

import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "multi_orb_slam_tpu"}


def imported(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources(*parts):
    return [p for part in parts for p in (BENCH / part).rglob("*.py")]


def test_run_path_imports_no_jax():
    for p in sources("harness", "metrics", "reference") + [BENCH / "run.py"]:
        assert not imported(p) & FORBIDDEN, p


def test_reference_imports_nothing_of_the_port():
    for p in sources("reference"):
        assert not imported(p) & (FORBIDDEN | {"multi_orb_slam_tpu_torch", "harness"}), p


def test_loaded_modules_hold_no_jax():
    code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]\n"
            "import run, harness.drive, harness.checks\n"
            "from multi_orb_slam_tpu_torch import system\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & set(sys.argv[3].split(','))))")
    out = subprocess.run([sys.executable, "-c", code, str(BENCH), str(BENCH.parent),
                          ",".join(FORBIDDEN)], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
