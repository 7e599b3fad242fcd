"""The import guard: no module of the benchmark, and no module a run
loads, has ``jax``, ``jaxlib``, ``flax`` or ``cupyimg_tpu`` as its
top-level name (compared whole: ``cupyimg_tpu_torch`` is the program);
and ``reference/`` imports nothing of the program."""

import ast
import json
import subprocess
import sys

from conftest import CHECKOUT

from portbench.harness import FORBIDDEN

BENCH = CHECKOUT / "portbench"


def imported_names(path):
    """Top-level names of every module ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def sources():
    return sorted(BENCH.rglob("*.py"))


def test_no_benchmark_module_imports_jax_or_the_jax_package():
    assert len(sources()) > 20
    for path in sources():
        bad = imported_names(path) & set(FORBIDDEN)
        assert not bad, f"{path} imports {bad}"


def test_whole_names_are_compared():
    assert "cupyimg_tpu_torch" not in FORBIDDEN
    assert imported_names(BENCH / "harness.py").isdisjoint(FORBIDDEN)


def test_references_import_nothing_of_the_program():
    for path in sorted((BENCH / "reference").glob("*.py")):
        assert "cupyimg_tpu_torch" not in imported_names(path), path


SCRIPT = """
import json, sys, time
sys.path.insert(0, {root!r})
from portbench import harness
spec = json.load(open({spec!r}))
shapes = {{"vol256_f32": (8, 9, 10), "img4096_f32": (24, 20)}}
for w in spec["workloads"]:
    harness.run_cell(w["name"], 5, 0.05, True, spec, time.perf_counter(),
                     device="cpu", shape=shapes[w["config"]],
                     log=open("/dev/null", "w"))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_a_run_loads_no_forbidden_module():
    code = SCRIPT.format(root=str(CHECKOUT),
                         spec=str(CHECKOUT / "BENCHMARK.json"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=CHECKOUT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    loaded = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "cupyimg_tpu_torch" in loaded and "portbench" in loaded
    assert loaded.isdisjoint(FORBIDDEN)
