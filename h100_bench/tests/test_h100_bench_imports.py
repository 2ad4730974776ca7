"""Nothing the benchmark loads is JAX or the JAX package, compared by whole
top-level names (the port's name begins with the JAX package's), and no
reference imports anything of the port."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from h100_bench import run as R

FORBIDDEN = {"jax", "jaxlib", "flax", "laudnet_tpu"}


def test_a_cells_modules_load_no_jax():
    """In a fresh process: the harness, every file a cell names, and the
    port's entries those build (on the CPU, at a tiny size)."""
    code = f"""
import json, sys
sys.path.insert(0, {str(R.HERE / 'tests')!r})
from bench_tiny import DEIT, RESNET, tiny_run
from h100_bench import run as R, control, faults
for workload in (DEIT, RESNET):
    R.execute(tiny_run(workload, seconds=0.1))
for m in R.load_json(R.BENCHMARK)["per_layer"]:
    R.load_module("metrics", m["name"])
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=R.HERE.parent, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "laudnet_tpu_torch" in tops and "torch" in tops
    assert not tops & FORBIDDEN


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_references_import_only_torch():
    for path in sorted((R.HERE / "reference").glob("*.py")):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert tops <= {"__future__", "contextlib", "math", "torch"}, path


def test_no_harness_file_imports_jax():
    for path in sorted(R.HERE.rglob("*.py")):
        if "tests" in path.parts:
            continue
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & FORBIDDEN, path
