"""Nothing that a benchmark run loads is JAX or the JAX package (top-level
module names compared whole: ``pathtrace_tpu_torch`` is not
``pathtrace_tpu``), and the reference side loads nothing of the program."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

from ptbench import harness
from ptbench.run import FORBIDDEN, loaded_forbidden

# The modules of the check's reference side: none may import the program.
REFERENCE_SIDE = ("reference.py", "refmath.py", "scene.py", "check.py", "materials",
                  "recipes", "cameras")


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant):
                tops.add(arg.value.split(".")[0])
    return tops


def _sources():
    return [p for p in harness.BENCH_DIR.rglob("*.py") if "tests" not in p.parts]


def test_no_benchmark_module_imports_jax_or_the_jax_package():
    for path in _sources():
        assert not _imports(path) & set(FORBIDDEN), path


def test_the_reference_side_imports_nothing_of_the_program():
    for path in _sources():
        rel = path.relative_to(harness.BENCH_DIR)
        if rel.parts[0] in REFERENCE_SIDE:
            assert "pathtrace_tpu_torch" not in _imports(path), path


def test_the_reference_loads_nothing_of_the_program_or_jax():
    code = ("import sys; import ptbench.reference, ptbench.check; "
            "import ptbench.recipes.knot_field, ptbench.recipes.sphere_field, "
            "ptbench.cameras.orbit; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'pathtrace_tpu_torch', 'pathtrace_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=harness.BENCH_DIR.parent, check=True)
    assert out.stdout.strip() == "[]"


def test_the_top_level_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "pathtrace_tpu_torch_probe", sys)
    assert "pathtrace_tpu" not in loaded_forbidden()
    monkeypatch.setitem(sys.modules, "pathtrace_tpu.probe", sys)
    assert "pathtrace_tpu" in loaded_forbidden()
