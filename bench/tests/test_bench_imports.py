"""What the benchmark loads: no JAX, flax or the JAX package (``repro``),
top-level names compared whole, so that ``repro_torch`` passes; and the
reference loads nothing of the program."""
import ast
import subprocess
import sys
from pathlib import Path

import tiny

BENCH = tiny.BENCH
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module


def test_no_source_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        top = {m.split(".")[0] for m in _imports(path)}
        assert not top & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert not any(m.split(".")[0] == "repro_torch"
                       for m in _imports(path)), path
    names = sorted(p.stem for p in (BENCH / "reference").glob("*.py"))
    assert "model" in names
    code = ("import importlib, sys; sys.path.insert(0, %r); "
            "[importlib.import_module('reference.' + n) for n in %r]; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % (str(BENCH), names))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    assert "repro_torch" not in out and "'repro'" not in out


def test_a_run_loads_no_forbidden_module():
    code = f"""
import sys
sys.path.insert(0, {str(BENCH / 'tests')!r})
import tiny
import run
from harness.report import run_cell
cell = tiny.tiny_cell("granite-moe-3b-a800m", "backlog")
line = run_cell(cell, 5, 1.0, True, device="cpu")
assert line["correct"], line
print("LOADED", run.forbidden_modules(),
      "repro_torch" in {{m.split(".")[0] for m in sys.modules}})
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         env={"PYTHONPATH": str(tiny.ROOT / "src"),
                              "PATH": "/usr/bin:/bin"}).stdout
    assert out.strip().splitlines()[-1] == "LOADED [] True"
