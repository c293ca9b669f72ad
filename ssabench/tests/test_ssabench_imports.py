"""What the benchmark loads: never JAX or the JAX package (compared by whole
top-level name, as the port's name begins with the JAX package's), no port
code in the plain reference, and nothing read from bench.py or benchmarks/."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1]
SOURCES = sorted(p for p in PKG.rglob("*.py") if "tests" not in p.relative_to(PKG).parts)
FORBIDDEN = {"jax", "jaxlib", "flax", "libssa_tpu"}


def imported_tops(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(PKG).as_posix())
def test_no_jax_import(path):
    assert not imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((PKG / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_no_port(path):
    assert imported_tops(path) <= {"__future__", "numpy", "torch", "re"}


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(PKG).as_posix())
def test_reads_nothing_of_bench_py_or_benchmarks(path):
    tree = ast.parse(path.read_text())
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef)) and n.body
            and isinstance(n.body[0], ast.Expr) and isinstance(n.body[0].value, ast.Constant)}
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) and id(node) not in docs:
            assert "bench.py" not in node.value and "benchmarks" not in node.value


def test_forbidden_names_are_whole_top_level_names():
    from ssabench import run

    saved = dict(sys.modules)
    try:
        sys.modules.setdefault("libssa_tpu_torch_fake", object())
        assert "libssa_tpu" not in run.forbidden_modules()
        sys.modules["libssa_tpu.api"] = object()
        assert run.forbidden_modules() == ["libssa_tpu"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_a_whole_run_loads_no_jax(tmp_path):
    """A traced CPU run of a tiny cell in a fresh process, then the check."""
    code = (
        "import sys, time; from ssabench.tests import tiny; from ssabench import harness, run\n"
        f"root = tiny.make_root(__import__('pathlib').Path({str(tmp_path)!r}))\n"
        "for cell in ('tiny_single', 'tiny_align'):\n"
        "    harness.run_cell(root, cell, 5, 0.2, True, 'cpu', time.perf_counter())\n"
        "import ssabench.control\n"
        "print('FORBIDDEN', run.forbidden_modules())\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "FORBIDDEN []"
