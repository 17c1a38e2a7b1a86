"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program: top-level names compared
whole (the port's name begins with the JAX package's)."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "wgpu_3dgs_core_tpu"}
PORT = "wgpu_3dgs_core_tpu_torch"


def imported_tops(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not imported_tops(path) & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    for path in sorted((BENCH / "reference").rglob("*.py")):
        assert PORT not in imported_tops(path), path
    for name in ("roofline.py", "kinds.py", "trace.py"):
        assert PORT not in imported_tops(BENCH / name)


def test_whole_name_comparison():
    assert "wgpu_3dgs_core_tpu_torch".split(".")[0] not in FORBIDDEN
    assert imported_tops(BENCH / "scene.py") >= {"torch", "numpy"}
