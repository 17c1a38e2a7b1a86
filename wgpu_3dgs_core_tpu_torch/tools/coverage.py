"""Line coverage of the torch port's package, the counterpart of the
repo's ``coverage/run.py``.

Records the executed lines of ``wgpu_3dgs_core_tpu_torch/`` with Python
3.12's ``sys.monitoring`` (PEP 669) while, all under one monitor, it
runs pytest (by default over the port's test files, ``tests/test_torch_*.py``),
every example of ``wgpu_3dgs_core_tpu_torch.examples`` (each writing into
a temporary directory) and the doctests of the package's modules, then
counts each module's lines against the statement lines its code objects
hold. Writes ``badge.json`` and ``report.json`` into ``--out`` (default
``_build/coverage/`` inside the package), never into the repo's
``coverage/``.

    python wgpu_3dgs_core_tpu_torch/tools/coverage.py [--out DIR]
        [--device cpu] [-- pytest arguments...]

Run as a script, so that the package is first imported while the lines
are recorded (``python -m`` imports it before; that form re-runs itself as
the script). ``--device`` is the examples' device (the card by default);
the tests choose their own. Exits nonzero when a test, an example or a
doctest fails.
"""

from __future__ import annotations

import argparse
import doctest
import importlib
import json
import subprocess
import sys
from pathlib import Path
from typing import Optional, Sequence

PACKAGE_DIR = Path(__file__).resolve().parents[1]
REPO = PACKAGE_DIR.parent
DEFAULT_OUT = PACKAGE_DIR / "_build" / "coverage"
TOOL_ID = 3  # sys.monitoring's COVERAGE_ID slot
EXAMPLES = ("read_ply", "write_ply", "read_spz", "write_spz",
            "render_scene", "fit_scene")
EXAMPLE_ARGS = {"render_scene": ["--width", "64", "--height", "48"],
                "fit_scene": ["--steps", "2"]}


def default_pytest_args() -> list[str]:
    return [*sorted(str(p) for p in (REPO / "tests").glob("test_torch_*.py")),
            "-q", "-p", "no:cacheprovider"]


class LineRecorder:
    """The lines of files under ``root`` that ran while it was active."""

    def __init__(self, root: Path):
        self.root = str(root)
        self.executed: dict[str, set[int]] = {}

    def _on_line(self, code, line):
        if code.co_filename.startswith(self.root):
            self.executed.setdefault(code.co_filename, set()).add(line)
        return sys.monitoring.DISABLE  # each line once: near-zero overhead

    def __enter__(self) -> "LineRecorder":
        sys.monitoring.use_tool_id(TOOL_ID, "coverage")
        sys.monitoring.register_callback(
            TOOL_ID, sys.monitoring.events.LINE, self._on_line)
        sys.monitoring.set_events(TOOL_ID, sys.monitoring.events.LINE)
        return self

    def __exit__(self, *exc) -> None:
        sys.monitoring.set_events(TOOL_ID, 0)
        sys.monitoring.register_callback(
            TOOL_ID, sys.monitoring.events.LINE, None)
        sys.monitoring.free_tool_id(TOOL_ID)


def statement_lines(path: Path) -> set[int]:
    """Every line a code object of the file can execute."""
    try:
        top = compile(path.read_text(), str(path), "exec")
    except SyntaxError:
        return set()
    lines: set[int] = set()
    stack = [top]
    while stack:
        code = stack.pop()
        lines.update(line for _, _, line in code.co_lines()
                     if line is not None and line > 0)
        stack.extend(c for c in code.co_consts if isinstance(c, type(top)))
    return lines


def package_files() -> list[Path]:
    return sorted(p for p in PACKAGE_DIR.rglob("*.py")
                  if "_build" not in p.relative_to(PACKAGE_DIR).parts)


def run_examples(device: str) -> int:
    rc = 0
    for name in EXAMPLES:
        mod = importlib.import_module(
            f"wgpu_3dgs_core_tpu_torch.examples.{name}")
        print(f"-- example {name}", flush=True)
        try:
            rc |= int(bool(mod.main(["--device", device,
                                     *EXAMPLE_ARGS.get(name, [])])))
        except Exception as e:  # noqa: BLE001 - report and go on
            print(f"example {name} FAILED: {e!r}")
            rc = 1
    return rc


def run_doctests() -> int:
    rc, n = 0, 0
    for path in package_files():
        rel = path.relative_to(REPO).with_suffix("")
        name = ".".join(rel.parts).removesuffix(".__init__")
        res = doctest.testmod(importlib.import_module(name), verbose=False)
        n += res.attempted
        if res.failed:
            print(f"doctest FAILED in {name}: {res.failed}")
            rc = 1
    print(f"-- doctests: {n} examples")
    return rc


def report(executed: dict[str, set[int]]) -> tuple[float, dict]:
    """(total percent, percent by file relative to the repo)."""
    total = hit = 0
    per_file = {}
    for path in package_files():
        stmts = statement_lines(path)
        got = executed.get(str(path), set()) & stmts
        total += len(stmts)
        hit += len(got)
        pct = 100.0 * len(got) / len(stmts) if stmts else 100.0
        per_file[str(path.relative_to(REPO))] = round(pct, 1)
    return (100.0 * hit / total if total else 0.0), per_file


def write_badge(out: Path, pct: float, per_file: dict) -> None:
    out.mkdir(parents=True, exist_ok=True)
    badge = {
        "schemaVersion": 1,
        "label": "coverage",
        "message": f"{pct:.0f}%",
        "color": ("brightgreen" if pct >= 90 else
                  "yellow" if pct >= 75 else "red"),
    }
    (out / "badge.json").write_text(json.dumps(badge, indent=2) + "\n")
    (out / "report.json").write_text(json.dumps(
        {"total_percent": round(pct, 2), "files": per_file}, indent=2)
        + "\n")


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if "wgpu_3dgs_core_tpu_torch" in sys.modules:  # its imports ran unseen
        return subprocess.call([sys.executable, __file__, *argv], cwd=REPO)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("pytest_args", nargs="*")
    args = ap.parse_args(argv)
    # As a script, sys.path starts with this directory, whose module names
    # (coverage, ...) would shadow others: the repo's root takes its place.
    sys.path[0] = str(REPO)

    import pytest

    with LineRecorder(PACKAGE_DIR) as rec:
        rc = int(pytest.main(args.pytest_args or default_pytest_args()))
        rc |= run_examples(args.device)
        rc |= run_doctests()

    pct, per_file = report(rec.executed)
    for rel, file_pct in per_file.items():
        print(f"{rel:64s} {file_pct:5.1f}%")
    print(f"\nTOTAL {pct:.1f}%")
    write_badge(args.out, pct, per_file)
    print(f"badge and report written to {args.out}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
