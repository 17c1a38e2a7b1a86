"""What the examples share: the repo's example scenes, the ``--device``
option and an output path that defaults to a temporary directory."""

from __future__ import annotations

import argparse
import contextlib
import tempfile
from pathlib import Path
from typing import Iterator, Optional

# The repo's example scenes (read only).
EXAMPLES_DIR = Path(__file__).resolve().parents[2] / "examples"
MODEL_PLY = EXAMPLES_DIR / "model.ply"
MODEL_SPZ = EXAMPLES_DIR / "model.spz"


def parser(doc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    return p


@contextlib.contextmanager
def output_path(path: Optional[str], name: str) -> Iterator[Path]:
    """``path``, or ``name`` in a temporary directory removed on exit."""
    if path is not None:
        yield Path(path)
        return
    with tempfile.TemporaryDirectory() as tmp:
        yield Path(tmp) / name
