"""A part of the benchmark found by its name: a metric's reader
(``bench/metrics/<name>.py``) or a database family's generator
(``bench/generators/<name>.py``), so that adding one is adding a file."""

from __future__ import annotations

import importlib.util
from pathlib import Path
from types import ModuleType

BENCH = Path(__file__).resolve().parent


def load(folder: str, name: str) -> ModuleType:
    """``bench/<folder>/<name>.py`` as a module of its own."""
    path = BENCH / folder / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {folder} {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(
        f"bench_{folder}_" + "".join(ch if ch.isalnum() else "_"
                                     for ch in name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
