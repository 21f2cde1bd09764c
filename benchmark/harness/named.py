"""Modules of the benchmark found by the names that ``BENCHMARK.json``, a
configuration or a traffic file gives: ``benchmark/<folder>/<name>.py``.

The folders are ``programs`` (the system under test for a configuration's
``program``), ``graphs`` (the reader of a configuration's ``graph``),
``frames`` (the maker of a traffic file's ``frames``) and ``metrics``
(the reader of a per-layer metric).  A later cell or metric adds a file
there; nothing here is edited.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]


def module(folder: str, name: str):
    """The module ``benchmark/<folder>/<name>.py``, loaded once (a name
    may hold ``.`` and ``-``, so it is loaded from its file)."""
    key = f"benchmark.{folder}.{name}"
    path = BENCH / folder / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"no {folder} module {name!r} ({path})")
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]
