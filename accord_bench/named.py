"""Load a module of the benchmark by its file, the way ``BENCHMARK.json``
and the configuration name it: a per-layer metric's reader
(``metrics/<name>.py``), a traffic mix's driver (``drivers/<driver>.py``), a
configuration's key distribution (``keys/<dist>.py``).  A later change adds
such a file and the harness finds it without an edit to a file that is
there.  The modules import what they share absolutely (``accord_bench.gen``),
so a file loads the same from any folder."""
from __future__ import annotations

import importlib.util
import sys
from pathlib import Path
from types import ModuleType


def load(path: Path) -> ModuleType:
    """The module in ``path``, loaded once per path."""
    path = Path(path).resolve()
    if not path.is_file():
        raise SystemExit(f"no file {path}: the name has no module of its own")
    name = "accord_bench_named_" + "".join(
        c if c.isalnum() else "_" for c in str(path))
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[name]
            raise
    return sys.modules[name]
