"""The port's carried-over host modules are the reference's code, and no port
module reaches JAX or the reference package.

``cassandra_accord_tpu_torch`` copies the reference's JAX-free control plane
unchanged; only docstrings and comments may differ (a docstring that quoted a
TPU measurement was reworded), plus the few statements ``ADDED`` lists.  So
for every carried module the AST of the port's source, with docstrings and
those statements stripped, must equal the reference's.  Every
module of the port, ``chip_smoke.py`` and the port's tools (``tools_torch/``)
must import neither ``jax`` nor ``cassandra_accord_tpu``.
"""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
REF = ROOT / "cassandra_accord_tpu"
PORT = ROOT / "cassandra_accord_tpu_torch"

# modules the port rewrote (everything else under the port is carried over)
PORTED = {
    "__init__.py", "config.py", "device.py",
    "impl/tpu_resolver.py",
    "observe/device.py", "observe/profiler.py",
    "device_service/__init__.py", "device_service/index.py",
    "device_service/kernel.py", "device_service/service.py",
    "models/__init__.py", "models/conflict_graph.py", "entry.py",
    "parallel/__init__.py", "parallel/mesh.py", "parallel/launch.py",
}


def _rel(p: Path, base: Path) -> str:
    return p.relative_to(base).as_posix()


def _port_modules():
    return sorted(_rel(p, PORT) for p in PORT.rglob("*.py")
                  if "__pycache__" not in p.parts)


CARRIED = [m for m in _port_modules()
           if m not in PORTED and not m.startswith("ops/")]


def _strip_docstrings(tree: ast.AST) -> ast.AST:
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) \
                    and isinstance(body[0].value, ast.Constant) \
                    and isinstance(body[0].value.value, str):
                node.body = body[1:] or [ast.Pass()]
    return tree


# statements the port added to a carried module, each present exactly once:
# the Maelstrom binary warms the device tier on init, because its first
# consult would otherwise outlast the 1-s reply timeout of every txn in flight
ADDED = {"maelstrom/main.py": (
    "from ..impl.tpu_resolver import warm_device_tier",
    "warm_device_tier(node.node.config, node.node.resolver_kind)")}


def _code(path: Path, added=()) -> str:
    tree = _strip_docstrings(ast.parse(path.read_text()))
    want = [ast.dump(ast.parse(s).body[0]) for s in added]
    found = []
    for node in ast.walk(tree):
        for field in ("body", "orelse", "finalbody"):
            block = getattr(node, field, None)
            if isinstance(block, list):
                found += [ast.dump(x) for x in block if ast.dump(x) in want]
                setattr(node, field, [x for x in block
                                      if ast.dump(x) not in want])
    assert sorted(found) == sorted(want), f"{path}: added {found}"
    return ast.dump(tree)


def test_carried_set_is_the_reference_host_plane():
    """Every reference module outside the device plane has a carried copy."""
    device_plane = ("ops/", "models/")
    expect = {_rel(p, REF) for p in REF.rglob("*.py")
              if "__pycache__" not in p.parts} - PORTED
    expect = {m for m in expect if not m.startswith(device_plane)}
    assert expect == set(CARRIED)


@pytest.mark.parametrize("module", CARRIED)
def test_carried_module_is_reference_code(module):
    assert (REF / module).exists(), f"{module} has no reference twin"
    port = _code(PORT / module, ADDED.get(module, ()))
    assert port == _code(REF / module), \
        f"{module} differs from the reference beyond docstrings"


def test_native_source_is_reference_source():
    assert (PORT / "native" / "consult.cpp").read_bytes() == \
        (REF / "native" / "consult.cpp").read_bytes()
    assert (PORT / "native" / ".gitignore").read_bytes() == \
        (REF / "native" / ".gitignore").read_bytes()


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


TOOLS = sorted(f"../tools_torch/{p.name}"
               for p in (ROOT / "tools_torch").glob("*.py"))


@pytest.mark.parametrize("module",
                         _port_modules() + ["../chip_smoke.py"] + TOOLS)
def test_port_module_imports_no_jax_or_reference(module):
    path = (PORT / module).resolve()
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "cassandra_accord_tpu")]
    assert not bad, f"{module} imports {bad}"
