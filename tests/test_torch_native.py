"""The port keeps its own copy of the host code it needs.

``hsolve_torch`` builds its native planner library from its own copy of the
planner source, and neither its modules nor ``chip_smoke.py`` import the JAX
package or read a file under ``hsolve/``."""

import ast
import os
import re

import pytest

import hsolve_torch.native as native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "hsolve_torch")
# a "file:line" label of the JAX code a kernel replaces (chip_smoke's
# "replaces" field) names a file; it does not read one
_LABEL = re.compile(r"^hsolve/[\w/]+\.py:\d+$")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PORT):
        out += [os.path.join(d, f) for f in sorted(files) if f.endswith(".py")]
    return sorted(out)


def test_native_source_lies_in_the_port():
    src = os.path.realpath(native._SRC)
    assert src.startswith(os.path.realpath(PORT) + os.sep), src
    assert os.path.isfile(src)
    with open(src, "rb") as f, \
            open(os.path.join(ROOT, "hsolve", "native", "gather.cpp"), "rb") as g:
        assert f.read() == g.read(), "the port's gather.cpp is a verbatim copy"


def test_native_library_builds_from_the_copy():
    if native._load() is False:
        pytest.skip("no C++ compiler on this machine")
    assert os.path.getmtime(native._LIB) >= os.path.getmtime(native._SRC)
    assert os.path.realpath(native._LIB).startswith(
        os.path.realpath(os.path.join(ROOT, "build", "hsolve_torch")))


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_neither_imports_nor_reads_the_jax_package(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            names = []
        for name in names:
            assert name.split(".")[0] not in ("hsolve", "jax", "jaxlib"), \
                f"{path}:{node.lineno} imports {name}"
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            v = node.value
            assert v != "hsolve", \
                f"{path}:{node.lineno}: a path component 'hsolve'"
            assert not v.startswith("hsolve/") or _LABEL.match(v), \
                f"{path}:{node.lineno}: a path into hsolve/: {v!r}"
