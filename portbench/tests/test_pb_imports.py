"""Nothing under portbench/ imports jax, jaxlib, flax or the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's), and the reference imports nothing of the program either."""

import ast
import os
import sys

import pytest

from portbench import run as run_mod
from portbench.tests.pb_small import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "yolov4_tpu"}
PKG = os.path.join(ROOT, "portbench")


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def _sources(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(_sources(PKG)),
                         ids=lambda p: os.path.relpath(p, PKG))
def test_no_jax_imports(path):
    assert not set(_imports(path)) & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    for path in _sources(os.path.join(PKG, "reference")):
        names = set(_imports(path))
        assert not names & (FORBIDDEN | {"yolov4_tpu_torch"}), path
    for name in ("check", "counts", "weights"):
        names = set(_imports(os.path.join(PKG, f"{name}.py")))
        assert "yolov4_tpu_torch" not in names, name


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "yolov4_tpu_torch_fake", sys)
    assert run_mod.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "flax.core", sys)
    assert run_mod.forbidden_modules() == ["flax"]
