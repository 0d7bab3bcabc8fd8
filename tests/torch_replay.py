"""Replay a JAX-package test module through the port.

``replay("test_node.py", globals())`` reads ``tests/test_node.py``, reads
every ``dag_rider_tpu`` in it as ``dag_rider_tpu_torch``, runs it as a
module of its own (with pytest's assertion rewriting, so a failed assert
reports its operands) and binds its tests and fixtures in the caller's
namespace, where pytest collects them under the caller's file. Each
recipe of the reference module then runs, unchanged, against the port's
modules; the names it returns are the tests it bound. A recipe that
``tests/conftest.py`` files under the long tail (``_SLOW``) keeps that
tier in its replay: it carries the ``slow`` marker, as the reference
test gets it.
"""

import ast
import re
import types
from pathlib import Path

import pytest

from _pytest.assertion.rewrite import rewrite_asserts
from _pytest.fixtures import FixtureFunctionDefinition

TESTS = Path(__file__).resolve().parent
_PACKAGE = re.compile(r"\bdag_rider_tpu\b")


def slow_tests() -> set:
    """``tests/conftest.py``'s ``_SLOW`` registry (``file::test`` names)."""
    tree = ast.parse((TESTS / "conftest.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and [t.id for t in node.targets
                                             if isinstance(t, ast.Name)] == ["_SLOW"]:
            return ast.literal_eval(node.value)
    raise LookupError("tests/conftest.py defines no _SLOW registry")


def ported_source(name: str) -> str:
    """The reference test module's source with the port's package name."""
    return _PACKAGE.sub("dag_rider_tpu_torch", (TESTS / name).read_text())


def replay(name: str, namespace: dict) -> list:
    source = ported_source(name)
    tree = ast.parse(source, filename=name)
    rewrite_asserts(tree, source.encode(), name)
    module = types.ModuleType(f"torch_replay_{Path(name).stem}")
    module.__file__ = str(TESTS / name)
    exec(compile(tree, f"<port replay of tests/{name}>", "exec"), module.__dict__)
    slow = slow_tests()
    bound = []
    for key, value in vars(module).items():
        if isinstance(value, FixtureFunctionDefinition):
            namespace[key] = value
        elif key.startswith("test_") and isinstance(value, types.FunctionType):
            namespace[key] = pytest.mark.slow(value) if f"{name}::{key}" in slow else value
            bound.append(key)
    return bound
