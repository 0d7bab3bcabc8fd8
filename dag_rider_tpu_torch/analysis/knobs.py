"""Knob discipline: every DAGRIDER_* env read routes through config.py.

Three rules:

1. No direct ``os.environ`` / ``os.getenv`` read of a ``DAGRIDER_*``
   name outside ``dag_rider_tpu_torch/config.py``. bench.py may read the
   ``DAGRIDER_BENCH_*`` namespace directly (bench-local tuning the
   package never sees) but nothing else.
2. Every ``DAGRIDER_*`` literal passed to a config ``env_*`` accessor
   must be registered in ``config.KNOBS`` (the accessors also enforce
   this at runtime; the static rule catches dead/typo'd reads on paths
   tests never execute).
3. Every registered knob must appear in the README knob table — a knob
   an operator cannot discover is not a knob, it is a trap.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Sequence

from dag_rider_tpu_torch.analysis.core import Finding, SourceFile
from dag_rider_tpu_torch.config import KNOBS

CHECKER = "knobs"

_CONFIG_PATH = "dag_rider_tpu_torch/config.py"
_ACCESSORS = {
    "env_flag",
    "env_str",
    "env_choice",
    "env_int",
    "env_opt_int",
    "env_float",
}


def _literal(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _is_os_environ(node: ast.AST) -> bool:
    """Matches ``os.environ`` (Attribute) or a bare ``environ`` name."""
    if isinstance(node, ast.Attribute) and node.attr == "environ":
        return True
    return isinstance(node, ast.Name) and node.id == "environ"


def _direct_env_read(node: ast.AST) -> Optional[ast.AST]:
    """The name-expression node of a direct env read, if ``node`` is one:
    ``os.environ.get(X, ...)``, ``os.environ[X]``, ``os.getenv(X, ...)``.
    """
    if isinstance(node, ast.Call):
        f = node.func
        if (
            isinstance(f, ast.Attribute)
            and f.attr == "get"
            and _is_os_environ(f.value)
            and node.args
        ):
            return node.args[0]
        if (
            isinstance(f, ast.Attribute)
            and f.attr == "getenv"
            and node.args
        ):
            return node.args[0]
        if isinstance(f, ast.Name) and f.id == "getenv" and node.args:
            return node.args[0]
    if isinstance(node, ast.Subscript) and _is_os_environ(node.value):
        return node.slice
    return None


def run(files: Sequence[SourceFile], repo_root: str) -> List[Finding]:
    findings: List[Finding] = []
    for rel, tree, _src in files:
        in_config = rel == _CONFIG_PATH
        in_bench = rel == "bench.py"
        for node in ast.walk(tree):
            name_node = _direct_env_read(node)
            if name_node is not None and not in_config:
                name = _literal(name_node)
                if name is None or not name.startswith("DAGRIDER_"):
                    continue
                if in_bench and name.startswith("DAGRIDER_BENCH_"):
                    continue
                findings.append(
                    Finding(
                        CHECKER,
                        rel,
                        node.lineno,
                        f"direct environment read of {name} — route it "
                        "through a dag_rider_tpu_torch.config env_* accessor",
                    )
                )
                continue
            # accessor calls naming unregistered knobs
            if isinstance(node, ast.Call):
                f = node.func
                fname = (
                    f.attr
                    if isinstance(f, ast.Attribute)
                    else f.id if isinstance(f, ast.Name) else None
                )
                if fname in _ACCESSORS and node.args:
                    name = _literal(node.args[0])
                    if (
                        name is not None
                        and name.startswith("DAGRIDER_")
                        and name not in KNOBS
                    ):
                        findings.append(
                            Finding(
                                CHECKER,
                                rel,
                                node.lineno,
                                f"{fname}({name!r}) names a knob that is "
                                "not registered in config.KNOBS",
                            )
                        )
    findings.extend(_check_readme(repo_root))
    return findings


def _check_readme(repo_root: str) -> List[Finding]:
    import os

    readme = os.path.join(repo_root, "README.md")
    if not os.path.exists(readme):
        return [Finding(CHECKER, "README.md", 0, "README.md is missing")]
    with open(readme, "r", encoding="utf-8") as fh:
        text = fh.read()
    out = []
    for name in sorted(KNOBS):
        if name not in text:
            out.append(
                Finding(
                    CHECKER,
                    "README.md",
                    0,
                    f"registered knob {name} is not documented in the "
                    "README knob table",
                )
            )
    return out
