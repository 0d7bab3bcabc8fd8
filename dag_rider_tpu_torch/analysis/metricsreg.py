"""Metrics discipline: every counter bumped must be registered.

``Metrics.counters`` is a defaultdict — a typo'd name silently mints a
new counter that no dashboard, test, or BASELINE row will ever look
at. The rule: any literal counter name passed to ``*.inc("...")`` /
``*._inc("...")`` or indexed as ``*.counters["..."]`` (read or write)
must appear in ``utils.metrics.KNOWN_COUNTERS``. Non-literal names
(merge loops forwarding existing counters) are out of scope.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Sequence

from dag_rider_tpu_torch.analysis.core import Finding, SourceFile
from dag_rider_tpu_torch.utils.metrics import KNOWN_COUNTERS

CHECKER = "metrics"


def _literal(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _counter_name(node: ast.AST) -> Optional[str]:
    """The literal counter name this node bumps/reads, if any."""
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
        if node.func.attr in ("inc", "_inc") and node.args:
            return _literal(node.args[0])
        # counters.get("name") / counters.get("name", 0)
        if (
            node.func.attr == "get"
            and isinstance(node.func.value, ast.Attribute)
            and node.func.value.attr == "counters"
            and node.args
        ):
            return _literal(node.args[0])
    if isinstance(node, ast.Subscript):
        v = node.value
        if isinstance(v, ast.Attribute) and v.attr == "counters":
            return _literal(node.slice)
    return None


def run(files: Sequence[SourceFile], repo_root: str) -> List[Finding]:
    findings: List[Finding] = []
    for rel, tree, _src in files:
        if rel == "dag_rider_tpu_torch/utils/metrics.py":
            continue  # the registry itself
        for node in ast.walk(tree):
            name = _counter_name(node)
            if name is not None and name not in KNOWN_COUNTERS:
                findings.append(
                    Finding(
                        CHECKER,
                        rel,
                        node.lineno,
                        f"counter {name!r} is not registered in "
                        "utils.metrics.KNOWN_COUNTERS",
                    )
                )
    return findings
