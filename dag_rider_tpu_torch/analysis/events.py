"""Event discipline: every event emitted must be registered.

``EventLog.event`` accepts any name — a typo'd event silently creates a
record that no trace report, flight-recorder trigger, or chrome export
row will ever join on (the causal chains in ``obs.report`` join on
EXACT event names; a misspelt ``tx_delivr`` just drops the transaction
from every latency percentile). The rule, mirroring the metrics
checker: any literal event name passed to ``*.event("...")`` must
appear in ``utils.slog.KNOWN_EVENTS``. Non-literal names (forwarding
loops) are out of scope.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Sequence

from dag_rider_tpu_torch.analysis.core import Finding, SourceFile
from dag_rider_tpu_torch.utils.slog import KNOWN_EVENTS

CHECKER = "events"


def _literal(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _event_name(node: ast.AST) -> Optional[str]:
    """The literal event name this node emits, if any."""
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
        if node.func.attr == "event" and node.args:
            return _literal(node.args[0])
    return None


def run(files: Sequence[SourceFile], repo_root: str) -> List[Finding]:
    findings: List[Finding] = []
    for rel, tree, _src in files:
        if rel == "dag_rider_tpu_torch/utils/slog.py":
            continue  # the registry itself
        for node in ast.walk(tree):
            name = _event_name(node)
            if name is not None and name not in KNOWN_EVENTS:
                findings.append(
                    Finding(
                        CHECKER,
                        rel,
                        node.lineno,
                        f"event {name!r} is not registered in "
                        "utils.slog.KNOWN_EVENTS",
                    )
                )
    return findings
