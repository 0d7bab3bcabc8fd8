"""Determinism discipline: the consensus stack must be a pure function
of its inputs.

Three rules over the package (bench.py is exempt — measuring wall time
is its job):

1. No ``time.time()`` *calls* anywhere in the package. Monotonic /
   perf-counter clocks are fine (latency measurement), and passing
   ``time.time`` as an injectable default *reference* is the approved
   pattern (transport/net.py) — only an actual call hardwires the wall
   clock. Justified uses (observability timestamps) go on the
   allowlist with a reason.
2. No unseeded RNG: module-level ``random.<fn>()`` calls, zero-arg
   ``random.Random()``, and ``np.random.<fn>()`` (the legacy global
   generator) are all process-global, seed-uncontrolled state.
   ``random.Random(seed)`` / ``np.random.default_rng(seed)`` with an
   explicit seed are fine.
3. No iteration-order dependence on ``consensus/`` commit paths:
   iterating a set expression (or a ``self`` attribute initialized as
   a set) feeds hash-randomized order into code whose outputs must be
   byte-identical across processes. Wrap in ``sorted(...)`` or use a
   list/dict (insertion-ordered).
"""

from __future__ import annotations

import ast
from typing import List, Optional, Sequence, Set

from dag_rider_tpu_torch.analysis.core import Finding, SourceFile

CHECKER = "determinism"

_UNSEEDED_RANDOM_FNS = {
    "random",
    "randint",
    "randrange",
    "uniform",
    "choice",
    "choices",
    "shuffle",
    "sample",
    "getrandbits",
    "gauss",
    "seed",
}


def _dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _set_attrs_of_file(tree: ast.Module) -> Set[str]:
    """self attributes initialized as set()/frozenset()/set literals in
    any __init__ of the file."""
    attrs: Set[str] = set()
    for node in ast.walk(tree):
        if not (isinstance(node, ast.FunctionDef) and node.name == "__init__"):
            continue
        for stmt in ast.walk(node):
            if not isinstance(stmt, ast.Assign):
                continue
            val = stmt.value
            is_set = isinstance(val, (ast.Set, ast.SetComp)) or (
                isinstance(val, ast.Call)
                and isinstance(val.func, ast.Name)
                and val.func.id in ("set", "frozenset")
            )
            if not is_set:
                continue
            for t in stmt.targets:
                if (
                    isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"
                ):
                    attrs.add(t.attr)
    return attrs


def _is_set_expr(node: ast.AST, set_attrs: Set[str]) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Name)
        and node.func.id in ("set", "frozenset")
    ):
        return True
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
        and node.attr in set_attrs
    ):
        return True
    return False


def run(files: Sequence[SourceFile], repo_root: str) -> List[Finding]:
    findings: List[Finding] = []
    for rel, tree, _src in files:
        if rel == "bench.py":
            continue
        in_consensus = rel.startswith("dag_rider_tpu_torch/consensus/")
        set_attrs = _set_attrs_of_file(tree) if in_consensus else set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                dotted = _dotted(node.func)
                if dotted == "time.time":
                    findings.append(
                        Finding(
                            CHECKER,
                            rel,
                            node.lineno,
                            "wall-clock time.time() call — use an "
                            "injectable clock / time.monotonic, or "
                            "allowlist with a reason",
                        )
                    )
                elif dotted is not None:
                    parts = dotted.split(".")
                    if (
                        len(parts) == 2
                        and parts[0] == "random"
                        and parts[1] in _UNSEEDED_RANDOM_FNS
                    ):
                        findings.append(
                            Finding(
                                CHECKER,
                                rel,
                                node.lineno,
                                f"unseeded module-level {dotted}() — use "
                                "a random.Random(seed) instance",
                            )
                        )
                    elif dotted == "random.Random" and not (
                        node.args or node.keywords
                    ):
                        findings.append(
                            Finding(
                                CHECKER,
                                rel,
                                node.lineno,
                                "random.Random() without a seed",
                            )
                        )
                    elif (
                        len(parts) == 3
                        and parts[0] in ("np", "numpy")
                        and parts[1] == "random"
                        and parts[2] != "default_rng"
                    ):
                        findings.append(
                            Finding(
                                CHECKER,
                                rel,
                                node.lineno,
                                f"legacy global-state {dotted}() — use "
                                "np.random.default_rng(seed)",
                            )
                        )
                    elif dotted in (
                        "np.random.default_rng",
                        "numpy.random.default_rng",
                    ) and not (node.args or node.keywords):
                        findings.append(
                            Finding(
                                CHECKER,
                                rel,
                                node.lineno,
                                "np.random.default_rng() without a seed",
                            )
                        )
            if in_consensus:
                iters = []
                if isinstance(node, ast.For):
                    iters.append(node.iter)
                elif isinstance(
                    node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                           ast.DictComp)
                ):
                    iters.extend(g.iter for g in node.generators)
                for it in iters:
                    if _is_set_expr(it, set_attrs):
                        findings.append(
                            Finding(
                                CHECKER,
                                rel,
                                it.lineno,
                                "iteration over a set on a consensus "
                                "path — order is hash-randomized; wrap "
                                "in sorted(...) or use an "
                                "insertion-ordered container",
                            )
                        )
    return findings
