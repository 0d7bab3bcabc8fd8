"""driderlint plumbing: findings, file discovery, allowlist semantics.

A checker is a module with a ``CHECKER`` name and a
``run(files, repo_root) -> List[Finding]`` function, where ``files`` is
the list of ``(relpath, ast_tree, source)`` triples :func:`discover`
produces. Checkers take the parsed file list rather than re-reading the
tree so the planted-violation tests can feed synthetic files through
the exact production code path.

Allowlist semantics (the "zero unexplained entries" rule): every
:class:`Allow` must carry a non-empty reason; an entry that suppresses
nothing is itself a failure (dead allowlist lines are how real
violations sneak back in under an old excuse).
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import List, Optional, Sequence, Set, Tuple

#: (relpath-with-forward-slashes, parsed tree, source text)
SourceFile = Tuple[str, ast.Module, str]


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    checker: str
    path: str
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.checker}] {self.message}"


@dataclasses.dataclass(frozen=True)
class Allow:
    """One allowlisted (suppressed) finding.

    Matches any finding with the same ``checker`` and ``path`` whose
    message contains ``contains``. ``reason`` is mandatory and shown in
    the report — an allowlist entry is a documented triage decision,
    not an off switch.
    """

    checker: str
    path: str
    contains: str
    reason: str


def discover(repo_root: str) -> List[SourceFile]:
    """Every .py file of the package plus the repo-root chip_smoke.py
    (the port's root script, in the place the JAX package's bench.py
    takes), in a deterministic order."""
    files: List[SourceFile] = []
    pkg = os.path.join(repo_root, "dag_rider_tpu_torch")
    for dirpath, dirnames, filenames in os.walk(pkg):
        dirnames.sort()
        if "__pycache__" in dirpath:
            continue
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            full = os.path.join(dirpath, fn)
            rel = os.path.relpath(full, repo_root).replace(os.sep, "/")
            with open(full, "r", encoding="utf-8") as fh:
                src = fh.read()
            files.append((rel, ast.parse(src, filename=rel), src))
    bench = os.path.join(repo_root, "chip_smoke.py")
    if os.path.exists(bench):
        with open(bench, "r", encoding="utf-8") as fh:
            src = fh.read()
        files.append(("chip_smoke.py", ast.parse(src, filename="chip_smoke.py"), src))
    return files


def apply_allowlist(
    findings: Sequence[Finding], allows: Sequence[Allow]
) -> Tuple[List[Finding], List[Finding], List[Allow]]:
    """Split findings into (kept, suppressed) and return the allowlist
    entries that matched nothing (each of which is a failure)."""
    kept: List[Finding] = []
    suppressed: List[Finding] = []
    used: Set[int] = set()
    for f in findings:
        hit = None
        for i, a in enumerate(allows):
            if (
                a.checker == f.checker
                and a.path == f.path
                and a.contains in f.message
            ):
                hit = i
                break
        if hit is None:
            kept.append(f)
        else:
            used.add(hit)
            suppressed.append(f)
    unused = [a for i, a in enumerate(allows) if i not in used]
    return kept, suppressed, unused


def run_static(
    repo_root: str, files: Optional[Sequence[SourceFile]] = None
) -> Tuple[List[Finding], List[Finding], List[Allow]]:
    """Run every static checker over the tree and apply the allowlist.

    Returns (kept, suppressed, unused_allows); a clean tree is
    ``([], suppressed, [])``. ``jitpure`` and ``shapes`` check the port's
    CUDA-graph-captured regions where the reference's check ``jax.jit``
    bodies.
    """
    from dag_rider_tpu_torch.analysis import (
        allowlist,
        determinism,
        events,
        flow,
        jitpure,
        knobs,
        ladder,
        locks,
        metricsreg,
        oracle,
        release,
        shapes,
    )

    if files is None:
        files = discover(repo_root)
    findings: List[Finding] = []
    for checker in (knobs, determinism, oracle, jitpure, metricsreg, events):
        findings.extend(checker.run(files, repo_root))
    # v2 interprocedural checkers share ONE flow-graph build (the graph
    # is the expensive half of their runtime)
    graph = flow.build(files)
    for checker in (locks, release, shapes, ladder):
        findings.extend(checker.run(files, repo_root, graph=graph))
    bad_allows = [a for a in allowlist.ALLOWS if not a.reason.strip()]
    kept, suppressed, unused = apply_allowlist(findings, allowlist.ALLOWS)
    for a in bad_allows:
        kept.append(
            Finding(
                "allowlist",
                a.path,
                0,
                f"allowlist entry {a.checker}:{a.contains!r} has no reason",
            )
        )
    return kept, suppressed, unused
