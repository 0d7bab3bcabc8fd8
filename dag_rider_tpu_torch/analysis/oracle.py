"""Oracle purity: fast-path-only code must not mutate reference state.

Every A/B byte-identity gate in this repo (tests/test_pump_vector.py,
tests/test_cert.py) compares a fast path against the scalar per-vertex
reference oracle *in separate runs*. That comparison is only meaningful
if code reachable exclusively under ``pump=vector`` / ``cert=agg``
never mutates the state the scalar path owns — otherwise the oracle
being compared against is already contaminated and "byte-identical"
proves nothing.

Statically enforced shape (over ``consensus/``):

- inside ``if self._vector:`` bodies and the vector-only methods
  (``_drain_buffer_vector``, ``on_val_batch``, ``_process_inbox``),
  no mutation of the scalar pump's admission state
  (``_buffer``, ``_buffered_ids``, ``_blocked_on``);
- inside ``else:`` / ``if not self._vector:`` scalar branches, no
  mutation of the vector pump's state (``_inbox``, ``_buffer_rounds``);
- inside ``if self._cert:`` bodies and the cert-only methods, no
  mutation of the scalar admission state either. (Pushes into
  ``_pending_verify`` are legal there — per-vertex re-verification IS
  the cert path's degradation seam.)

Mutation = direct assignment / augmented assignment / subscript store
to ``self.<attr>``, or calling a mutator method on it. Local aliases
are deliberately out of scope — the repo idiom aliases *device arrays*
(rebuilt functionally), not the host admission dicts this rule guards.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Sequence

from dag_rider_tpu_torch.analysis.core import Finding, SourceFile

CHECKER = "oracle"

#: scalar reference-path admission state (owned by the per-vertex pump)
SCALAR_STATE = frozenset({"_buffer", "_buffered_ids", "_blocked_on"})
#: vector-pump-only state
VECTOR_STATE = frozenset({"_inbox", "_buffer_rounds"})

VECTOR_ONLY_FUNCS = frozenset(
    {"_drain_buffer_vector", "on_val_batch", "_process_inbox"}
)
CERT_ONLY_FUNCS = frozenset(
    {
        "_on_certificate",
        "_cert_step",
        "_apply_certificate",
        "_degrade_cert_round",
        "_cert_tick",
        "_maybe_assemble_certs",
        # cert-of-certs overlay
        "_on_span",
        "_apply_span",
        "_bank_span_cert",
        "_maybe_assemble_spans",
    }
)

_MUTATORS = frozenset(
    {
        "append",
        "appendleft",
        "add",
        "extend",
        "insert",
        "pop",
        "popleft",
        "remove",
        "discard",
        "clear",
        "update",
        "setdefault",
    }
)


def _self_attr(node: ast.AST) -> Optional[str]:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _mutated_attrs(node: ast.AST):
    """Yield (attr, lineno) for every self.<attr> mutation under node
    (node itself included)."""
    for n in ast.walk(node):
        if isinstance(n, (ast.Assign, ast.AugAssign)):
            targets = n.targets if isinstance(n, ast.Assign) else [n.target]
            for t in targets:
                base = t
                while isinstance(base, ast.Subscript):
                    base = base.value
                attr = _self_attr(base)
                if attr is not None:
                    yield attr, n.lineno
        elif isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute):
            if n.func.attr in _MUTATORS:
                attr = _self_attr(n.func.value)
                if attr is not None:
                    yield attr, n.lineno


def _guard_kind(test: ast.AST) -> Optional[str]:
    """'vector' for ``self._vector``, 'not_vector' for
    ``not self._vector``, 'cert' for ``self._cert``, else None."""
    if _self_attr(test) == "_vector":
        return "vector"
    if _self_attr(test) == "_cert":
        return "cert"
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        if _self_attr(test.operand) == "_vector":
            return "not_vector"
    return None


def _check_region(
    rel: str, body: Sequence[ast.stmt], forbidden: frozenset, label: str
) -> List[Finding]:
    out = []
    for stmt in body:
        for attr, line in _mutated_attrs(stmt):
            if attr in forbidden:
                out.append(
                    Finding(
                        CHECKER,
                        rel,
                        line,
                        f"{label} mutates self.{attr} — reference-path "
                        "state the A/B byte-identity gates assume "
                        "untouched",
                    )
                )
    return out


def run(files: Sequence[SourceFile], repo_root: str) -> List[Finding]:
    findings: List[Finding] = []
    for rel, tree, _src in files:
        if not rel.startswith("dag_rider_tpu_torch/consensus/"):
            continue
        for fn in ast.walk(tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if fn.name in VECTOR_ONLY_FUNCS:
                findings.extend(
                    _check_region(
                        rel,
                        fn.body,
                        SCALAR_STATE,
                        f"vector-only method {fn.name}()",
                    )
                )
            if fn.name in CERT_ONLY_FUNCS:
                findings.extend(
                    _check_region(
                        rel,
                        fn.body,
                        SCALAR_STATE,
                        f"cert-only method {fn.name}()",
                    )
                )
            for node in ast.walk(fn):
                if not isinstance(node, ast.If):
                    continue
                kind = _guard_kind(node.test)
                if kind == "vector":
                    findings.extend(
                        _check_region(
                            rel,
                            node.body,
                            SCALAR_STATE,
                            "vector-only branch (if self._vector)",
                        )
                    )
                    findings.extend(
                        _check_region(
                            rel,
                            node.orelse,
                            VECTOR_STATE,
                            "scalar branch (else of if self._vector)",
                        )
                    )
                elif kind == "not_vector":
                    findings.extend(
                        _check_region(
                            rel,
                            node.body,
                            VECTOR_STATE,
                            "scalar branch (if not self._vector)",
                        )
                    )
                elif kind == "cert":
                    findings.extend(
                        _check_region(
                            rel,
                            node.body,
                            SCALAR_STATE,
                            "cert-only branch (if self._cert)",
                        )
                    )
    return findings
