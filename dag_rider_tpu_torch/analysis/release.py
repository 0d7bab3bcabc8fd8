"""Exception-safe release of claimed resources (driderlint v2).

The five knob-gated fast paths share long-lived objects (the device
verifier, the fault injector, the transports) whose state individual
rungs and tests *borrow*: set ``fixed_bucket`` for one measurement,
arm a fault plan for one chaos window, flip ``pipeline_enabled`` for
one A/B side. A borrow that is not returned on the exception path
leaks (a benchmark rung leaking a sim-sized bucket into a later
merged dispatch is the class); this checker makes the whole class
impossible to reintroduce.

Two rules, both path-sensitive over the AST's try/finally structure:

**R1 — paired calls.** For each registered (acquire, release) method
pair (``arm``/``disarm``, ``install``/``uninstall``,
``subscribe``/``unsubscribe``): when a function calls BOTH on the same
receiver, the release must run on all paths — the acquire must sit in
the body of a ``try`` whose ``finally`` performs the release. A
function that only acquires transfers ownership to its caller and is
not flagged (that is the transports' subscribe idiom: handlers live
for the transport's life).

**R2 — borrowed-attribute save/restore.** :data:`RESTORED_ATTRS` names
the shared-verifier state attributes that rungs borrow. Writing one on
a *shared* receiver (a parameter, an outer-scope name, anything not
constructed in the same function) must happen inside a ``try`` whose
``finally`` writes the same attribute back. Exempt: ``self`` receivers
and ``__init__`` bodies (configuration at construction is ownership,
not a borrow), locally-constructed receivers (the object dies with the
function), and the restore writes themselves. Additionally, the
generic save/restore shape ``prev = obj.attr … obj.attr = prev`` is
checked for ANY attribute: once a function visibly intends to restore,
the mutation must be under the restoring ``finally`` — a mutation
before the ``try`` opens is a leak window (an exception between them
skips the restore).

``with`` context managers are exempt by construction — that is the
fix this checker pushes toward.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from dag_rider_tpu_torch.analysis import flow
from dag_rider_tpu_torch.analysis.core import Finding, SourceFile

CHECKER = "release"

#: (acquire, release) method-name pairs for R1
CALL_PAIRS: Tuple[Tuple[str, str], ...] = (
    ("arm", "disarm"),
    ("install", "uninstall"),
    ("subscribe", "unsubscribe"),
)

#: shared-verifier state attributes rungs borrow (R2)
RESTORED_ATTRS = frozenset(
    {"fixed_bucket", "prep_workers", "pipeline_enabled"}
)


@dataclasses.dataclass
class _Ctx:
    """Where a statement sits relative to enclosing Try nodes."""

    #: innermost-last chain of (Try node, section) — section is one of
    #: "body", "handler", "orelse", "finalbody"
    chain: Tuple[Tuple[ast.Try, str], ...]

    def in_finalbody(self) -> bool:
        return any(sec == "finalbody" for _t, sec in self.chain)

    def covering_tries(self) -> List[ast.Try]:
        """Try nodes whose *body* contains this statement (their
        ``finally`` runs if this statement raises afterwards)."""
        return [t for t, sec in self.chain if sec == "body"]


def _walk_with_ctx(fn: ast.AST):
    """Yield (node, _Ctx) for every node in the function body, tracking
    the try/finally chain. Nested function bodies are skipped (they run
    on their own schedule, not on this function's paths)."""

    def emit(node: ast.AST, chain: Tuple[Tuple[ast.Try, str], ...]):
        yield node, _Ctx(chain)
        if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
        ):
            return  # do not descend into the nested body
        if isinstance(node, ast.Try):
            for part, sec in (
                (node.body, "body"),
                (node.handlers, "handler"),
                (node.orelse, "orelse"),
                (node.finalbody, "finalbody"),
            ):
                for sub in part:
                    yield from emit(sub, chain + ((node, sec),))
        else:
            for child in ast.iter_child_nodes(node):
                yield from emit(child, chain)

    for child in ast.iter_child_nodes(fn):
        yield from emit(child, ())


def _receiver_of_call(node: ast.Call) -> Optional[Tuple[str, str]]:
    """('obj.sub', 'meth') for obj.sub.meth(...), else None."""
    if isinstance(node.func, ast.Attribute):
        recv = flow.dotted(node.func.value)
        if recv is not None:
            return recv, node.func.attr
    return None


def _attr_write(node: ast.AST) -> Optional[Tuple[str, str, ast.AST]]:
    """(receiver, attr, value) for single-target attribute assigns."""
    if isinstance(node, ast.Assign) and len(node.targets) == 1:
        tgt = node.targets[0]
        if isinstance(tgt, ast.Attribute):
            recv = flow.dotted(tgt.value)
            if recv is not None:
                return recv, tgt.attr, node.value
    if isinstance(node, ast.AugAssign) and isinstance(
        node.target, ast.Attribute
    ):
        recv = flow.dotted(node.target.value)
        if recv is not None:
            return recv, node.target.attr, node.value
    return None


def _finalbody_restores(t: ast.Try, recv: str, attr: str) -> bool:
    for stmt in t.finalbody:
        for sub in ast.walk(stmt):
            w = _attr_write(sub)
            if w is not None and w[0] == recv and w[1] == attr:
                return True
    return False


def _finalbody_calls(t: ast.Try, recv: str, meth: str) -> bool:
    for stmt in t.finalbody:
        for sub in ast.walk(stmt):
            if isinstance(sub, ast.Call):
                rc = _receiver_of_call(sub)
                if rc is not None and rc == (recv, meth):
                    return True
    return False


def _check_function(
    fi: flow.FuncInfo,
    graph: flow.FlowGraph,
) -> List[Finding]:
    out: List[Finding] = []
    fn = fi.node
    mod = graph.modules[fi.module]
    local_ctors = flow.local_constructor_types(fn, graph, mod)
    param_set = set(flow.param_names(fn))
    nodes = list(_walk_with_ctx(fn))

    # index: every attribute write + call with its try context
    writes: List[Tuple[str, str, ast.AST, _Ctx, int]] = []
    calls: List[Tuple[str, str, _Ctx, int]] = []
    #: saved-name -> (receiver, attr): prev = obj.attr
    saves: Dict[str, Tuple[str, str]] = {}
    for node, ctx in nodes:
        w = _attr_write(node)
        if w is not None:
            writes.append((w[0], w[1], w[2], ctx, node.lineno))
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and isinstance(node.value, ast.Attribute)
        ):
            recv = flow.dotted(node.value.value)
            if recv is not None:
                saves[node.targets[0].id] = (recv, node.value.attr)
        if isinstance(node, ast.Call):
            rc = _receiver_of_call(node)
            if rc is not None:
                calls.append((rc[0], rc[1], ctx, node.lineno))

    def is_restore(recv: str, attr: str, value: ast.AST, ctx: _Ctx) -> bool:
        if ctx.in_finalbody():
            return True
        if isinstance(value, ast.Name):
            return saves.get(value.id) == (recv, attr)
        return False

    def covered(recv: str, attr: str, ctx: _Ctx) -> bool:
        return any(
            _finalbody_restores(t, recv, attr)
            for t in ctx.covering_tries()
        )

    # -- R2a: registered borrowed attributes on shared receivers ----------
    for recv, attr, value, ctx, line in writes:
        if attr not in RESTORED_ATTRS:
            continue
        head = recv.partition(".")[0]
        if head == "self" or fi.name == "__init__":
            continue
        if head in local_ctors and head not in param_set:
            continue  # object constructed (and dying) here
        if is_restore(recv, attr, value, ctx):
            continue
        if covered(recv, attr, ctx):
            continue
        out.append(
            Finding(
                CHECKER,
                fi.rel,
                line,
                f"{recv}.{attr} mutated on a shared object without a "
                "finally-restore on the exception path — borrow it "
                "under try/finally (ADVICE r5 #3 class)",
            )
        )

    # -- R2b: generic save/restore shapes for any attribute ---------------
    restored_pairs: Set[Tuple[str, str]] = set()
    for recv, attr, value, ctx, _line in writes:
        if (
            isinstance(value, ast.Name)
            and saves.get(value.id) == (recv, attr)
        ):
            restored_pairs.add((recv, attr))
    for recv, attr in sorted(restored_pairs):
        for w_recv, w_attr, value, ctx, line in writes:
            if (w_recv, w_attr) != (recv, attr):
                continue
            if is_restore(recv, attr, value, ctx):
                continue
            if not covered(recv, attr, ctx):
                out.append(
                    Finding(
                        CHECKER,
                        fi.rel,
                        line,
                        f"{recv}.{attr} is saved and restored in this "
                        "function, but this mutation is outside the "
                        "try whose finally restores it — an exception "
                        "here leaks the borrowed state",
                    )
                )

    # -- R1: paired calls --------------------------------------------------
    for acq_name, rel_name in CALL_PAIRS:
        acq_sites = [
            (recv, ctx, line)
            for recv, meth, ctx, line in calls
            if meth == acq_name
        ]
        rel_recvs = {
            recv for recv, meth, _ctx, _line in calls if meth == rel_name
        }
        for recv, ctx, line in acq_sites:
            if recv not in rel_recvs:
                continue  # ownership transfer: no release here at all
            ok = any(
                _finalbody_calls(t, recv, rel_name)
                for t in ctx.covering_tries()
            )
            if not ok:
                out.append(
                    Finding(
                        CHECKER,
                        fi.rel,
                        line,
                        f"{recv}.{acq_name}() is released by "
                        f"{recv}.{rel_name}() in this function, but not "
                        "in a finally covering the acquire — an "
                        "exception path skips the release",
                    )
                )
    return out


def run(
    files: Sequence[SourceFile],
    repo_root: str,
    graph: Optional[flow.FlowGraph] = None,
) -> List[Finding]:
    if graph is None:
        graph = flow.build(files)
    findings: List[Finding] = []
    seen: Set[Tuple[str, int, str]] = set()
    for qn, fi in graph.functions.items():
        if fi.rel.startswith("dag_rider_tpu_torch/analysis/"):
            continue
        scopes = [fi]
        # nested defs (bench rung helpers) are their own borrow scopes
        for node in ast.walk(fi.node):
            if (
                isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                and node is not fi.node
            ):
                scopes.append(
                    flow.FuncInfo(
                        f"{qn}.{node.name}",
                        fi.rel,
                        fi.module,
                        None,
                        node.name,
                        node,
                        node.lineno,
                    )
                )
        for scope in scopes:
            for f in _check_function(scope, graph):
                key = (f.path, f.line, f.message)
                if key not in seen:
                    seen.add(key)
                    findings.append(f)
    return findings
