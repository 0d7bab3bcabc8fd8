"""Static lock-order proofs over the interprocedural flow graph.

The dynamic race harness (``races.py``) proves "no lock-order cycle was
*observed*" on the interleavings the chaos suites happen to drive. This
checker upgrades that to "no cycle is *possible* over resolved call
paths": it extracts every ``threading.Lock()``/``RLock()`` creation
site in the package (keyed ``module:line``, the exact key the dynamic
harness uses, so the two views cross-validate), every ``with <lock>:``
acquisition, and builds the static acquisition-order graph — lock A
precedes lock B when a ``with A:`` body acquires B directly (nested
``with``) or calls a function from whose resolved call closure some
function acquires B. A cycle in that graph is a deadlock that merely
needs the right interleaving; it fails the tree today, not the night
the scheduler finds it.

Like the dynamic graph, same-site edges are skipped (two instances of
one class nest intentionally and carry no fixed order) — except the
statically-certain degenerate case: a nested ``with`` on the *same*
non-reentrant lock expression, which is a guaranteed self-deadlock.

Exported for the cross-validation test: :func:`lock_sites` (static
creation-site registry) and :func:`build_lock_graph` (sites + edges).
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from dag_rider_tpu_torch.analysis import flow
from dag_rider_tpu_torch.analysis.core import Finding, SourceFile

CHECKER = "locks"

#: analysis/ is excluded exactly as the dynamic factories exclude it
#: (the harness's own bookkeeping locks must not rank in the graph)
_EXCLUDED_PREFIX = "dag_rider_tpu_torch/analysis/"

_LOCK_CTORS = {"threading.Lock": False, "threading.RLock": True}


@dataclasses.dataclass(frozen=True)
class LockDecl:
    """One lock creation site."""

    site: str  # module:line — the dynamic harness's key
    rel: str
    line: int
    reentrant: bool
    #: (owner, attr): owner is a class qname for `self.attr = Lock()`,
    #: the module name for module-level `NAME = Lock()`, else None
    owner: Optional[str]
    attr: Optional[str]


def _creation_sites(
    files: Sequence[SourceFile], graph: flow.FlowGraph
) -> List[LockDecl]:
    out: List[LockDecl] = []
    for rel, tree, _src in files:
        if rel.startswith(_EXCLUDED_PREFIX) or not rel.startswith(
            "dag_rider_tpu_torch/"
        ):
            continue
        mod = graph.modules[flow.module_name(rel)]
        cls_stack: List[Tuple[ast.ClassDef, str]] = []

        def visit(node: ast.AST, cls_qn: Optional[str]) -> None:
            for child in ast.iter_child_nodes(node):
                child_cls = cls_qn
                if isinstance(child, ast.ClassDef):
                    child_cls = f"{mod.name}.{child.name}"
                if isinstance(child, ast.Assign) and isinstance(
                    child.value, ast.Call
                ):
                    d = flow.dotted(child.value.func)
                    expanded = mod.expand(d) if d else None
                    if expanded in _LOCK_CTORS:
                        owner = attr = None
                        if len(child.targets) == 1:
                            tgt = child.targets[0]
                            if (
                                isinstance(tgt, ast.Attribute)
                                and isinstance(tgt.value, ast.Name)
                                and tgt.value.id == "self"
                                and cls_qn is not None
                            ):
                                owner, attr = cls_qn, tgt.attr
                            elif isinstance(tgt, ast.Name):
                                owner, attr = mod.name, tgt.id
                        out.append(
                            LockDecl(
                                f"{mod.name}:{child.value.lineno}",
                                rel,
                                child.value.lineno,
                                _LOCK_CTORS[expanded],
                                owner,
                                attr,
                            )
                        )
                visit(child, child_cls)

        visit(tree, None)
        del cls_stack
    return out


class _LockIndex:
    """Resolve a `with <expr>:` context expression to a LockDecl."""

    def __init__(self, decls: Sequence[LockDecl], graph: flow.FlowGraph):
        self.graph = graph
        #: (owner, attr) -> decl
        self.by_owner: Dict[Tuple[str, str], LockDecl] = {
            (d.owner, d.attr): d
            for d in decls
            if d.owner is not None and d.attr is not None
        }

    def _class_lock(self, cls_qn: str, attr: str) -> Optional[LockDecl]:
        """Walk the package base chain for the lock's declaring class."""
        stack, seen = [cls_qn], set()
        while stack:
            c = stack.pop()
            if c in seen:
                continue
            seen.add(c)
            decl = self.by_owner.get((c, attr))
            if decl is not None:
                return decl
            info = self.graph.classes.get(c)
            if info is not None:
                stack.extend(info.bases)
        return None

    def resolve(
        self, expr: ast.AST, fi: flow.FuncInfo
    ) -> Optional[LockDecl]:
        d = flow.dotted(expr)
        if d is None:
            return None
        head, _, rest = d.partition(".")
        if head == "self" and fi.cls is not None and rest and "." not in rest:
            return self._class_lock(fi.cls, rest)
        if "." not in d:
            return self.by_owner.get((fi.module, d))
        # self.attr._lock — type the attr through the flow graph
        if head == "self" and fi.cls is not None:
            parts = rest.split(".")
            if len(parts) == 2:
                info = self.graph.classes.get(fi.cls)
                if info is not None:
                    owner = info.attr_types.get(parts[0])
                    if owner is not None:
                        return self._class_lock(owner, parts[1])
        return None


def build_lock_graph(
    files: Sequence[SourceFile], graph: Optional[flow.FlowGraph] = None
) -> Tuple[
    List[LockDecl],
    Dict[str, Set[str]],
    List[Finding],
]:
    """(creation sites, order edges site->sites, structural findings).

    Structural findings cover the statically-certain violations found
    while building: nested ``with`` on the same non-reentrant lock.
    """
    if graph is None:
        graph = flow.build(files)
    decls = _creation_sites(files, graph)
    index = _LockIndex(decls, graph)
    findings: List[Finding] = []

    # direct acquisitions per function
    direct: Dict[str, List[Tuple[ast.With, LockDecl]]] = {}
    for qn, fi in graph.functions.items():
        if fi.rel.startswith(_EXCLUDED_PREFIX) or not fi.rel.startswith(
            "dag_rider_tpu_torch/"
        ):
            continue
        acqs: List[Tuple[ast.With, LockDecl]] = []
        for node in ast.walk(fi.node):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    decl = index.resolve(item.context_expr, fi)
                    if decl is not None:
                        acqs.append((node, decl))
        if acqs:
            direct[qn] = acqs

    # closure: every lock any function in reachable(g) directly takes
    def closure_locks(qn: str) -> Set[str]:
        out: Set[str] = set()
        for h in graph.reachable(qn):
            for _w, decl in direct.get(h, ()):
                out.add(decl.site)
        return out

    # call-site lookup by AST node identity, per function
    edges: Dict[str, Set[str]] = {}

    def add_edge(a: str, b: str) -> None:
        if a != b:
            edges.setdefault(a, set()).add(b)

    for qn, acqs in direct.items():
        fi = graph.functions[qn]
        sites_by_node = {
            id(cs.node): cs.target for cs in graph.callsites.get(qn, ())
        }
        for wnode, decl in acqs:
            for inner in ast.walk(wnode):
                if inner is wnode:
                    continue
                if isinstance(inner, (ast.With, ast.AsyncWith)):
                    for item in inner.items:
                        idecl = index.resolve(item.context_expr, fi)
                        if idecl is None:
                            continue
                        if idecl.site == decl.site and not decl.reentrant:
                            findings.append(
                                Finding(
                                    CHECKER,
                                    fi.rel,
                                    inner.lineno,
                                    f"nested with on non-reentrant lock "
                                    f"{decl.site} inside its own critical "
                                    "section — guaranteed self-deadlock",
                                )
                            )
                        add_edge(decl.site, idecl.site)
                elif isinstance(inner, ast.Call):
                    target = sites_by_node.get(id(inner))
                    if target is None:
                        continue
                    for b in closure_locks(target):
                        add_edge(decl.site, b)
    return decls, edges, findings


def _find_cycle(edges: Dict[str, Set[str]]) -> Optional[List[str]]:
    """First cycle in the order graph (as a closed site path), or None."""
    WHITE, GRAY, BLACK = 0, 1, 2
    color: Dict[str, int] = {}
    path: List[str] = []

    def dfs(u: str) -> Optional[List[str]]:
        color[u] = GRAY
        path.append(u)
        for v in sorted(edges.get(u, ())):
            c = color.get(v, WHITE)
            if c == GRAY:
                i = path.index(v)
                return path[i:] + [v]
            if c == WHITE:
                got = dfs(v)
                if got is not None:
                    return got
        path.pop()
        color[u] = BLACK
        return None

    for node in sorted(edges):
        if color.get(node, WHITE) == WHITE:
            got = dfs(node)
            if got is not None:
                return got
    return None


def lock_sites(files: Sequence[SourceFile]) -> Dict[str, LockDecl]:
    """site-key -> decl, for the dynamic/static cross-validation test."""
    graph = flow.build(files)
    return {d.site: d for d in _creation_sites(files, graph)}


def run(
    files: Sequence[SourceFile],
    repo_root: str,
    graph: Optional[flow.FlowGraph] = None,
) -> List[Finding]:
    decls, edges, findings = build_lock_graph(files, graph)
    cycle = _find_cycle(edges)
    while cycle is not None:
        rel = line = None
        by_site = {d.site: d for d in decls}
        head = by_site.get(cycle[0])
        rel = head.rel if head else "dag_rider_tpu_torch"
        line = head.line if head else 0
        findings.append(
            Finding(
                CHECKER,
                rel,
                line,
                "static lock-order cycle (deadlock possible): "
                + " -> ".join(cycle),
            )
        )
        # break the reported cycle and look for independent ones
        edges[cycle[-2]].discard(cycle[-1])
        cycle = _find_cycle(edges)
    return findings
