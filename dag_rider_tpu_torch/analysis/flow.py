"""Interprocedural dataflow core for driderlint's interprocedural checkers.

One shared pass over the discovered file list builds:

- a **function index** — every module-level function and every method,
  keyed by qualified name (``module.func`` / ``module.Class.method``);
- a **call graph** — per function, the resolved call sites (AST node,
  target qname, line), resolved through the module's import aliases,
  ``self``-method dispatch (including package base classes), and a
  light constructor-based type inference (``self.attr = ClassName(...)``
  in any method types ``self.attr``; ``x = ClassName(...)`` types the
  local ``x``) — the same def-use information the checkers reuse;
- **def-use chains** — per function, which local names are assigned
  which value expressions, and which names are parameters.

Resolution is deliberately *under*-approximate: a call the index cannot
type produces no edge rather than an edge to every same-named method.
The checkers built on top (``locks``/``ladder``) state invariants of
the form "no cycle over resolved edges" / "a resolved path exists", and
the dynamic race harness cross-validates coverage (the lock-site test
in tests/test_analysis_v2.py fails if a dynamically exercised lock is
invisible to this graph), so imprecision surfaces as a test failure,
not silently.

The pass is pure AST — nothing is imported or executed — so synthetic
planted-violation files flow through the identical code path.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from dag_rider_tpu_torch.analysis.core import SourceFile

__all__ = [
    "FuncInfo",
    "ClassInfo",
    "CallSite",
    "FlowGraph",
    "build",
    "module_name",
    "dotted",
    "local_constructor_types",
    "param_names",
]


def module_name(rel: str) -> str:
    """`dag_rider_tpu_torch/ops/field.py` -> `dag_rider_tpu_torch.ops.field`;
    `bench.py` -> `bench` (matching ``__name__`` at runtime, which is
    how races.py keys dynamic lock sites)."""
    name = rel[:-3] if rel.endswith(".py") else rel
    name = name.replace("/", ".")
    if name.endswith(".__init__"):
        name = name[: -len(".__init__")]
    return name


def dotted(node: ast.AST) -> Optional[str]:
    """`a.b.c` attribute chains as a dotted string, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


@dataclasses.dataclass
class FuncInfo:
    """One function or method in the package."""

    qname: str  # module.func or module.Class.method
    rel: str
    module: str
    cls: Optional[str]  # enclosing class qname (module.Class) or None
    name: str
    node: ast.AST  # FunctionDef | AsyncFunctionDef
    lineno: int


@dataclasses.dataclass
class ClassInfo:
    """One class: methods, resolved package bases, inferred attr types."""

    qname: str  # module.Class
    rel: str
    module: str
    name: str
    node: ast.ClassDef
    bases: List[str] = dataclasses.field(default_factory=list)
    methods: Dict[str, FuncInfo] = dataclasses.field(default_factory=dict)
    #: self.<attr> -> class qname, inferred from `self.attr = Cls(...)`
    attr_types: Dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class CallSite:
    """One resolved call edge, anchored to its AST node."""

    node: ast.Call
    target: str  # callee qname
    line: int


def param_names(fn: ast.AST) -> List[str]:
    """All parameter names of a FunctionDef, positional and keyword."""
    a = fn.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return names


class _ModuleIndex:
    """Per-module name environment: import aliases + top-level defs."""

    def __init__(self, rel: str, tree: ast.Module) -> None:
        self.rel = rel
        self.name = module_name(rel)
        self.is_pkg = rel.endswith("/__init__.py")
        #: local alias -> dotted target ("np" -> "numpy",
        #: "Cfg" -> "dag_rider_tpu_torch.config.Config")
        self.aliases: Dict[str, str] = {}
        self.functions: Dict[str, ast.AST] = {}
        self.classes: Dict[str, ast.ClassDef] = {}
        for node in tree.body:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                self._bind_import(node, override=True)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions[node.name] = node
            elif isinstance(node, ast.ClassDef):
                self.classes[node.name] = node
        # function-local imports fill gaps (bench.py and the lazy seams
        # defer heavy deps into function bodies); top-level bindings win
        top = set(map(id, tree.body))
        for node in ast.walk(tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)) and (
                id(node) not in top
            ):
                self._bind_import(node, override=False)

    def _bind_import(self, node: ast.AST, *, override: bool) -> None:
        def bind(name: str, target: str) -> None:
            if override or name not in self.aliases:
                self.aliases[name] = target

        if isinstance(node, ast.Import):
            for al in node.names:
                bound = al.asname or al.name.split(".")[0]
                target = al.name if al.asname else al.name.split(".")[0]
                bind(bound, target)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                # relative import: a package's own level-1 is itself
                drop = node.level - 1 if self.is_pkg else node.level
                parts = self.name.split(".")
                pkg = ".".join(parts[: len(parts) - drop])
                base = f"{pkg}.{node.module}" if node.module else pkg
            elif node.module is None:
                return
            else:
                base = node.module
            for al in node.names:
                if al.name == "*":
                    continue
                bind(al.asname or al.name, f"{base}.{al.name}")

    def expand(self, name: str) -> str:
        """First-segment alias expansion: `np.random.rand` with
        np->numpy becomes `numpy.random.rand`; local names expand to
        `module.name`."""
        head, _, rest = name.partition(".")
        if head in self.aliases:
            base = self.aliases[head]
        elif head in self.functions or head in self.classes:
            base = f"{self.name}.{head}"
        else:
            return name
        return f"{base}.{rest}" if rest else base


class FlowGraph:
    """The package-wide call graph + def-use index."""

    def __init__(self) -> None:
        self.functions: Dict[str, FuncInfo] = {}
        self.classes: Dict[str, ClassInfo] = {}
        self.modules: Dict[str, _ModuleIndex] = {}
        #: caller qname -> resolved call sites
        self.callsites: Dict[str, List[CallSite]] = {}
        self._reach_memo: Dict[str, Set[str]] = {}

    # -- queries ------------------------------------------------------------

    def callees(self, qname: str) -> Set[str]:
        return {cs.target for cs in self.callsites.get(qname, ())}

    def callers_of(self, qname: str) -> Set[str]:
        out = set()
        for caller, sites in self.callsites.items():
            if any(cs.target == qname for cs in sites):
                out.add(caller)
        return out

    def reachable(self, qname: str) -> Set[str]:
        """Every function transitively callable from ``qname``
        (inclusive). Memoized; safe on recursive graphs."""
        memo = self._reach_memo.get(qname)
        if memo is not None:
            return memo
        seen: Set[str] = set()
        stack = [qname]
        while stack:
            q = stack.pop()
            if q in seen:
                continue
            seen.add(q)
            stack.extend(self.callees(q))
        self._reach_memo[qname] = seen
        return seen

    def method_on(self, cls_qname: str, meth: str) -> Optional[str]:
        """Resolve a method through the (package-local) base chain."""
        seen: Set[str] = set()
        stack = [cls_qname]
        while stack:
            c = stack.pop()
            if c in seen:
                continue
            seen.add(c)
            info = self.classes.get(c)
            if info is None:
                continue
            if meth in info.methods:
                return info.methods[meth].qname
            stack.extend(info.bases)
        return None


def local_constructor_types(
    fn: ast.AST, graph: FlowGraph, mod: "_ModuleIndex"
) -> Dict[str, str]:
    """Def-use slice for receiver typing: local names assigned a direct
    package-class constructor call in this function body."""
    out: Dict[str, str] = {}
    for node in ast.walk(fn):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
            continue
        tgt = node.targets[0]
        if not (isinstance(tgt, ast.Name) and isinstance(node.value, ast.Call)):
            continue
        d = dotted(node.value.func)
        if d is None:
            continue
        expanded = mod.expand(d)
        if expanded in graph.classes:
            out[tgt.id] = expanded
    return out


def _class_attr_types(
    cls_node: ast.ClassDef, graph: FlowGraph, mod: "_ModuleIndex"
) -> Dict[str, str]:
    """`self.attr = ClassName(...)` anywhere in the class's methods."""
    out: Dict[str, str] = {}
    for node in ast.walk(cls_node):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
            continue
        tgt = node.targets[0]
        if not (
            isinstance(tgt, ast.Attribute)
            and isinstance(tgt.value, ast.Name)
            and tgt.value.id == "self"
            and isinstance(node.value, ast.Call)
        ):
            continue
        d = dotted(node.value.func)
        if d is None:
            continue
        expanded = mod.expand(d)
        if expanded in graph.classes:
            out[tgt.attr] = expanded
    return out


def build(files: Sequence[SourceFile]) -> FlowGraph:
    """Two passes: index every function/class, then resolve calls."""
    graph = FlowGraph()

    # pass 1: indexes
    for rel, tree, _src in files:
        mod = _ModuleIndex(rel, tree)
        graph.modules[mod.name] = mod
        for name, fnode in mod.functions.items():
            qn = f"{mod.name}.{name}"
            graph.functions[qn] = FuncInfo(
                qn, rel, mod.name, None, name, fnode, fnode.lineno
            )
        for cname, cnode in mod.classes.items():
            cqn = f"{mod.name}.{cname}"
            cinfo = ClassInfo(cqn, rel, mod.name, cname, cnode)
            for stmt in cnode.body:
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    mqn = f"{cqn}.{stmt.name}"
                    fi = FuncInfo(
                        mqn, rel, mod.name, cqn, stmt.name, stmt, stmt.lineno
                    )
                    graph.functions[mqn] = fi
                    cinfo.methods[stmt.name] = fi
            graph.classes[cqn] = cinfo

    # pass 1.5: bases + attribute types (need the full class index)
    for cqn, cinfo in graph.classes.items():
        mod = graph.modules[cinfo.module]
        for b in cinfo.node.bases:
            d = dotted(b)
            if d is None:
                continue
            expanded = mod.expand(d)
            if expanded in graph.classes:
                cinfo.bases.append(expanded)
        cinfo.attr_types = _class_attr_types(cinfo.node, graph, mod)

    # pass 2: resolve call sites
    for qn, fi in graph.functions.items():
        mod = graph.modules[fi.module]
        local_types = local_constructor_types(fi.node, graph, mod)
        sites: List[CallSite] = []
        for node in ast.walk(fi.node):
            if not isinstance(node, ast.Call):
                continue
            target = _resolve_call(node, fi, graph, mod, local_types)
            if target is not None:
                sites.append(CallSite(node, target, node.lineno))
        graph.callsites[qn] = sites
    return graph


def _constructor_target(graph: FlowGraph, cls_qname: str) -> str:
    """Calling a class resolves to its __init__ when defined (through
    bases), else to the class qname itself (still a graph node for
    existence checks)."""
    init = graph.method_on(cls_qname, "__init__")
    return init if init is not None else cls_qname


def _resolve_call(
    node: ast.Call,
    fi: FuncInfo,
    graph: FlowGraph,
    mod: "_ModuleIndex",
    local_types: Dict[str, str],
) -> Optional[str]:
    d = dotted(node.func)
    if d is None:
        return None
    head, _, rest = d.partition(".")

    # self.meth() / self.attr.meth()
    if head == "self" and fi.cls is not None:
        parts = rest.split(".") if rest else []
        if len(parts) == 1:
            return graph.method_on(fi.cls, parts[0])
        if len(parts) == 2:
            cinfo = graph.classes.get(fi.cls)
            if cinfo is not None:
                # walk the base chain for the attr's inferred type too
                stack, seen = [fi.cls], set()
                while stack:
                    c = stack.pop()
                    if c in seen:
                        continue
                    seen.add(c)
                    ci = graph.classes.get(c)
                    if ci is None:
                        continue
                    owner = ci.attr_types.get(parts[0])
                    if owner is not None:
                        return graph.method_on(owner, parts[1])
                    stack.extend(ci.bases)
        return None

    # localvar.meth() via constructor-typed locals
    if head in local_types:
        if rest and "." not in rest:
            return graph.method_on(local_types[head], rest)
        return None

    # alias/module/global resolution
    expanded = mod.expand(d)
    if expanded in graph.classes:
        return _constructor_target(graph, expanded)
    if expanded in graph.functions:
        return expanded
    # Class.method (static/unbound) or module.Class(...) chains
    owner, _, meth = expanded.rpartition(".")
    if owner in graph.classes and meth:
        return graph.method_on(owner, meth)
    return None


def iter_attr_assign_targets(
    fn: ast.AST,
) -> Iterable[Tuple[ast.Assign, ast.Attribute]]:
    """Every single-target attribute assignment in a function body —
    the def-use slice release.py walks for save/restore discipline."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            tgt = node.targets[0]
            if isinstance(tgt, ast.Attribute):
                yield node, tgt
