"""Capture stability: value hazards in CUDA-graph-captured regions.

The port's counterpart of the reference's ``shapes``. The port has no
``jax.jit``: its device programs that replay are CUDA graphs. A graph
records, once, the kernels its captured region launched, with their
shapes and arguments; every replay re-runs that record on whatever its
static buffers hold and runs none of the region's Python. Three hazard
classes defeat that — the code still runs, the replays answer from a
frozen decision:

* **Python control flow on a tensor's value.** ``if``/``while``/
  ``assert`` or a conditional expression on a tensor (``if t.any():``),
  or ``bool``/``int``/``float`` of one, is decided once, at capture: a
  replay with other data silently takes the captured branch (and reading
  the value syncs the device mid-capture). The decision belongs in
  ``torch.where`` or a masked select.
* **Host round-trips.** ``.item()``/``.tolist()``/``.cpu()``/``.numpy()``
  and ``np.asarray``/``np.array`` of a tensor, ``torch.cuda.synchronize()``
  and host-to-device construction (``torch.tensor``, ``torch.as_tensor``,
  ``torch.from_numpy``): a copy between the host and the card cannot be
  captured, and one made at capture is not made again on replay.
* **Graph-cache keys.** A module-level graph store (a name holding
  ``GRAPH``, such as ``_GRAPHS``) keys its captured graphs by device and
  width; a ``list``/``dict``/``set`` display as the key is a ``TypeError``
  the first time that path runs. Key on a tuple.

The checker is the reference's one-pass abstract interpreter with its
three-point taint lattice, restated as ``TENSOR > SHAPE > STATIC``:
parameters of a captured function start TENSOR (``self`` too: a capture's
buffers are its attributes) unless annotated as a host value (``int``,
``float``, ``bool``, ``str``, ``torch.device``, ``torch.dtype``) or given
a constant default; a variadic parameter starts STATIC (the kernel
launchers pass ctypes values through it). ``x.shape``/``ndim``/``dtype``/
``device`` and ``size()``/``dim()``/``numel()``/``stride()`` of a TENSOR
are SHAPE: branching on them is the intended idiom (the graph stores key
by width) and is not flagged. A method call on a TENSOR is a TENSOR (so
``t.any()`` is one), a ``torch.*`` call is a TENSOR but for the host-side
ones (streams, devices), and everything else propagates the max of its
inputs. ``is``/``is not`` comparisons and ``isinstance`` stay STATIC.

The captured region is ``jitpure``'s: the body of each ``with
torch.cuda.graph(...)`` block in ``ops/`` and ``parallel/`` (interpreted
after the statements of its function that precede it) and every package
function it calls through the flow graph, short of memoised ones.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from dag_rider_tpu_torch.analysis import flow
from dag_rider_tpu_torch.analysis.core import Finding, SourceFile
from dag_rider_tpu_torch.analysis.jitpure import _SCOPES, _local, captured_functions, captures

CHECKER = "shapes"

STATIC, SHAPE, TENSOR = 0, 1, 2

#: attribute reads that turn a tensor into a host-side constant
_SHAPE_ATTRS = frozenset({"shape", "ndim", "dtype", "device", "is_cuda", "layout"})
_SHAPE_METHODS = frozenset({"size", "dim", "numel", "stride", "element_size", "get_device"})

#: calls that force a host round-trip when fed a tensor
_SYNC_CALLS = frozenset({"int", "float", "bool", "complex"})
_SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
_SYNC_NP = frozenset({"np.asarray", "np.array", "numpy.asarray", "numpy.array"})
#: host <-> device copies a capture cannot hold, whatever their arguments
_H2D = frozenset({"torch.tensor", "torch.as_tensor", "torch.from_numpy"})
_SYNC = frozenset({"torch.cuda.synchronize"})
#: torch calls that return host objects, not tensors
_HOST_TORCH = frozenset({
    "torch.device", "torch.Size", "torch.cuda.current_stream", "torch.cuda.Stream",
    "torch.cuda.current_device", "torch.cuda.is_available", "torch.is_tensor",
    "torch.iinfo", "torch.finfo",
})
#: parameter annotations that name host values
_HOST_TYPES = frozenset({"int", "float", "bool", "str", "torch.device", "torch.dtype"})

_UNHASHABLE_DISPLAYS = (ast.List, ast.Dict, ast.Set, ast.ListComp,
                        ast.DictComp, ast.SetComp)


def _param_env(fn: ast.AST) -> Dict[str, int]:
    """The starting taint of a captured function's parameters."""
    a = fn.args
    env: Dict[str, int] = {}
    named = a.posonlyargs + a.args
    defaults = [None] * (len(named) - len(a.defaults)) + list(a.defaults)
    pairs = list(zip(named, defaults)) + list(zip(a.kwonlyargs, a.kw_defaults))
    for p, default in pairs:
        ann = ast.unparse(p.annotation) if p.annotation is not None else None
        host = ann is not None and (
            ann in _HOST_TYPES or any(f"[{t}]" in ann for t in _HOST_TYPES)
        )
        env[p.arg] = STATIC if host or isinstance(default, ast.Constant) else TENSOR
    for p in (a.vararg, a.kwarg):
        if p is not None:
            env[p.arg] = STATIC
    return env


class _Interp:
    """One captured body; findings accumulate in self.out while
    ``active``."""

    def __init__(self, rel: str, where: str, out: List[Finding], mod):
        self.rel = rel
        self.where = where
        self.out = out
        self.mod = mod
        self.active = True

    def flag(self, node: ast.AST, msg: str) -> None:
        if self.active:
            self.out.append(Finding(CHECKER, self.rel, node.lineno, f"{msg} {self.where}"))

    # -- expression taint --------------------------------------------------
    def taint(self, node: ast.AST, env: Dict[str, int]) -> int:
        if node is None or isinstance(node, ast.Constant):
            return STATIC
        if isinstance(node, ast.Name):
            return env.get(node.id, STATIC)
        if isinstance(node, ast.Attribute):
            base = self.taint(node.value, env)
            if node.attr in _SHAPE_ATTRS and base == TENSOR:
                return SHAPE
            return base
        if isinstance(node, ast.Call):
            return self._call_taint(node, env)
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return STATIC
            ts = [self.taint(node.left, env)] + [
                self.taint(c, env) for c in node.comparators
            ]
            return max(ts)
        if isinstance(node, ast.IfExp):
            if self.taint(node.test, env) == TENSOR:
                self.flag(
                    node,
                    "Python conditional expression on a tensor value — decided once, "
                    "at capture (use torch.where)",
                )
            return max(self.taint(node.body, env), self.taint(node.orelse, env))
        if isinstance(node, ast.Lambda):
            return STATIC
        kids = [
            self.taint(c, env)
            for c in ast.iter_child_nodes(node)
            if not isinstance(c, (ast.operator, ast.cmpop, ast.boolop,
                                  ast.unaryop, ast.expr_context))
        ]
        return max(kids, default=STATIC)

    def _call_taint(self, node: ast.Call, env: Dict[str, int]) -> int:
        d = flow.dotted(node.func)
        full = self.mod.expand(d) if d is not None else None
        args = max(
            [self.taint(a, env) for a in node.args]
            + [self.taint(kw.value, env) for kw in node.keywords],
            default=STATIC,
        )
        if d in ("isinstance", "getattr", "hasattr", "callable", "type"):
            return STATIC
        if d == "len":
            return SHAPE if args == TENSOR else args
        if d in _SYNC_CALLS and args == TENSOR:
            self.flag(node, f"{d}() of a tensor value — a host round-trip, decided at capture")
            return STATIC
        if (d in _SYNC_NP or full in _SYNC_NP) and args == TENSOR:
            self.flag(node, f"{d}() of a tensor value — host materialization")
            return STATIC
        if full in _SYNC:
            self.flag(node, f"{d}() — a device sync cannot be captured")
            return STATIC
        if full in _H2D:
            self.flag(
                node,
                f"{d}() — host-to-device construction; the copy cannot be captured "
                "(make the tensor on the device before the capture)",
            )
            return TENSOR
        if isinstance(node.func, ast.Attribute):
            recv = self.taint(node.func.value, env)
            if recv == TENSOR:
                if node.func.attr in _SYNC_METHODS:
                    self.flag(
                        node,
                        f".{node.func.attr}() of a tensor value — host round-trip",
                    )
                    return STATIC
                if node.func.attr in _SHAPE_METHODS:
                    return SHAPE
                return TENSOR
        if full is not None and full.partition(".")[0] == "torch":
            return STATIC if full in _HOST_TORCH else TENSOR
        return args

    # -- statement walk ----------------------------------------------------
    def run_body(self, body: Sequence[ast.stmt], env: Dict[str, int]) -> None:
        # two passes: loop-carried taint stabilizes on the second
        for _ in range(2):
            for stmt in body:
                self.stmt(stmt, env)

    def _bind(self, tgt: ast.AST, t: int, env: Dict[str, int]) -> None:
        if isinstance(tgt, ast.Name):
            env[tgt.id] = t
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            for el in tgt.elts:
                self._bind(el, t, env)
        elif isinstance(tgt, ast.Starred):
            self._bind(tgt.value, t, env)

    def stmt(self, node: ast.stmt, env: Dict[str, int]) -> None:
        if isinstance(node, ast.Assign):
            t = self.taint(node.value, env)
            for tgt in node.targets:
                self._bind(tgt, t, env)
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            self._bind(node.target, self.taint(node.value, env), env)
        elif isinstance(node, ast.AugAssign):
            t = self.taint(node.value, env)
            if isinstance(node.target, ast.Name):
                env[node.target.id] = max(env.get(node.target.id, STATIC), t)
        elif isinstance(node, (ast.If, ast.While)):
            if self.taint(node.test, env) == TENSOR:
                kind = "if" if isinstance(node, ast.If) else "while"
                self.flag(
                    node,
                    f"Python {kind} on a tensor value — decided once, at capture; a "
                    "replay with other data takes the captured branch (use torch.where)",
                )
            self.run_body(node.body, env)
            self.run_body(node.orelse, env)
        elif isinstance(node, ast.For):
            self._bind(node.target, self.taint(node.iter, env), env)
            self.run_body(node.body, env)
            self.run_body(node.orelse, env)
        elif isinstance(node, ast.Assert):
            if self.taint(node.test, env) == TENSOR:
                self.flag(node, "assert on a tensor value — decided once, at capture")
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                self.taint(item.context_expr, env)
            self.run_body(node.body, env)
        elif isinstance(node, ast.Try):
            self.run_body(node.body, env)
            for h in node.handlers:
                self.run_body(h.body, env)
            self.run_body(node.orelse, env)
            self.run_body(node.finalbody, env)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            inner = dict(env)
            inner.update(_param_env(node))
            self.run_body(node.body, inner)
        elif isinstance(node, (ast.Return, ast.Expr)):
            if node.value is not None:
                self.taint(node.value, env)


def _check_capture(cap, graph: flow.FlowGraph, out: List[Finding]) -> None:
    """The ``with`` body, after the statements of its function that
    precede it (interpreted silently for their bindings)."""
    fn = cap.fi.node
    interp = _Interp(cap.fi.rel, f"in the CUDA graph capture of {_local(cap.fi)}()", out,
                     graph.modules[cap.fi.module])
    env = _param_env(fn)
    interp.active = False
    for stmt in fn.body:
        if any(n is cap.node for n in ast.walk(stmt)):
            break
        interp.stmt(stmt, env)
    interp.active = True
    interp.run_body(cap.node.body, env)


def _check_function(fi: flow.FuncInfo, site: str, graph: flow.FlowGraph,
                    out: List[Finding]) -> None:
    interp = _Interp(fi.rel, f"in captured {_local(fi)}() (captured at {site})", out,
                     graph.modules[fi.module])
    interp.run_body(fi.node.body, _param_env(fi.node))


def _graph_stores(tree: ast.Module) -> Set[str]:
    """Module-level names of graph stores (a name holding ``GRAPH``)."""
    names: Set[str] = set()
    for st in tree.body:
        targets = st.targets if isinstance(st, ast.Assign) else (
            [st.target] if isinstance(st, ast.AnnAssign) else [])
        names.update(t.id for t in targets if isinstance(t, ast.Name) and "GRAPH" in t.id)
    return names


def _check_graph_keys(rel: str, tree: ast.Module, out: List[Finding]) -> None:
    stores = _graph_stores(tree)
    if not stores:
        return
    for node in ast.walk(tree):
        key = name = None
        if isinstance(node, ast.Subscript) and isinstance(node.value, ast.Name):
            name, key = node.value.id, node.slice
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
              and node.func.attr in ("get", "setdefault", "pop")
              and isinstance(node.func.value, ast.Name) and node.args):
            name, key = node.func.value.id, node.args[0]
        if name in stores and isinstance(key, _UNHASHABLE_DISPLAYS):
            out.append(
                Finding(
                    CHECKER, rel, key.lineno,
                    f"unhashable key into graph store {name} — a list/dict/set display "
                    "is a TypeError the first time this path runs (key on a tuple)",
                )
            )


def run(
    files: Sequence[SourceFile],
    repo_root: str,
    graph: Optional[flow.FlowGraph] = None,
) -> List[Finding]:
    if graph is None:
        graph = flow.build(files)
    out: List[Finding] = []
    caps = captures(files, graph)
    for cap in caps:
        _check_capture(cap, graph, out)
    for qn, site in captured_functions(caps, graph).items():
        _check_function(graph.functions[qn], site, graph, out)
    for rel, tree, _src in files:
        if rel.startswith(_SCOPES):
            _check_graph_keys(rel, tree, out)
    # stable order, dedup the two-pass loop artifacts
    seen: Set[Tuple[str, int, str]] = set()
    uniq: List[Finding] = []
    for f in out:
        key = (f.path, f.line, f.message)
        if key not in seen:
            seen.add(key)
            uniq.append(f)
    return uniq
