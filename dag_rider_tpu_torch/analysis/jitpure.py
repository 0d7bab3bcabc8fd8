"""Capture purity: a CUDA graph's captured region must be side-effect-free
Python.

The port's counterpart of the reference's ``jitpure``. The port has no
``jax.jit``: its traced region is what a CUDA graph captures. A captured
region's Python runs ONCE, at capture; every replay re-launches the
recorded kernels and runs none of it. Any Python side effect inside the
region (print, file I/O, console input, a clock, a sleep, an environment
read, host RNG, a ``global`` rebinding) therefore fires at capture and
never again, whatever the replays do. The rule over ``ops/`` and
``parallel/``: nothing in a captured region may touch the world outside
its buffers.

The captured region is the body of every ``with torch.cuda.graph(...)``
block in ``ops/`` and ``parallel/``, and every package function that body
calls, followed through the call graph of :mod:`flow` (the callees may
live anywhere in the package). A memoised function (``functools.cache``
or ``lru_cache``) is not followed: its body runs once per process and
key whether or not a capture calls it first (the kernel wrappers' library
loader, the limb constants), and a capture that reached it cold would
fail loudly, since a host-to-device copy cannot be captured.

The reference's host-callback entries (``pure_callback``,
``io_callback``, ``jax.debug.callback``) have no torch spelling and are
left out; the rest of its banned list is kept. The region finder here is
shared with ``shapes``.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Sequence, Set

from dag_rider_tpu_torch.analysis import flow
from dag_rider_tpu_torch.analysis.core import Finding, SourceFile

CHECKER = "jitpure"

_SCOPES = ("dag_rider_tpu_torch/ops/", "dag_rider_tpu_torch/parallel/")

#: the context manager whose body a CUDA graph captures
_CAPTURE = "torch.cuda.graph"

_BANNED_CALLS = {
    "print": "print() at capture time",
    "open": "file I/O at capture time",
    "input": "console input at capture time",
    "time.time": "wall clock at capture time",
    "time.monotonic": "clock read at capture time",
    "time.perf_counter": "clock read at capture time",
    "time.sleep": "sleep at capture time",
    "os.getenv": "environment read at capture time",
    "os.environ.get": "environment read at capture time",
}


@dataclasses.dataclass(frozen=True)
class Capture:
    """One ``with torch.cuda.graph(...)`` block: the function holding it
    and the ``with`` node."""

    fi: flow.FuncInfo
    node: ast.With

    @property
    def site(self) -> str:
        return f"{self.fi.qname}:{self.node.lineno}"


def captures(files: Sequence[SourceFile], graph: flow.FlowGraph) -> List[Capture]:
    """Every capture block of the scoped files, in file and line order."""
    out: List[Capture] = []
    for rel, _tree, _src in files:
        if not rel.startswith(_SCOPES):
            continue
        mod = graph.modules[flow.module_name(rel)]
        for fi in sorted(
            (f for f in graph.functions.values() if f.rel == rel), key=lambda f: f.lineno
        ):
            for node in ast.walk(fi.node):
                if not isinstance(node, (ast.With, ast.AsyncWith)):
                    continue
                for item in node.items:
                    expr = item.context_expr
                    d = flow.dotted(expr.func) if isinstance(expr, ast.Call) else None
                    if d is not None and mod.expand(d) == _CAPTURE:
                        out.append(Capture(fi, node))
                        break
    return out


def _local(fi: flow.FuncInfo) -> str:
    """A function's name within its module (``Class.method`` or ``func``)."""
    return fi.qname[len(fi.module) + 1 :]


def memoised(fn: ast.AST) -> bool:
    """True for a ``functools.cache``/``lru_cache`` decorated function."""
    for dec in fn.decorator_list:
        d = flow.dotted(dec.func if isinstance(dec, ast.Call) else dec)
        if d in ("functools.cache", "functools.lru_cache", "cache", "lru_cache"):
            return True
    return False


def captured_functions(
    caps: Sequence[Capture], graph: flow.FlowGraph
) -> Dict[str, str]:
    """Every package function a capture block calls, transitively and
    short of memoised functions -> the site of the first capture (in
    :func:`captures` order) that reaches it."""
    out: Dict[str, str] = {}
    for cap in caps:
        inside: Set[int] = {
            id(n) for st in cap.node.body for n in ast.walk(st) if isinstance(n, ast.Call)
        }
        stack = sorted(
            cs.target for cs in graph.callsites.get(cap.fi.qname, ()) if id(cs.node) in inside
        )
        seen: Set[str] = set()
        while stack:
            qn = stack.pop()
            fi = graph.functions.get(qn)
            if qn in seen or fi is None or memoised(fi.node):
                continue
            seen.add(qn)
            out.setdefault(qn, cap.site)
            stack.extend(sorted(graph.callees(qn)))
    return dict(sorted(out.items()))


def _why(d: str) -> Optional[str]:
    why = _BANNED_CALLS.get(d)
    if why is None and (
        d.startswith("random.")
        or d.startswith("np.random.")
        or d.startswith("numpy.random.")
    ):
        why = "host RNG at capture time"
    return why


def _check_nodes(
    rel: str, nodes: Sequence[ast.AST], where: str, out: List[Finding]
) -> None:
    for top in nodes:
        for node in ast.walk(top):
            if isinstance(node, ast.Global):
                out.append(Finding(CHECKER, rel, node.lineno, f"global statement {where}"))
            if isinstance(node, ast.Call):
                d = flow.dotted(node.func)
                why = _why(d) if d is not None else None
                if why is not None:
                    out.append(Finding(CHECKER, rel, node.lineno, f"{d}() {where} — {why}"))
            if isinstance(node, ast.Subscript) and flow.dotted(node.value) == "os.environ":
                out.append(
                    Finding(
                        CHECKER,
                        rel,
                        node.lineno,
                        f"os.environ[...] {where} — environment read at capture time",
                    )
                )


def run(
    files: Sequence[SourceFile],
    repo_root: str,
    graph: Optional[flow.FlowGraph] = None,
) -> List[Finding]:
    if graph is None:
        graph = flow.build(files)
    findings: List[Finding] = []
    caps = captures(files, graph)
    for cap in caps:
        _check_nodes(
            cap.fi.rel, cap.node.body, f"inside the CUDA graph capture of {_local(cap.fi)}()",
            findings,
        )
    for qn, site in captured_functions(caps, graph).items():
        fi = graph.functions[qn]
        _check_nodes(
            fi.rel, fi.node.body, f"inside captured {_local(fi)}() (captured at {site})", findings
        )
    return findings
