"""Dynamic lock-race harness (the ``-race`` half of driderlint).

Installed (``DAGRIDER_RACE=1`` under pytest, or ``install()`` directly)
it monkeypatches ``threading.Lock``/``RLock`` so every lock allocated
*by package code* is tracked by creation site, then enforces three
runtime invariants while the existing chaos/fuzz suites drive the
threaded modules:

1. **Lock-order cycles** — acquiring lock B while holding lock A adds
   the edge ``site(A) -> site(B)`` to a global acquisition-order graph;
   an edge that closes a cycle is a deadlock that merely hasn't fired
   yet and raises :class:`RaceViolation` at the acquire *attempt*
   (before blocking — the harness reports the deadlock instead of
   becoming it). Same-thread re-acquire of a non-reentrant lock is the
   degenerate one-node cycle and raises immediately.
2. **Guarded fields** — :data:`GUARDED_FIELDS` declares, per class,
   which shared attributes its lock owns (the discipline the modules'
   comments promise). :func:`guard` swaps the instance's class for a
   checking subclass (rebinding outside the lock raises) and wraps the
   attribute's container so mutator methods (``append``/``add``/
   ``pop``/ ``__setitem__``/…) check lock ownership too. Reads are
   deliberately not intercepted: the repo's idiom allows relaxed reads
   (e.g. ``delivered_count``), it is *writes* that corrupt.
3. **Serialized methods** — :data:`SERIAL_METHODS` declares methods
   that are lock-free by single-owner contract (PrepEngine's ring
   discipline, VerifierPipeline's window). Overlapping calls from two
   threads raise; same-thread reentrancy is allowed.

Violations RAISE in the offending thread *and* are recorded in
:data:`VIOLATIONS`, because the offending thread is often a pool
worker whose exception a Future would swallow — the pytest hook in
tests/conftest.py fails the session on any unconsumed record.
"""

from __future__ import annotations

import sys
import threading
from collections import deque
from typing import Callable, Dict, List, Optional, Set, Tuple

__all__ = [
    "RaceViolation",
    "GUARDED_FIELDS",
    "SERIAL_METHODS",
    "VIOLATIONS",
    "install",
    "uninstall",
    "active",
    "guard",
    "guard_serial",
    "drain_violations",
]


class RaceViolation(AssertionError):
    """A thread-discipline invariant was broken (or would deadlock)."""


#: violations recorded by any thread since install()/drain; the
#: conftest session hook fails the run if this is non-empty at exit
VIOLATIONS: List[str] = []

_real_lock = threading.Lock
_real_rlock = threading.RLock

_graph: Optional["LockGraph"] = None
_installed = False


def _record(msg: str) -> RaceViolation:
    VIOLATIONS.append(msg)
    return RaceViolation(msg)


def drain_violations() -> List[str]:
    """Return and clear the recorded violations (planted-violation
    tests consume what they deliberately caused)."""
    out = list(VIOLATIONS)
    VIOLATIONS.clear()
    return out


def active() -> bool:
    return _installed


# -- lock-order graph -------------------------------------------------------


class LockGraph:
    """Acquisition-order edges keyed by lock *creation site* — two
    instances of the same class rank as the same node, so an ordering
    inversion between peers of one class is visible even when no single
    run interleaves the same two instances. Self-edges (site to itself,
    distinct instances) are skipped: sibling instances of one class are
    routinely nested intentionally and carry no fixed order."""

    def __init__(self) -> None:
        self._mu = _real_lock()
        self._edges: Dict[str, set] = {}
        self._local = threading.local()

    def _held(self) -> list:
        h = getattr(self._local, "held", None)
        if h is None:
            h = []
            self._local.held = h
        return h

    def before_acquire(self, lock: "_TrackedBase") -> None:
        """Edge recording + deadlock checks, run BEFORE blocking."""
        held = self._held()
        already = any(l is lock for l in held)
        if already and not lock.reentrant:
            raise _record(
                f"same-thread re-acquire of non-reentrant lock "
                f"{lock.site} — guaranteed deadlock"
            )
        if already:
            return  # RLock re-entry establishes no new ordering
        for h in held:
            if h.site != lock.site:
                self._add_edge(h.site, lock.site)

    def after_acquire(self, lock: "_TrackedBase") -> None:
        self._held().append(lock)

    def on_release(self, lock: "_TrackedBase") -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is lock:
                del held[i]
                return

    def _add_edge(self, a: str, b: str) -> None:
        with self._mu:
            succ = self._edges.setdefault(a, set())
            if b in succ:
                return
            path = self._path(b, a)
            succ.add(b)
            if path is not None:
                cycle = " -> ".join([a] + path)
                raise _record(f"lock-order cycle (deadlock): {cycle}")

    def _path(self, src: str, dst: str) -> Optional[List[str]]:
        """A path src -> ... -> dst through recorded edges, or None.
        Caller holds self._mu."""
        stack = [(src, [src])]
        seen = set()
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            if node in seen:
                continue
            seen.add(node)
            for nxt in self._edges.get(node, ()):
                stack.append((nxt, path + [nxt]))
        return None


# -- tracked locks ----------------------------------------------------------


class _TrackedBase:
    reentrant = False

    def __init__(self, graph: LockGraph, site: str) -> None:
        self._graph = graph
        self.site = site
        self._owner: Optional[int] = None
        self._depth = 0

    def held_by_current(self) -> bool:
        return self._owner == threading.get_ident()


class TrackedLock(_TrackedBase):
    reentrant = False

    def __init__(self, graph: LockGraph, site: str) -> None:
        super().__init__(graph, site)
        self._inner = _real_lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._graph.before_acquire(self)
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._graph.after_acquire(self)
            self._owner = threading.get_ident()
        return ok

    def release(self) -> None:
        self._owner = None
        self._graph.on_release(self)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class TrackedRLock(_TrackedBase):
    reentrant = True

    def __init__(self, graph: LockGraph, site: str) -> None:
        super().__init__(graph, site)
        self._inner = _real_rlock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._graph.before_acquire(self)
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            if self._depth == 0 or self._owner != threading.get_ident():
                self._graph.after_acquire(self)
            self._owner = threading.get_ident()
            self._depth += 1
        return ok

    def release(self) -> None:
        self._depth -= 1
        if self._depth <= 0:
            self._owner = None
            self._graph.on_release(self)
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


def _caller_module(depth: int = 2) -> Tuple[str, int]:
    f = sys._getframe(depth)
    return f.f_globals.get("__name__", ""), f.f_lineno


#: every site the factories handed a tracked lock for, across the whole
#: install() window — the dynamic half of the static/dynamic lock-site
#: cross-validation (tests/test_analysis_v2.py asserts these are a
#: subset of locks.lock_sites()). Never cleared by uninstall(): the
#: test wants the union over every suite that ran under DAGRIDER_RACE.
SITES: Set[str] = set()


def _tracked_lock_factory():
    mod, line = _caller_module()
    if not mod.startswith("dag_rider_tpu_torch") or mod.startswith(
        "dag_rider_tpu_torch.analysis"
    ):
        return _real_lock()
    site = f"{mod}:{line}"
    SITES.add(site)
    return TrackedLock(_graph, site)


def _tracked_rlock_factory():
    mod, line = _caller_module()
    if not mod.startswith("dag_rider_tpu_torch") or mod.startswith(
        "dag_rider_tpu_torch.analysis"
    ):
        return _real_rlock()
    site = f"{mod}:{line}"
    SITES.add(site)
    return TrackedRLock(_graph, site)


# -- guarded fields ---------------------------------------------------------

#: class -> (lock attribute, guarded shared attributes). Declared as
#: dotted names so importing this module stays cheap; resolved lazily
#: by install()/guard().
GUARDED_FIELDS: Dict[str, Tuple[str, Tuple[str, ...]]] = {
    "dag_rider_tpu_torch.verifier.resilient.ResilientVerifier": (
        "_lock",
        ("_down", "_probing"),
    ),
    "dag_rider_tpu_torch.transport.memory.InMemoryTransport": (
        "_lock",
        ("_handlers", "_batch_handlers", "_queue", "_fanout"),
    ),
    "dag_rider_tpu_torch.mempool.Mempool": ("_lock", ("_inflight",)),
    # run_blocks legitimately overlaps itself (caller-thread prep of
    # chunk k+1 concurrent with the seam thread's prep of k+2 into a
    # different ring slot), so the GAUGES are the shared state, not the
    # method.
    "dag_rider_tpu_torch.verifier.prep.PrepEngine": (
        "_gauge_lock",
        (
            "last_blocks",
            "dispatches",
            "dispatches_parallel",
            "rows_total",
            "rows_parallel",
            "serial_retries",
        ),
    ),
}

#: class -> methods serialized by single-owner contract (no lock at
#: all — the contract is "never two threads in here at once")
SERIAL_METHODS: Dict[str, Tuple[str, ...]] = {
    "dag_rider_tpu_torch.verifier.pipeline.VerifierPipeline": (
        "run_coalesced",
        "drain",
    ),
}


def _resolve(dotted: str):
    mod, _, cls = dotted.rpartition(".")
    import importlib

    return getattr(importlib.import_module(mod), cls)


class _FieldGuard:
    """Shared check closure a guarded instance and its wrapped
    containers consult before any mutation."""

    __slots__ = ("obj", "lock_attr", "cls_name", "field")

    def __init__(self, obj, lock_attr: str, cls_name: str, field: str):
        self.obj = obj
        self.lock_attr = lock_attr
        self.cls_name = cls_name
        self.field = field

    def check(self) -> None:
        lock = self.obj.__dict__.get(self.lock_attr)
        if isinstance(lock, _TrackedBase) and lock.held_by_current():
            return
        raise _record(
            f"unguarded write to {self.cls_name}.{self.field} — "
            f"mutation without holding {self.cls_name}.{self.lock_attr}"
        )


def _make_guarded_container(value, fg: _FieldGuard):
    if isinstance(value, deque):
        g = _GuardedDeque(fg, value, maxlen=value.maxlen)
        return g
    if isinstance(value, dict):
        return _GuardedDict(fg, value)
    if isinstance(value, set):
        return _GuardedSet(fg, value)
    if isinstance(value, list):
        return _GuardedList(fg, value)
    return value


def _mutator(name):
    def m(self, *a, **k):
        self._fg.check()
        return getattr(self._base_type, name)(self, *a, **k)

    m.__name__ = name
    return m


def _build_guarded(base, mutators):
    ns = {"_base_type": base}

    def __init__(self, fg, *a, **k):
        object.__setattr__(self, "_fg", fg)
        base.__init__(self, *a, **k)

    ns["__init__"] = __init__
    for name in mutators:
        if hasattr(base, name):
            ns[name] = _mutator(name)
    return type(f"_Guarded{base.__name__.title()}", (base,), ns)


_GuardedList = _build_guarded(
    list,
    (
        "append",
        "extend",
        "insert",
        "pop",
        "remove",
        "clear",
        "sort",
        "reverse",
        "__setitem__",
        "__delitem__",
        "__iadd__",
        "__imul__",
    ),
)
_GuardedDict = _build_guarded(
    dict,
    (
        "__setitem__",
        "__delitem__",
        "pop",
        "popitem",
        "clear",
        "update",
        "setdefault",
        "__ior__",
    ),
)
_GuardedSet = _build_guarded(
    set,
    (
        "add",
        "discard",
        "remove",
        "pop",
        "clear",
        "update",
        "difference_update",
        "intersection_update",
        "symmetric_difference_update",
        "__ior__",
        "__iand__",
        "__isub__",
        "__ixor__",
    ),
)
_GuardedDeque = _build_guarded(
    deque,
    (
        "append",
        "appendleft",
        "extend",
        "extendleft",
        "pop",
        "popleft",
        "remove",
        "clear",
        "rotate",
        "insert",
        "__setitem__",
        "__delitem__",
        "__iadd__",
    ),
)

_guard_subclass_cache: Dict[type, type] = {}


def guard(obj) -> None:
    """Enforce the declared guarded-field discipline on one instance.

    Swaps ``obj.__class__`` for a checking subclass and wraps the
    guarded containers. The instance's lock must be a tracked lock
    (created after :func:`install`); a raw lock is replaced with a
    tracked one — safe while unheld, which construction time is.
    """
    if getattr(type(obj), "_driderlint_guarded", False):
        return  # already guarded (auto-guard + explicit guard compose)
    dotted = f"{type(obj).__module__}.{type(obj).__qualname__}"
    spec = GUARDED_FIELDS.get(dotted)
    if spec is None:
        raise KeyError(f"{dotted} has no GUARDED_FIELDS declaration")
    lock_attr, fields = spec
    lock = getattr(obj, lock_attr)
    if not isinstance(lock, _TrackedBase):
        graph = _graph if _graph is not None else LockGraph()
        cls = (
            TrackedRLock
            if type(lock).__name__ == "RLock"
            else TrackedLock
        )
        object.__setattr__(
            obj, lock_attr, cls(graph, f"{dotted}.{lock_attr}")
        )
    cls_name = type(obj).__name__
    for field in fields:
        fg = _FieldGuard(obj, lock_attr, cls_name, field)
        wrapped = _make_guarded_container(obj.__dict__[field], fg)
        object.__setattr__(obj, field, wrapped)
    base = type(obj)
    sub = _guard_subclass_cache.get(base)
    if sub is None:

        def __setattr__(self, name, value, _fields=fields,
                        _lock_attr=lock_attr, _cls_name=cls_name):
            if name in _fields:
                _FieldGuard(self, _lock_attr, _cls_name, name).check()
                value = _make_guarded_container(
                    value, _FieldGuard(self, _lock_attr, _cls_name, name)
                )
            object.__setattr__(self, name, value)

        sub = type(
            base.__name__,
            (base,),
            {"__setattr__": __setattr__, "_driderlint_guarded": True},
        )
        _guard_subclass_cache[base] = sub
    obj.__class__ = sub


def guard_serial(obj, methods: Optional[Tuple[str, ...]] = None) -> None:
    """Enforce the single-owner contract on one instance: any two
    overlapping calls (across ALL listed methods) from distinct threads
    raise. Same-thread nesting is allowed."""
    if methods is None:
        dotted = f"{type(obj).__module__}.{type(obj).__qualname__}"
        methods = SERIAL_METHODS.get(dotted)
        if methods is None:
            raise KeyError(f"{dotted} has no SERIAL_METHODS declaration")
    mu = _real_lock()
    state = {"owner": None, "depth": 0}
    cls_name = type(obj).__name__

    def _wrap(name: str, bound: Callable) -> Callable:
        def wrapper(*a, **k):
            me = threading.get_ident()
            with mu:
                if state["owner"] is not None and state["owner"] != me:
                    raise _record(
                        f"serialized-method overlap: {cls_name}.{name}()"
                        f" entered by thread {me} while thread "
                        f"{state['owner']} is still inside the "
                        f"single-owner group {methods}"
                    )
                state["owner"] = me
                state["depth"] += 1
            try:
                return bound(*a, **k)
            finally:
                with mu:
                    state["depth"] -= 1
                    if state["depth"] == 0:
                        state["owner"] = None

        wrapper.__name__ = name
        return wrapper

    for name in methods:
        object.__setattr__(obj, name, _wrap(name, getattr(obj, name)))


# -- install / uninstall ----------------------------------------------------

_patched_inits: List[Tuple[type, Callable]] = []


def _auto_guard_classes() -> None:
    """Wrap the declared classes' __init__ so every instance built
    while the harness is active is guarded automatically — this is how
    the chaos/fuzz suites drive the harness with zero per-test code."""
    for dotted in GUARDED_FIELDS:
        cls = _resolve(dotted)
        orig = cls.__init__

        def wrapped(self, *a, _orig=orig, **k):
            _orig(self, *a, **k)
            guard(self)

        cls.__init__ = wrapped
        _patched_inits.append((cls, orig))
    for dotted, methods in SERIAL_METHODS.items():
        cls = _resolve(dotted)
        orig = cls.__init__

        def wrapped_s(self, *a, _orig=orig, _methods=methods, **k):
            _orig(self, *a, **k)
            guard_serial(self, _methods)

        cls.__init__ = wrapped_s
        _patched_inits.append((cls, orig))


def install(auto_guard: bool = True) -> None:
    """Activate the harness: tracked lock factories for package code,
    plus (by default) auto-guarding of the declared classes."""
    global _graph, _installed
    if _installed:
        return
    _graph = LockGraph()
    threading.Lock = _tracked_lock_factory
    threading.RLock = _tracked_rlock_factory
    if auto_guard:
        _auto_guard_classes()
    _installed = True


def uninstall() -> None:
    global _graph, _installed
    if not _installed:
        return
    threading.Lock = _real_lock
    threading.RLock = _real_rlock
    for cls, orig in reversed(_patched_inits):
        cls.__init__ = orig
    _patched_inits.clear()
    _graph = None
    _installed = False
