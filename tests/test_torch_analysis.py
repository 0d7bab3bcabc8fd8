"""The port's checkers (driderlint) against the JAX package's.

``dag_rider_tpu_torch/analysis`` is a copy of the reference's checkers with
the scanned package as its one seam (``tests/test_torch_copies.py`` pins
the ASTs). Here:

- every planted-violation test of ``tests/test_analysis.py`` and
  ``tests/test_analysis_v2.py`` that feeds the static checkers runs as it
  is against the reference, with each checker call recorded; each recorded
  call is then replayed through the port's checker on the same sources,
  paths and names renamed to the port's package, and the findings
  (checker, path, line, message, the package name normalised) must be the
  reference's; the flow graphs they build must be the same graph;
- the race harness's recipes (lock-order cycles, self-deadlock, guarded
  fields, serialized methods) run on the port's harness, which tracks the
  port's package only, and one threaded recipe (the prep engine's gauges
  and the ladder's probe thread) runs under it with every lock site it
  sees known to the static lock graph;
- the port's own ``jitpure`` and ``shapes`` (the capture checkers: what a
  CUDA graph captures, where the reference's check ``jax.jit`` bodies)
  flag every planted class in a captured region, pass the clean idioms,
  and find the tree's three capture sites;
- the port's tree is clean: ``run_static`` runs every checker the
  reference runs, keeps nothing and has no stale allow, the allowlist has
  no entry for the package, and the runner exits 0, prints ``clean`` and
  names no checker as unported.

The reference's harness and the port's both patch ``threading.Lock``, so
they are never installed in one process together: the port's fixture takes
the reference's out while it runs (under ``DAGRIDER_RACE=1``).
"""

import ast
import dataclasses
import inspect
import os
import re
import threading
import time

import pytest

import test_analysis as A1
import test_analysis_v2 as A2

from dag_rider_tpu.analysis import (
    core as rcore,
    determinism as rdeterminism,
    events as revents,
    flow as rflow,
    knobs as rknobs,
    ladder as rladder,
    locks as rlocks,
    metricsreg as rmetricsreg,
    oracle as roracle,
    release as rrelease,
)
from dag_rider_tpu_torch.analysis import (
    allowlist as pallowlist,
    core as pcore,
    determinism as pdeterminism,
    events as pevents,
    flow as pflow,
    jitpure as pjitpure,
    knobs as pknobs,
    ladder as pladder,
    locks as plocks,
    metricsreg as pmetricsreg,
    oracle as poracle,
    release as prelease,
    shapes as pshapes,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: reference checker module -> the port's
CHECKERS = {
    rknobs: pknobs, rdeterminism: pdeterminism, roracle: poracle,
    rmetricsreg: pmetricsreg, revents: pevents, rlocks: plocks,
    rrelease: prelease, rladder: pladder,
}

#: the reference's planted tests of jitpure and shapes (checks of jax.jit
#: bodies; the port's own, for CUDA graph captures, are planted below) and
#: of no checker at all (a runtime accessor)
NOT_PLANTED = ("test_jitpure_", "test_shapes_", "test_knob_accessors_reject")


def _planted():
    out = []
    for mod in (A1, A2):
        for name, fn in sorted(vars(mod).items()):
            if not name.startswith("test_") or not callable(fn):
                continue
            if inspect.signature(fn).parameters or name.startswith(NOT_PLANTED):
                continue  # fixtures: the tree, the harness, capsys
            if "clean_on_this_repo" in name:
                continue
            out.append(f"{mod.__name__}::{name}")
    return out


PLANTED = _planted()

_PKG = re.compile(r"\bdag_rider_tpu\b")


def to_port(x, cache):
    """The reference call's argument with the package renamed: source
    triples are re-parsed from renamed text, reference dataclasses become
    the port's, a flow graph is rebuilt from the call's port files."""
    if isinstance(x, str):
        return _PKG.sub("dag_rider_tpu_torch", x)
    if (isinstance(x, tuple) and len(x) == 3 and isinstance(x[0], str)
            and isinstance(x[1], ast.Module)):
        src = to_port(x[2], cache)
        return (to_port(x[0], cache), ast.parse(src), src)
    if isinstance(x, (list, tuple)):
        return type(x)(to_port(v, cache) for v in x)
    if isinstance(x, rflow.FlowGraph):
        return pflow.build(cache["files"])
    if dataclasses.is_dataclass(x) and type(x).__module__.startswith("dag_rider_tpu."):
        pmod = __import__(to_port(type(x).__module__, cache), fromlist=["_"])
        cls = getattr(pmod, type(x).__name__)
        return cls(**{f.name: to_port(getattr(x, f.name), cache)
                      for f in dataclasses.fields(x)})
    return x


def normalise(x):
    """A comparable view of a result, the port's package name mapped back."""
    if isinstance(x, str):
        return x.replace("dag_rider_tpu_torch", "dag_rider_tpu")
    if isinstance(x, (rflow.FlowGraph, pflow.FlowGraph)):
        return normalise((
            sorted(x.functions),
            sorted((c, cs.target, cs.line) for c, sites in x.callsites.items() for cs in sites),
            sorted((q, tuple(ci.bases), tuple(sorted(ci.attr_types.items())))
                   for q, ci in x.classes.items()),
        ))
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,) + tuple(normalise(getattr(x, f.name))
                                           for f in dataclasses.fields(x))
    if isinstance(x, dict):
        return sorted((normalise(k), normalise(v)) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return [normalise(v) for v in x]
    return x


class Recorder:
    """Records the outermost calls a reference test makes into the ported
    checkers (``run``), the flow graph (``build``), ``lock_sites`` and
    ``apply_allowlist``, with their results."""

    def __init__(self):
        self.calls = []
        self.depth = 0
        self._undo = []

    def _wrap(self, owner, attr, port_fn):
        orig = getattr(owner, attr)

        def spy(*args, **kw):
            self.depth += 1
            try:
                out = orig(*args, **kw)
            finally:
                self.depth -= 1
            if self.depth == 0:
                self.calls.append((port_fn, args, kw, out))
            return out

        setattr(owner, attr, spy)
        self._undo.append((owner, attr, orig))

    def __enter__(self):
        for rmod, pmod in CHECKERS.items():
            self._wrap(rmod, "run", pmod.run)
        self._wrap(rflow, "build", pflow.build)
        self._wrap(rlocks, "lock_sites", plocks.lock_sites)
        self._wrap(A1, "apply_allowlist", pcore.apply_allowlist)
        return self

    def __exit__(self, *exc):
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)


@pytest.mark.parametrize("case", PLANTED)
def test_planted_violations_give_the_references_findings(case):
    mod_name, name = case.split("::")
    with Recorder() as rec:
        getattr({"test_analysis": A1, "test_analysis_v2": A2}[mod_name], name)()
    assert rec.calls, f"{case} reached no ported checker"
    for port_fn, args, kw, want in rec.calls:
        cache = {}
        pargs = []
        for a in args:
            pargs.append(to_port(a, cache))
            if not cache and isinstance(a, list):
                cache["files"] = pargs[-1]
        pkw = {k: to_port(v, cache) for k, v in kw.items()}
        got = port_fn(*pargs, **pkw)
        assert normalise(got) == normalise(want), (case, port_fn.__module__)


def test_every_planted_static_case_is_replayed():
    """The list above covers every reference test of the ported static
    checkers: a new planted test there is a new case here."""
    assert len(PLANTED) >= 30
    for prefix in ("test_knobs_", "test_determinism_", "test_oracle_", "test_metrics_",
                   "test_allowlist_", "test_flow_", "test_locks_", "test_release_",
                   "test_ladder_"):
        assert any(c.split("::")[1].startswith(prefix) for c in PLANTED), prefix


# -- the port's tree is clean ---------------------------------------------------


@pytest.fixture(scope="module")
def tree():
    files = pcore.discover(REPO)
    return files, pflow.build(files), pcore.run_static(REPO, files)


def test_port_tree_is_clean(tree):
    """The port's run_static over this repo (the package and chip_smoke.py)
    keeps nothing and has no stale allow; the allowlist never names the
    package and every entry has a reason; the degradation seams the flow
    graph must see are reachable in the port too."""
    files, graph, (kept, _suppressed, unused) = tree
    assert kept == [], "\n".join(str(f) for f in kept)
    assert unused == []
    assert all(a.reason.strip() for a in pallowlist.ALLOWS)
    assert not [a for a in pallowlist.ALLOWS if a.path.startswith("dag_rider_tpu_torch/")]
    roots = sorted({rel for rel, _, _ in files if not rel.startswith("dag_rider_tpu_torch/")})
    assert roots == ["chip_smoke.py"]
    assert any(rel == "dag_rider_tpu_torch/verifier/resilient.py" for rel, _, _ in files)
    p = "dag_rider_tpu_torch.consensus.process.Process."
    assert p + "_drain_buffer_vector" in graph.reachable(p + "_drain_buffer")
    assert p + "_degrade_cert_round" in graph.reachable(p + "_apply_certificate")
    assert pladder.run(files, REPO, graph=graph) == []
    assert len(plocks.lock_sites(files)) >= 10


def test_run_static_leaves_out_only_the_unported_checkers(monkeypatch):
    """Nothing is left out: the port's run_static runs every checker the
    reference's runs, jitpure and shapes (the capture checkers) included,
    in the same order."""
    from dag_rider_tpu.analysis import jitpure, shapes

    def names(core_mod, mods):
        called = []
        for m in mods:
            monkeypatch.setattr(m, "run", lambda *a, _n=m.CHECKER, **k: called.append(_n) or [])
        core_mod.run_static(REPO, files=[])
        return called

    ref = names(rcore, list(CHECKERS) + [jitpure, shapes])
    port = names(pcore, list(CHECKERS.values()) + [pjitpure, pshapes])
    assert port == ref and len(ref) == 10
    assert not hasattr(pcore, "UNPORTED")


def test_runner_exits_zero_prints_clean_and_names_the_unported(capsys):
    """The runner reports the tree clean and names no checker as
    unported."""
    from dag_rider_tpu_torch.analysis.__main__ import main

    assert main(["--root", REPO, "--budget-s", "120"]) == 0
    out = capsys.readouterr().out
    assert "clean: 0 violations" in out
    assert "not ported" not in out and "unported" not in out.lower()
    assert main(["--root", REPO, "--budget-s", "0.000001"]) == 1
    assert "BUDGET" in capsys.readouterr().out


# -- the capture checkers: the port's jitpure and shapes ---------------------------


def _F(rel, src):
    return (rel, ast.parse(src), src)


#: a module whose ``step`` a CUDA graph captures; ``{body}`` is planted into
#: step, ``{capture}`` into the capture block, ``{extra}`` after the class
_CAPTURED = """\
import functools
import os
import random
import time

import numpy as np
import torch

_GRAPHS = {{}}


def helper(t):
    return t


@functools.lru_cache(maxsize=None)
def const(device):
    print("built once")
    return torch.as_tensor(np.ones(3), device=device)


def step(t, mask=None, reps: int = 2):
{body}
    return t


class _Graph:
    def __init__(self, n: int, device: torch.device):
        self.t = torch.zeros(n, device=device)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = step(self.t)
{capture}

{extra}
"""


def _plant(body="    pass", capture="", extra="", rel="dag_rider_tpu_torch/ops/planted.py"):
    src = _CAPTURED.format(body=body, capture=capture, extra=extra)
    return [_F(rel, src)], src


def _lines(src, marker):
    return [i for i, ln in enumerate(src.splitlines(), 1) if marker in ln]


#: (checker, planted line in step, fragment of the finding's message)
_CAPTURE_CASES = [
    (pjitpure, "    print(t)", "print() inside captured step()"),
    (pjitpure, "    v = os.environ.get('HOME')", "os.environ.get() inside captured step()"),
    (pjitpure, "    v = os.environ['HOME']", "os.environ[...] inside captured step()"),
    (pjitpure, "    v = os.getenv('HOME')", "environment read at capture time"),
    (pjitpure, "    open('log.txt')", "file I/O at capture time"),
    (pjitpure, "    time.perf_counter()", "clock read at capture time"),
    (pjitpure, "    time.sleep(0.1)", "sleep at capture time"),
    (pjitpure, "    r = random.random()", "host RNG at capture time"),
    (pjitpure, "    global _GRAPHS", "global statement inside captured step()"),
    (pshapes, "    if t.any():\n        t = t + 1", "Python if on a tensor value"),
    (pshapes, "    while t.sum() > 0:\n        t = t - 1", "Python while on a tensor value"),
    (pshapes, "    assert (t > 0).all()", "assert on a tensor value"),
    (pshapes, "    t = t if t.max() > 0 else -t", "conditional expression on a tensor value"),
    (pshapes, "    ok = bool(t.all())", "bool() of a tensor value"),
    (pshapes, "    n = int(t.sum())", "int() of a tensor value"),
    (pshapes, "    n = t.sum().item()", ".item() of a tensor value"),
    (pshapes, "    rows = t.tolist()", ".tolist() of a tensor value"),
    (pshapes, "    h = t.cpu()", ".cpu() of a tensor value"),
    (pshapes, "    h = np.asarray(t)", "np.asarray() of a tensor value"),
    (pshapes, "    c = torch.tensor([1, 2], device=t.device)", "torch.tensor() — host-to-device"),
    (pshapes, "    c = torch.as_tensor(np.ones(3), device=t.device)", "torch.as_tensor() — host-to"),
    (pshapes, "    c = torch.from_numpy(np.ones(3))", "torch.from_numpy() — host-to-device"),
    (pshapes, "    torch.cuda.synchronize()", "torch.cuda.synchronize() — a device sync"),
]


@pytest.mark.parametrize("checker, line, fragment", _CAPTURE_CASES,
                         ids=[f"{c.CHECKER}-{f.split()[0]}" for c, _, f in _CAPTURE_CASES])
def test_capture_checkers_flag_a_planted_step(checker, line, fragment):
    """Each class in a captured step is flagged at its line, naming the
    capture site; the same module outside ops/ and parallel/ is not."""
    files, src = _plant(body=line)
    got = checker.run(files, REPO)
    at = _lines(src, line.splitlines()[0].strip())[0]
    hits = [f for f in got if fragment in f.message]
    assert [f.line for f in hits] == [at], [str(f) for f in got]
    assert all(f.checker == checker.CHECKER and f.path.endswith("ops/planted.py") for f in got)
    assert "captured at dag_rider_tpu_torch.ops.planted._Graph.__init__:" in hits[0].message
    for rel in ("dag_rider_tpu_torch/consensus/planted.py", "chip_smoke.py"):
        assert checker.run(_plant(body=line, rel=rel)[0], REPO) == []


def test_capture_checkers_follow_calls_and_read_the_capture_block():
    """A helper the captured step calls is captured too (found through the
    flow graph, in another file), and so is the capture block itself."""
    helper = _F("dag_rider_tpu_torch/utils/planted_helper.py",
                "def noisy(t):\n    print(t)\n    return t.item()\n")
    files, src = _plant(body="    t = noisy(t)",
                        capture="            if self.t.any():\n                print('x')")
    files[0] = _F(files[0][0], "from dag_rider_tpu_torch.utils.planted_helper import noisy\n"
                  + files[0][2])
    files.append(helper)
    pure = [str(f) for f in pjitpure.run(files, REPO)]
    shp = [str(f) for f in pshapes.run(files, REPO)]
    assert any("utils/planted_helper.py:2" in f and "captured noisy()" in f for f in pure), pure
    assert any("capture of _Graph.__init__()" in f and "print()" in f for f in pure), pure
    assert any("planted_helper.py:3" in f and ".item()" in f for f in shp), shp
    assert any("Python if on a tensor value" in f and "capture of _Graph.__init__()" in f
               for f in shp), shp


def test_shapes_flags_an_unhashable_graph_store_key():
    extra = ("def lookup(dev, n):\n"
             "    g = _GRAPHS.get([dev, n])\n"
             "    _GRAPHS[{dev: n}] = g\n"
             "    return _GRAPHS[(dev, n)]\n")
    files, src = _plant(extra=extra)
    got = pshapes.run(files, REPO)
    assert sorted(f.line for f in got) == _lines(src, "_GRAPHS.get([") + _lines(src, "_GRAPHS[{")
    assert all("unhashable key into graph store _GRAPHS" in f.message for f in got)


def test_capture_checkers_pass_the_clean_idioms():
    """Shape, dtype and device branches, loops over shapes and host ints,
    ``is None`` tests, torch.where, a memoised constant and an uncaptured
    function that prints: nothing is flagged."""
    body = "\n".join([
        "    if mask is not None:",
        "        t = torch.where(mask, t, -t)",
        "    if t.shape[0] > 4 and t.dim() == 1 and t.dtype == torch.int32:",
        "        t = t[:4]",
        "    if t.device.type != 'cuda':",
        "        t = t + 0",
        "    for i in range(t.shape[0]):",
        "        t = t + i",
        "    while reps > 0:",
        "        reps -= 1",
        "    t = t + const(t.device)",
        "    t = helper(t).clone()",
    ])
    extra = "def host_side(t):\n    print(t.item())\n    return _GRAPHS.get((1, 2))\n"
    files, _ = _plant(body=body, extra=extra)
    assert pjitpure.run(files, REPO) == []
    assert pshapes.run(files, REPO) == []


def test_capture_checkers_find_the_trees_three_capture_sites(tree):
    files, graph, _ = tree
    caps = pjitpure.captures(files, graph)
    assert sorted((c.fi.qname.split(".")[-3:-1], c.fi.rel) for c in caps) == [
        (["bls_g1", "_StepGraph"], "dag_rider_tpu_torch/ops/bls_g1.py"),
        (["bls_pairing", "_WalkGraph"], "dag_rider_tpu_torch/ops/bls_pairing.py"),
        (["windowed", "_StepGraph"], "dag_rider_tpu_torch/ops/windowed.py"),
    ]
    captured = pjitpure.captured_functions(caps, graph)
    ops = "dag_rider_tpu_torch.ops."
    for qn in ("windowed.step", "bls_pairing.walk", "bls_g1.ladder_step", "cuda_group.padd_xx",
               "cuda_group.launch", "field381.mul"):
        assert ops + qn in captured, qn
    # memoised loaders stop the walk: the library build is never captured
    assert ops + "cuda_group.lib" not in captured
    assert "dag_rider_tpu_torch.utils.build._build_all" not in captured
    assert pjitpure.run(files, REPO, graph=graph) == []
    assert pshapes.run(files, REPO, graph=graph) == []


# -- the race harness, on the port's package -------------------------------------


@pytest.fixture
def harness(request):
    """The port's harness installed for one test (auto-guarding when the
    test is parametrised so), the reference's taken out meanwhile."""
    from dag_rider_tpu.analysis import races as ref_races

    ref_was = ref_races.active()
    if ref_was:
        ref_races.uninstall()
    from dag_rider_tpu_torch.analysis import races

    races.install(auto_guard=getattr(request, "param", False))
    try:
        yield races
    finally:
        races.drain_violations()
        races.uninstall()
        if ref_was:
            ref_races.install()


def test_harness_tracks_only_the_port(harness):
    """Lock factories hand tracked locks to the port's modules only: not to
    the reference's, not to the harness's own package."""
    def made_in(mod):
        return eval("threading.Lock()", {"__name__": mod, "threading": threading})

    before = set(harness.SITES)
    assert isinstance(made_in("dag_rider_tpu_torch.planted"), harness.TrackedLock)
    assert set(harness.SITES) - before == {"dag_rider_tpu_torch.planted:1"}
    harness.SITES.discard("dag_rider_tpu_torch.planted:1")  # not a real site
    for mod in ("dag_rider_tpu.verifier.prep", "dag_rider_tpu_torch.analysis.core", "numpy"):
        assert not isinstance(made_in(mod), harness._TrackedBase), mod


@pytest.mark.parametrize("cycle", [2, 3])
def test_lock_order_cycle_detected(harness, cycle):
    g = harness.LockGraph()
    locks = [harness.TrackedLock(g, f"site{i}") for i in range(cycle)]
    for a, b in zip(locks, locks[1:]):
        with a:
            with b:
                pass
    with pytest.raises(harness.RaceViolation, match="cycle"):
        with locks[-1]:
            with locks[0]:
                pass


def test_self_deadlock_raises_reentrant_allowed(harness):
    g = harness.LockGraph()
    lk = harness.TrackedLock(g, "siteL")
    with pytest.raises(harness.RaceViolation, match="re-acquire"):
        with lk:
            lk.acquire()
    assert any("re-acquire" in v for v in harness.drain_violations())
    rl = harness.TrackedRLock(g, "siteR")
    with rl:
        with rl:
            assert rl.held_by_current()
    assert not rl.held_by_current()


def test_guarded_field_write_raises(harness):
    from dag_rider_tpu_torch.core.types import BroadcastMessage
    from dag_rider_tpu_torch.transport.memory import InMemoryTransport

    t = InMemoryTransport()
    harness.guard(t)
    got = []
    t.subscribe(0, got.append)  # under the lock: legal
    with pytest.raises(harness.RaceViolation, match="unguarded write"):
        t._handlers[9] = lambda m: None
    with pytest.raises(harness.RaceViolation, match="unguarded write"):
        t._fanout = []
    t.broadcast(BroadcastMessage(vertex=None, round=0, sender=1))
    t.pump()
    assert len(got) == 1


def test_serialized_method_overlap_raises(harness):
    class SingleOwner:
        def work(self, dwell):
            time.sleep(dwell)
            return "ok"

    obj = SingleOwner()
    harness.guard_serial(obj, ("work",))
    assert obj.work(0.0) == "ok"
    errs, started = [], threading.Event()

    def first():
        started.set()
        obj.work(0.3)

    def second():
        started.wait()
        time.sleep(0.05)
        try:
            obj.work(0.0)
        except harness.RaceViolation as e:
            errs.append(e)

    threads = [threading.Thread(target=first), threading.Thread(target=second)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    assert len(errs) == 1 and "overlap" in str(errs[0])


@pytest.mark.parametrize("harness", [True], indirect=True, ids=["auto_guard"])
def test_prep_gauges_and_ladder_probe_under_the_harness(harness, tree):
    """Threads under the auto-guarding harness: the prep engine's row-block
    pool bumps its gauges under its gauge lock, the ladder's probe thread
    flips its down marks under its lock and promotes the tier; no
    violation is recorded, and every lock site the harness saw is known
    to the static lock graph of the port."""
    from dag_rider_tpu_torch.verifier.base import Verifier, VerifierUnavailableError
    from dag_rider_tpu_torch.verifier.prep import PrepEngine
    from dag_rider_tpu_torch.verifier.resilient import ResilientVerifier

    eng = PrepEngine(workers=2)
    try:
        with pytest.raises(harness.RaceViolation, match="unguarded write"):
            eng.dispatches += 1
        for _ in range(3):
            eng.run_blocks(lambda lo, hi: None, eng.plan(4096))
        assert eng.dispatches == 3 and eng.rows_total == 3 * 4096
    finally:
        eng.close()

    class Flaky(Verifier):
        broken = True

        def ping(self):
            return not self.broken

        def verify_batch(self, vertices):
            if self.broken:
                raise VerifierUnavailableError("tier down")
            return [True] * len(vertices)

    flaky = Flaky()
    ladder = ResilientVerifier([flaky, Flaky()], retries=0, backoff_s=0.001,
                               probe_interval_s=0.02)
    ladder.tiers[1].broken = False
    assert ladder.verify_batch([object()]) == [True] and ladder.tier_health() == [False, True]
    with pytest.raises(harness.RaceViolation, match="unguarded write"):
        ladder._down[0] = False
    flaky.broken = False
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and not ladder.tier_health()[0]:
        time.sleep(0.01)
    assert ladder.tier_health() == [True, True]
    assert [v for v in harness.drain_violations() if "unguarded write" not in v] == []
    sites = set(harness.SITES)
    assert any(s.startswith("dag_rider_tpu_torch.verifier.resilient:") for s in sites)
    assert any(s.startswith("dag_rider_tpu_torch.verifier.prep:") for s in sites)
    files = tree[0]
    assert sites <= set(plocks.lock_sites(files))
