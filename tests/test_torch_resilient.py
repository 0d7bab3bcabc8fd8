"""The port's degradation ladder against the JAX package's.

``verifier/resilient.py`` is a copy (``tests/test_torch_copies.py`` pins its
AST). Here the four recipes of ``tests/test_resilient.py`` that need no
sidecar (retry, fallback and promotion; exhaustion and recovery; the
pipeline's quarantine wired to the next tier; the knobs) run through both
packages' ladders on the same pools: the port's over a flaky tier around
``CUDAVerifier(device="cpu")`` (the card's verifier on its plain torch
path), the reference's over its own recipe's tier. The masks, the gauges
after every step and the ladder's slog events must be equal. Where the
reference's device tier would be its ``TPUVerifier`` (the quarantine
recipe), both ladders stand over the port's ``CUDAVerifier`` on the CPU
inside their own package's ``VerifierPipeline``: an unbounded resolve storm
never reads that tier's verdicts, and the JAX verifier's compile would cost
most of a minute. Then a ``Simulation`` in each package whose first tier
goes down mid-run commits the JAX ``CPUVerifier`` run's log byte for byte.
"""

import time

import pytest

from test_pipeline import N, _signed_pool

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

from dag_rider_tpu.config import Config as JConfig
from dag_rider_tpu.consensus.simulator import Simulation as JSimulation
from dag_rider_tpu.utils import slog as jslog
from dag_rider_tpu.verifier import base as jbase
from dag_rider_tpu.verifier import resilient as jres
from dag_rider_tpu.verifier.cpu import CPUVerifier as JCPUVerifier
from dag_rider_tpu.verifier.pipeline import VerifierPipeline as JVerifierPipeline
from dag_rider_tpu_torch import Config
from dag_rider_tpu_torch.consensus.simulator import Simulation
from dag_rider_tpu_torch.utils import slog
from dag_rider_tpu_torch.verifier import base, resilient
from dag_rider_tpu_torch.verifier.cpu import CPUVerifier
from dag_rider_tpu_torch.verifier.cuda import CUDAVerifier
from dag_rider_tpu_torch.verifier.faults import VerifierFaultInjector, VerifierFaultPlan
from dag_rider_tpu_torch.verifier.pipeline import VerifierPipeline


@pytest.fixture(scope="module")
def keys():
    return jbase.KeyRegistry.generate(N)


@pytest.fixture(scope="module")
def reg(keys):
    return base.KeyRegistry(keys[0].public_keys)


@pytest.fixture(scope="module")
def tables(reg):
    """The 4-bit comb tables, built once and handed to every card tier."""
    return CUDAVerifier(reg, device="cpu").comb_tables()


def card(reg, tables):
    v = CUDAVerifier(reg, device="cpu")
    v._tables = tables
    return v


def flaky_tier(pkg_base, inner):
    """The ``_FlakyTier`` of ``tests/test_resilient.py`` over ``inner``:
    raises the package's ``VerifierUnavailableError`` while ``broken`` and
    answers its ping accordingly."""

    class Flaky(pkg_base.Verifier):
        def __init__(self):
            self.inner = inner
            self.broken = False
            self.calls = 0
            self.probes = 0

        def ping(self) -> bool:
            self.probes += 1
            return not self.broken

        def verify_batch(self, vertices):
            self.calls += 1
            if self.broken:
                raise pkg_base.VerifierUnavailableError("tier down")
            return self.inner.verify_batch(vertices)

    return Flaky()


def events(records):
    return [{k: v for k, v in r.items() if k != "ts"} for r in records]


def gauges(ladder):
    return (ladder.last_tier, ladder.retries_total, ladder.fallbacks_total,
            ladder.exhausted_total, ladder.tier_health())


def wait_promoted(ladder, idx=0):
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and not ladder.tier_health()[idx]:
        time.sleep(0.01)
    assert ladder.tier_health()[idx], "the probe never promoted the tier"


# -- ladder mechanics ---------------------------------------------------------


def _retry_fallback_promote(res_mod, ladder_tiers, flaky, log, pool):
    ladder = res_mod.ResilientVerifier(ladder_tiers, retries=1, backoff_s=0.001,
                                       probe_interval_s=0.02, log=log)
    trace = [(ladder.verify_batch(pool), gauges(ladder), flaky.calls)]
    flaky.broken = True
    trace.append((ladder.verify_batch(pool), gauges(ladder), flaky.calls))
    # while down, calls skip the broken tier entirely
    trace.append((ladder.verify_batch(pool), gauges(ladder), flaky.calls))
    flaky.broken = False
    wait_promoted(ladder)
    assert flaky.probes >= 1
    trace.append((ladder.verify_batch(pool), gauges(ladder), flaky.calls))
    return trace, ladder.resilience_stats()


def test_ladder_retries_falls_back_and_promotes(keys, reg, tables):
    """tests/test_resilient.py:68 in both packages: the same masks, gauges
    after each step, resilience bundle and events."""
    pool = _signed_pool(keys, 24, seed=11)
    want = JCPUVerifier(keys[0]).verify_batch(pool)
    assert not all(want), "no corruption landed"
    out = {}
    for name, res_mod, pkg_base, inner, floor, slog_mod in (
            ("ref", jres, jbase, JCPUVerifier(keys[0]), JCPUVerifier(keys[0]), jslog),
            ("port", resilient, base, card(reg, tables), CPUVerifier(reg), slog)):
        flaky = flaky_tier(pkg_base, inner)
        log, records = slog_mod.capture(clock=lambda: 0.0)
        trace, rs = _retry_fallback_promote(res_mod, [flaky, floor], flaky, log, pool)
        out[name] = (trace, rs, events(records))
    assert out["port"] == out["ref"]
    trace, rs, evs = out["port"]
    assert all(mask == want for mask, _, _ in trace)
    assert [g for _, g, _ in trace] == [
        (0, 0, 0, 0, [True, True]), (1, 1, 1, 0, [False, True]),
        (1, 1, 1, 0, [False, True]), (0, 1, 1, 0, [True, True])]
    assert rs["retries"] == 1 and rs["fallbacks"] == 1 and rs["tier_health"] == [1, 1]
    assert [e["event"] for e in evs] == [
        "verify_retry", "verify_tier_down", "verify_fallback", "verify_tier_recovered"]


def test_ladder_exhaustion_fails_closed_then_recovers(keys, reg, tables):
    """tests/test_resilient.py:111: whole-ladder failure rejects the batch
    (all-False, full length) and verify_rounds keeps the shape; the stale
    down mark does not brick the verifier once the fault clears."""
    pool = _signed_pool(keys, 12, seed=13)
    want = JCPUVerifier(keys[0]).verify_batch(pool)
    out = {}
    for name, res_mod, pkg_base, inner, slog_mod in (
            ("ref", jres, jbase, JCPUVerifier(keys[0]), jslog),
            ("port", resilient, base, card(reg, tables), slog)):
        flaky = flaky_tier(pkg_base, inner)
        flaky.ping = None  # the empty-verify probe path
        flaky.broken = True
        log, records = slog_mod.capture(clock=lambda: 0.0)
        ladder = res_mod.ResilientVerifier([flaky], retries=0, backoff_s=0.001,
                                           probe_interval_s=0.02, log=log)
        steps = [ladder.verify_batch(pool), gauges(ladder),
                 ladder.verify_rounds([pool[:3], [], pool[3:5]])]
        flaky.broken = False
        steps += [ladder.verify_batch(pool), gauges(ladder)]
        wait_promoted(ladder)
        steps.append(ladder.tier_health())
        out[name] = (steps, events(records))
    assert out["port"] == out["ref"]
    steps, evs = out["port"]
    assert steps[0] == [False] * len(pool) and steps[1][:2] == (1, 0) and steps[1][3] == 1
    assert steps[2] == [[False] * 3, [], [False] * 2]
    assert steps[3] == want and steps[4][0] == 0 and steps[5] == [True]
    assert [e["event"] for e in evs][:4] == ["verify_tier_down", "verify_exhausted"] * 2


def test_ladder_wires_pipeline_quarantine_to_next_tier(keys, reg, tables):
    """tests/test_resilient.py:145: each package's pipeline tier gets the
    ladder's next tier as its quarantine verifier; under an unbounded
    resolve storm (the same seeded plan) the floor answers every
    quarantined chunk, the masks equal the oracle's and the ladder sees no
    exception."""
    pool = _signed_pool(keys, 48, seed=15)
    want = JCPUVerifier(keys[0]).verify_batch(pool)
    out = {}
    for name, res_mod, pipe_cls, floor in (
            ("ref", jres, JVerifierPipeline, JCPUVerifier(keys[0])),
            ("port", resilient, VerifierPipeline, CPUVerifier(reg))):
        dev = card(reg, tables)
        pipe = pipe_cls(dev, depth=2, fixed_bucket=16, warmup=False)
        ladder = res_mod.ResilientVerifier([pipe, floor], retries=0)
        assert pipe.quarantine_verifier is floor
        inj = VerifierFaultInjector(VerifierFaultPlan(resolve_raise=1.0, seed=15))
        try:
            inj.arm(dev)
            mask = ladder.verify_batch(pool)
        finally:
            inj.disarm()
        out[name] = (mask, gauges(ladder), ladder.resilience_stats(), inj.stats)
    assert out["port"] == out["ref"]
    mask, g, rs, _ = out["port"]
    assert mask == want and g[0] == 0 and g[2] == 0
    assert rs["quarantined"] == 3 and rs["quarantine_rejected"] == 0
    assert rs["poisoned_windows"] >= 1


# -- knobs --------------------------------------------------------------------


@pytest.mark.parametrize("knob, values", [
    ("DAGRIDER_VERIFY_RETRY", [None, "0", "3", "-1", "x"]),
    ("DAGRIDER_VERIFY_FALLBACK", [None, "0", "off", "none", "false", "CPU", "cpu", "gpu"]),
])
def test_verify_knobs_read_as_the_reference_reads_them(monkeypatch, reg, knob, values):
    """tests/test_resilient.py:347: the two knobs' defaults, values and
    refusals are the reference's; ResilientVerifier(retries=None) reads
    DAGRIDER_VERIFY_RETRY and refuses an empty ladder."""
    fn = {"DAGRIDER_VERIFY_RETRY": "default_verify_retry",
          "DAGRIDER_VERIFY_FALLBACK": "default_verify_fallback"}[knob]

    def outcome(mod):
        try:
            return getattr(mod, fn)()
        except ValueError as exc:
            return ("ValueError", str(exc))

    for value in values:
        if value is None:
            monkeypatch.delenv(knob, raising=False)
        else:
            monkeypatch.setenv(knob, value)
        assert outcome(resilient) == outcome(jres), (knob, value)
    monkeypatch.setenv("DAGRIDER_VERIFY_RETRY", "3")
    assert resilient.ResilientVerifier([CPUVerifier(reg)]).retries == 3
    assert resilient.ResilientVerifier([CPUVerifier(reg)], retries=0).retries == 0
    with pytest.raises(ValueError):
        resilient.ResilientVerifier([])


# -- the cluster: a tier down mid-run -------------------------------------------


def _run_cluster(sim_cls, cfg, factory, signers, mid_run=None):
    sim = sim_cls(cfg, verifier_factory=factory, signer_factory=lambda i: signers[i])
    sim.submit_blocks(per_process=2)
    for cycle in range(10):
        sim.run(max_messages=N * (N - 1))
        if mid_run is not None and cycle == 3:
            mid_run()
    sim.check_agreement()
    return [(v.id.round, v.id.source, v.digest()) for v in sim.deliveries[0]], sim


def test_sim_commit_order_with_a_tier_down_mid_run(keys, reg, tables):
    """tests/test_resilient.py:285 without the sidecar: the first tier goes
    down after cycle 3 and stays down (a long probe interval), so every
    later cycle runs on the floor. Both packages' logs are byte-identical
    and equal the JAX CPUVerifier run's; the gauges reach each process's
    metrics snapshot."""
    jsigners = [jbase.VertexSigner(s) for s in keys[1]]
    signers = [base.VertexSigner(s) for s in keys[1]]
    jcfg = JConfig(n=N, coin="round_robin", propose_empty=True)
    cfg = Config(n=N, coin="round_robin", propose_empty=True)
    cpu_log, _ = _run_cluster(JSimulation, jcfg, lambda i: JCPUVerifier(keys[0]), jsigners)
    assert len(cpu_log) > 10, "the JAX CPU run delivered too little"

    runs = {}
    for name, sim_cls, c, res_mod, pkg_base, inner, floor, sg in (
            ("ref", JSimulation, jcfg, jres, jbase, JCPUVerifier(keys[0]),
             JCPUVerifier(keys[0]), jsigners),
            ("port", Simulation, cfg, resilient, base, card(reg, tables),
             CPUVerifier(reg), signers)):
        flaky = flaky_tier(pkg_base, inner)
        ladder = res_mod.ResilientVerifier([flaky, floor], retries=0, backoff_s=0.001,
                                           probe_interval_s=60.0)

        def down(flaky=flaky):
            flaky.broken = True

        log, sim = _run_cluster(sim_cls, c, lambda i, lad=ladder: lad, sg, mid_run=down)
        snap = sim.processes[0].metrics.snapshot()
        runs[name] = (log, gauges(ladder), flaky.calls, snap.get("verify_fallback_tier"),
                      snap.get("verify_retries"))
    assert runs["port"] == runs["ref"]
    log, g, calls, tier, _ = runs["port"]
    assert log == cpu_log
    assert g[2] >= 1 and tier == 1, "the tier going down never hit the verify path"
