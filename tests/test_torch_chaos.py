"""The port's verify stack under injected faults.

The verifier recipes of tests/test_chaos.py that need no
``ResilientVerifier`` or sidecar, against ``CUDAVerifier(device="cpu")``
and the port's ``verifier.faults`` harness: an armed injector that never
fires changes nothing; one prep, dispatch or resolve fault poisons one
window, is contained (salvage, fresh staging slots, quarantine) and the
mask still equals the CPU oracle; unbounded faults drain through a
quarantine tier (the port's ``CPUVerifier``) or fail closed to a
full-length all-False mask; and the port's ``Simulation`` under
verify-stack chaos delivers the commit order of the fault-free JAX run.
"""

import random

import pytest

from test_pipeline import N, _random_rounds, _signed_pool

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

from dag_rider_tpu.config import Config as JConfig
from dag_rider_tpu.consensus.simulator import Simulation as JSimulation
from dag_rider_tpu.verifier.base import KeyRegistry as JKeyRegistry
from dag_rider_tpu.verifier.base import VertexSigner as JSigner
from dag_rider_tpu.verifier.cpu import CPUVerifier as JCPUVerifier
from dag_rider_tpu_torch import Config
from dag_rider_tpu_torch.consensus.simulator import Simulation
from dag_rider_tpu_torch.verifier.base import KeyRegistry, VertexSigner
from dag_rider_tpu_torch.verifier.cpu import CPUVerifier
from dag_rider_tpu_torch.verifier.cuda import CUDAVerifier
from dag_rider_tpu_torch.verifier.faults import VerifierFaultInjector, VerifierFaultPlan
from dag_rider_tpu_torch.verifier.pipeline import VerifierPipeline


@pytest.fixture(scope="module")
def keys():
    return JKeyRegistry.generate(N)


@pytest.fixture(scope="module")
def reg(keys):
    return KeyRegistry(keys[0].public_keys)


@pytest.fixture(scope="module")
def tables(reg):
    """The 4-bit comb tables, built once and handed to every verifier."""
    return CUDAVerifier(reg, device="cpu").comb_tables()


def make(reg, tables, **attrs):
    v = CUDAVerifier(reg, device="cpu")
    v._tables = tables
    for k, val in attrs.items():
        setattr(v, k, val)
    return v


def test_faults_off_is_byte_identical(keys, reg, tables):
    """An armed injector whose plan never fires changes no mask bit or
    gauge, and disarm() restores the class seams."""
    rng = random.Random(901)
    pool = _signed_pool(keys, 48, seed=901)
    rounds = _random_rounds(pool, rng)
    cpu = CPUVerifier(reg)
    want = [cpu.verify_batch(r) for r in rounds]
    assert any(not all(m) for m in want if m), "no corruption landed"

    v = make(reg, tables, fixed_bucket=16, pipeline_depth=2)
    inj = VerifierFaultInjector(VerifierFaultPlan())  # every p = 0.0
    inj.arm(v)
    try:
        assert v.verify_rounds(rounds) == want
    finally:
        inj.disarm()
    assert inj.faults_injected == 0
    assert all(c == 0 for c in inj.stats.values())
    assert (v.poisoned_windows, v.quarantined_chunks, v.quarantine_rejected) == (0, 0, 0)
    for seam in ("_prep_block", "dispatch_prepped", "resolve_batch"):
        assert seam not in v.__dict__
    assert v.verify_rounds(rounds) == want


@pytest.mark.parametrize("kind", ["prep_raise", "dispatch_raise", "resolve_raise"])
def test_pipeline_contains_fault_and_recovers(keys, reg, tables, kind):
    """One injected fault per seam kind: the window is poisoned once, the
    failing chunk quarantined, the mask equals the CPU oracle, and the
    next clean pass is byte-identical."""
    pool = _signed_pool(keys, 48, seed=902)
    want = CPUVerifier(reg).verify_batch(pool)
    assert any(not ok for ok in want), "no corruption landed"

    base = make(reg, tables)
    pipe = VerifierPipeline(base, depth=2, fixed_bucket=16, warmup=False)
    inj = VerifierFaultInjector(VerifierFaultPlan(**{kind: 1.0}, max_faults=1, seed=902))
    inj.arm(base)
    try:
        assert pipe.verify_batch(pool) == want
    finally:
        inj.disarm()
    assert inj.exhausted() and inj.stats[kind] == 1
    rs = pipe.resilience_stats()
    assert rs["poisoned_windows"] == 1
    assert rs["quarantined"] >= 1
    assert rs["quarantine_rejected"] == 0
    s = pipe.stats()
    assert s["poisoned_windows"] == 1 and s["quarantined"] >= 1
    assert pipe.verify_batch(pool) == want


def test_streamed_rounds_contain_faults(keys, reg, tables):
    """The chunk-streaming verify_rounds window (no pipeline) contains
    resolve faults the same way."""
    rng = random.Random(903)
    pool = _signed_pool(keys, 48, seed=903)
    rounds = _random_rounds(pool, rng)
    cpu = CPUVerifier(reg)
    want = [cpu.verify_batch(r) for r in rounds]

    v = make(reg, tables, fixed_bucket=16, pipeline_depth=2)
    inj = VerifierFaultInjector(VerifierFaultPlan(resolve_raise=1.0, max_faults=2, seed=903))
    inj.arm(v)
    try:
        assert v.verify_rounds(rounds) == want
    finally:
        inj.disarm()
    assert inj.faults_injected == 2
    assert v.poisoned_windows >= 1
    assert v.quarantined_chunks >= 1
    assert v.quarantine_rejected == 0
    assert v.verify_rounds(rounds) == want


def test_unbounded_faults_drain_via_quarantine_tier(keys, reg, tables):
    """Every resolve raises, forever; a clean quarantine tier re-verifies
    every chunk, so the mask still equals the oracle and the window
    drains."""
    pool = _signed_pool(keys, 48, seed=904)
    want = CPUVerifier(reg).verify_batch(pool)
    base = make(reg, tables)
    pipe = VerifierPipeline(base, depth=2, fixed_bucket=16, warmup=False)
    pipe.quarantine_verifier = CPUVerifier(reg)
    inj = VerifierFaultInjector(VerifierFaultPlan(resolve_raise=1.0, seed=904))
    inj.arm(base)
    try:
        assert pipe.verify_batch(pool) == want
    finally:
        inj.disarm()
    rs = pipe.resilience_stats()
    assert rs["quarantined"] == 3  # ceil(48 / 16): every chunk quarantined
    assert rs["quarantine_rejected"] == 0
    assert pipe._pending() == 0, "window did not drain"


def test_unbounded_faults_without_tier_fail_closed_full_length(keys, reg, tables):
    """The same storm with no tier: the quarantine retry hits the same
    faulting verifier and fails closed — a full-length all-False mask —
    and once the fault clears the masks are right again."""
    pool = _signed_pool(keys, 48, seed=905)
    base = make(reg, tables)
    pipe = VerifierPipeline(base, depth=2, fixed_bucket=16, warmup=False)
    inj = VerifierFaultInjector(VerifierFaultPlan(resolve_raise=1.0, seed=905))
    inj.arm(base)
    try:
        mask = pipe.verify_batch(pool)
    finally:
        inj.disarm()
    assert mask == [False] * len(pool)
    rs = pipe.resilience_stats()
    assert rs["quarantine_rejected"] == 3
    assert pipe._pending() == 0, "window did not drain"
    assert pipe.verify_batch(pool) == CPUVerifier(reg).verify_batch(pool)


@pytest.fixture(scope="module")
def jax_fault_free_log(keys):
    """The fault-free JAX run's log at view 0: JAX Simulation, JAX
    CPUVerifier, the recipe of tests/test_chaos.py."""
    reg, seeds = keys
    signers = [JSigner(s) for s in seeds]
    sim = JSimulation(
        JConfig(n=N, coin="round_robin", propose_empty=True),
        verifier_factory=lambda i: JCPUVerifier(reg),
        signer_factory=lambda i: signers[i],
    )
    sim.submit_blocks(per_process=2)
    for _ in range(10):
        sim.run(max_messages=N * (N - 1))
    sim.check_agreement()
    log = [(v.id.round, v.id.source, v.digest()) for v in sim.deliveries[0]]
    assert len(log) > 10, "the JAX reference run delivered too little"
    return log


@pytest.mark.parametrize("kind", ["dispatch_raise", "resolve_raise"])
def test_sim_commit_order_under_chaos_matches_fault_free_jax(
    keys, reg, tables, jax_fault_free_log, kind
):
    """A verify-stack fault mid-consensus in the port's Simulation (one
    shared CUDAVerifier, dedup off so bursts chunk past the bucket) does
    not move the commit order: it equals the fault-free JAX run's, and
    the containment gauges reach the metrics snapshot."""
    signers = [VertexSigner(s) for s in KeyRegistry.generate(N)[1]]
    shared = make(reg, tables, fixed_bucket=16, pipeline_depth=2)
    inj = VerifierFaultInjector(VerifierFaultPlan(**{kind: 1.0}, max_faults=1, seed=906))
    inj.arm(shared)
    try:
        sim = Simulation(
            Config(n=N, coin="round_robin", propose_empty=True),
            verifier_factory=lambda i: shared,
            signer_factory=lambda i: signers[i],
        )
        sim.dedup = False
        sim.submit_blocks(per_process=2)
        for _ in range(10):
            sim.run(max_messages=N * (N - 1))
        sim.check_agreement()
    finally:
        inj.disarm()
    assert inj.faults_injected == 1, "chaos never hit the verify path"
    log = [(v.id.round, v.id.source, v.digest()) for v in sim.deliveries[0]]
    k = min(len(log), len(jax_fault_free_log))
    assert k > 10 and log[:k] == jax_fault_free_log[:k]
    snap = sim.processes[0].metrics.snapshot()
    assert snap.get("verify_quarantined", 0) >= 1
    assert "verify_retries" in snap and snap["verify_prep_workers"] == 1
