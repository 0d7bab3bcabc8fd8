"""The port's parallel host-prep engine: bytes, masks and the seams.

The recipes of tests/test_prep.py that need no mesh, against
``dag_rider_tpu_torch.verifier.prep`` and ``CUDAVerifier(device="cpu")``:
the engine's unit half (plan, row blocks, serial retry, FIFO seam, the
knob), masks byte-identical to the CPU oracle at every (workers, depth)
through the streamed ``verify_rounds`` and ``VerifierPipeline``, the
engine engaged through the async seam, and the staging-ring discipline
under prep-ahead. The prep arrays of the port's ``_prepare`` are
byte-equal to the JAX ``TPUVerifier._prepare(comb=True)``'s in the 4-bit
and the 8-bit layouts at 1 and 4 workers.
"""

import collections
import random

import numpy as np
import pytest

from test_pipeline import N, _random_rounds, _signed_pool

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

from dag_rider_tpu.verifier.base import KeyRegistry as JKeyRegistry
from dag_rider_tpu.verifier.tpu import TPUVerifier
from dag_rider_tpu_torch.utils.metrics import Metrics
from dag_rider_tpu_torch.verifier.base import KeyRegistry
from dag_rider_tpu_torch.verifier.cpu import CPUVerifier
from dag_rider_tpu_torch.verifier.cuda import CUDAVerifier
from dag_rider_tpu_torch.verifier.pipeline import VerifierPipeline
from dag_rider_tpu_torch.verifier.prep import (
    MIN_BLOCK_ROWS,
    PrepEngine,
    default_prep_workers,
)


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


def make(reg, tables, cls=CUDAVerifier, **attrs):
    v = cls(reg, device="cpu")
    v._tables = tables
    for k, val in attrs.items():
        setattr(v, k, val)
    return v


# -- engine unit half -----------------------------------------------------


def test_plan_partitions_exactly():
    """Every plan covers [0, size) contiguously, exactly once, and small
    sizes stay a single block."""
    for workers in (1, 2, 3, 4, 8):
        eng = PrepEngine(workers)
        try:
            for size in (0, 1, 15, 16, 17, 31, 32, 48, 64, 100, 257):
                blocks = eng.plan(size)
                assert blocks[0][0] == 0
                assert blocks[-1][1] == size or (size == 0 and blocks == [(0, 0)])
                for (_, ahi), (blo, _) in zip(blocks, blocks[1:]):
                    assert ahi == blo, "gap or overlap between blocks"
                if workers == 1 or size < 2 * MIN_BLOCK_ROWS:
                    assert len(blocks) == 1
                assert len(blocks) <= max(1, min(workers, size // MIN_BLOCK_ROWS))
        finally:
            eng.close()


def test_run_blocks_writes_every_row_and_counts():
    eng = PrepEngine(4)
    try:
        out = np.zeros(100, dtype=np.int64)

        def fill(lo, hi):
            out[lo:hi] = np.arange(lo, hi)

        eng.run_blocks(fill, eng.plan(100))
        assert np.array_equal(out, np.arange(100))
        assert eng.last_blocks == 4
        assert eng.rows_total == 100 and eng.rows_parallel == 100
        assert eng.parallel_fraction() == 1.0
        eng.run_blocks(fill, eng.plan(10))  # sub-floor: serial, dilutes the gauge
        assert eng.last_blocks == 1
        assert 0.0 < eng.parallel_fraction() < 1.0
    finally:
        eng.close()


def test_run_blocks_propagates_persistent_exception():
    eng = PrepEngine(4)
    try:

        def boom(lo, hi):
            raise RuntimeError("worker failed")

        with pytest.raises(RuntimeError, match="worker failed"):
            eng.run_blocks(boom, eng.plan(64))
        assert eng.serial_retries == 1
    finally:
        eng.close()


def test_run_blocks_serial_retry_recovers_transient_fault():
    eng = PrepEngine(4)
    try:
        out = np.zeros(64, dtype=np.int64)
        retry_calls = []

        def flaky(lo, hi):
            if lo > 0:
                raise RuntimeError("transient worker fault")
            if (lo, hi) == (0, 64):
                retry_calls.append((lo, hi))
            out[lo:hi] = np.arange(lo, hi)

        eng.run_blocks(flaky, eng.plan(64))
        assert np.array_equal(out, np.arange(64))
        assert eng.serial_retries == 1
        assert retry_calls == [(0, 64)]
    finally:
        eng.close()


def test_seam_executor_is_fifo():
    eng = PrepEngine(2)
    try:
        order = []
        futs = [eng.submit(order.append, i) for i in range(16)]
        for f in futs:
            f.result()
        assert order == list(range(16))
    finally:
        eng.close()


def test_env_knob_and_engine_rebuild(reg, monkeypatch):
    monkeypatch.setenv("DAGRIDER_PREP_WORKERS", "3")
    assert default_prep_workers() == 3
    v = CUDAVerifier(reg, device="cpu")
    assert v.prep_stats()["workers"] == 3
    v.prep_workers = 2
    assert v.prep_stats()["workers"] == 2
    monkeypatch.setenv("DAGRIDER_PREP_WORKERS", "0")
    with pytest.raises(ValueError):
        default_prep_workers()


def test_metrics_prep_gauges_and_amortized_marker():
    m = Metrics()
    assert "verify_prep_workers" not in m.snapshot()
    m.observe_prep(4, 0.75)
    m.mark_verify_amortized()
    snap = m.snapshot()
    assert snap["verify_prep_workers"] == 4
    assert snap["verify_prep_parallel_fraction"] == 0.75
    assert snap["verify_timings_amortized"] == 1


# -- bytes: the port's _prepare equals the JAX package's ---------------------


@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("bits", ["4", "8"])
def test_prepare_bytes_equal_jax(keys, reg, monkeypatch, bits, workers):
    """60 rows (corrupted ones among them) padded to 64: every byte of
    both transfer arrays equals the JAX prep, serial and row-parallel."""
    monkeypatch.setenv("DAGRIDER_COMB_BITS", bits)
    pool = _signed_pool(keys, 60, seed=7 + workers)
    jv = TPUVerifier(keys[0])
    jv.prep_workers = workers
    want = jv._prepare(pool, 64, comb=True)
    v = CUDAVerifier(reg, device="cpu")
    v.prep_workers = workers
    got = v._prepare(pool, 64)
    assert [a.shape for a in got] == [(64, 67 if bits == "8" else 131), (64, 23)]
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    if workers > 1:
        assert v.prep_stats()["last_blocks"] == 4


# -- masks: byte-identical at every (workers, depth) -------------------------


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("workers", [1, 4])
def test_prep_masks_byte_identical(keys, reg, tables, workers, depth):
    """Row-block parallel prep + prep-ahead == serial prep == CPU oracle.
    Bucket 32 forces over-cap chunking and 2-block prep at 4 workers;
    bucket 64 engages all 4 blocks."""
    cpu = CPUVerifier(reg)
    for bucket in (32, 64):
        rng = random.Random(10_000 * workers + 100 * depth + bucket)
        pool = _signed_pool(keys, 96, seed=rng.randrange(1 << 30))
        rounds = _random_rounds(pool, rng)
        want = [cpu.verify_batch(r) for r in rounds]
        assert any(not all(m) for m in want if m), "no corruption landed"

        streamed = make(reg, tables, fixed_bucket=bucket, pipeline_depth=depth,
                        prep_workers=workers)
        assert streamed.verify_rounds(rounds) == want

        pipe = VerifierPipeline(make(reg, tables), depth=depth, fixed_bucket=bucket,
                                warmup=False)
        pipe.verifier.prep_workers = workers
        assert pipe.verify_rounds(rounds) == want
        if workers > 1:
            assert pipe.stats()["prep_workers"] == workers
            assert pipe.verifier.prep_stats()["parallel_fraction"] > 0.0


def test_prep_engine_active_through_async_seam(keys, reg, tables):
    """A multi-chunk burst through the pipeline at workers=4 engages the
    row-block pool and the prep-ahead seam thread."""
    pool = _signed_pool(keys, 160, seed=42)
    want = CPUVerifier(reg).verify_batch(pool)
    pipe = VerifierPipeline(make(reg, tables), depth=2, fixed_bucket=64, warmup=False)
    pipe.verifier.prep_workers = 4
    assert pipe.verify_batch(pool) == want
    eng = pipe.verifier._prep()
    assert eng.workers == 4
    assert eng.dispatches_parallel > 0, "row-block pool never engaged"
    assert eng._seam is not None, "prep-ahead seam thread never engaged"
    s = pipe.stats()
    assert s["prep_workers"] == 4 and s["prep_parallel_fraction"] > 0.0


def test_streamed_verify_rounds_uses_prep_ahead(keys, reg, tables):
    pool = _signed_pool(keys, 160, seed=43)
    want = CPUVerifier(reg).verify_batch(pool)
    v = make(reg, tables, fixed_bucket=64, pipeline_depth=2, prep_workers=4)
    assert v.verify_rounds([pool]) == [want]
    assert v._prep()._seam is not None, "streaming path skipped prep-ahead"
    assert v.total_dispatches == 3 and v.total_sigs_dispatched == 160


def test_pipeline_takes_the_async_prep_branch_and_warms_up(keys, reg, tables):
    """VerifierPipeline over the port's verifier: construction runs
    warmup() (no total_* counter booked), and a multi-chunk burst goes
    through prep_batch_async/dispatch_prepped, with the engine's gauges in
    stats()."""
    v = make(reg, tables)
    calls = collections.Counter()
    for name in ("prep_batch_async", "dispatch_prepped", "dispatch_batch"):
        def spy(*args, _name=name, _orig=getattr(v, name)):
            calls[_name] += 1
            return _orig(*args)

        setattr(v, name, spy)
    pipe = VerifierPipeline(v, depth=2, fixed_bucket=32)
    assert pipe.warmup_compile_s > 0 and v.warmup_compile_s == pipe.warmup_compile_s
    assert (v.total_dispatches, v.total_sigs_dispatched, v.total_prepare_s) == (0, 0, 0.0)
    assert v.warmup(32) == 0.0  # warm already
    pool = _signed_pool(keys, 80, seed=44)
    assert pipe.verify_batch(pool) == CPUVerifier(reg).verify_batch(pool)
    assert calls == {"prep_batch_async": 3, "dispatch_prepped": 3}
    assert v.total_dispatches == 3
    s = pipe.stats()
    assert s["prep_workers"] == v.prep_stats()["workers"] == 1
    assert "prep_parallel_fraction" in s and s["warmup_compile_s"] >= 0


class _RingWatchVerifier(CUDAVerifier):
    """Snapshots every dispatched staging slot and asserts at resolve
    time that the live slot still holds the dispatched bytes — no later
    prep rewrote it while the dispatch could still be executing."""

    def __init__(self, reg, device="cpu"):
        super().__init__(reg, device=device)
        self.snaps = collections.deque()
        self.checked = 0

    def dispatch_prepped(self, prepped):
        out = super().dispatch_prepped(prepped)
        arrs = [a for a in prepped.args if isinstance(a, np.ndarray)]
        assert arrs, "expected numpy staging arrays in the dispatch args"
        self.snaps.append((arrs, [a.copy() for a in arrs]))
        return out

    def resolve_batch(self, handle):
        arrs, copies = self.snaps.popleft()  # FIFO == ring claim order
        for live, snap in zip(arrs, copies):
            assert np.array_equal(live, snap), (
                "staging slot rewritten while its dispatch was in flight"
            )
        self.checked += 1
        return super().resolve_batch(handle)


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_staging_ring_slot_not_rewritten_while_inflight(keys, reg, tables, depth):
    pool = _signed_pool(keys, 320, seed=9 * depth)
    want = CPUVerifier(reg).verify_batch(pool)
    v = make(reg, tables, cls=_RingWatchVerifier, fixed_bucket=64, prep_workers=4)
    pipe = VerifierPipeline(v, depth=depth, warmup=False)
    assert pipe.verify_batch(pool) == want
    assert v.checked == 5  # ceil(320 / 64)
    assert not v.snaps


def test_simulation_snapshot_carries_prep_gauges_as_jax():
    """The port's Simulation fans the prep engine's gauges out to every
    process's metrics snapshot, as the JAX Simulation does over a verifier
    with prep_stats(): the same snapshot keys and the same gauges, at the
    same rounds (n = 4, the cluster of tests/test_determinism.py)."""
    from dag_rider_tpu.config import Config as JConfig
    from dag_rider_tpu.consensus.simulator import Simulation as JSimulation
    from dag_rider_tpu.verifier.base import VertexSigner as JSigner
    from dag_rider_tpu_torch import Config
    from dag_rider_tpu_torch.consensus.simulator import Simulation
    from dag_rider_tpu_torch.verifier.base import VertexSigner

    jreg, seeds = JKeyRegistry.generate(4)
    reg4 = KeyRegistry(jreg.public_keys)
    tables4 = CUDAVerifier(reg4, device="cpu").comb_tables()

    def run(cfg_cls, sim_cls, signer_cls):
        signers = [signer_cls(s) for s in seeds]
        ver = make(reg4, tables4, prep_workers=2)
        sim = sim_cls(cfg_cls(n=4, coin="round_robin", propose_empty=False),
                      verifier_factory=lambda i: ver, signer_factory=lambda i: signers[i])
        sim.submit_blocks(per_process=3)
        sim.run(max_messages=50_000)
        sim.check_agreement()
        return [p.round for p in sim.processes], [p.metrics.snapshot() for p in sim.processes]

    jrounds, jsnaps = run(JConfig, JSimulation, JSigner)
    rounds, snaps = run(Config, Simulation, VertexSigner)
    assert rounds == jrounds and min(rounds) > 1
    for snap, jsnap in zip(snaps, jsnaps):
        assert sorted(snap) == sorted(jsnap)
        assert snap["verify_prep_workers"] == jsnap["verify_prep_workers"] == 2
        assert "verify_prep_parallel_fraction" in snap
