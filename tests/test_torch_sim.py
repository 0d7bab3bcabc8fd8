"""The port's ``Simulation`` vs the JAX package's: the same cluster runs give
the same commit order, byte for byte.

Each recipe is built once from the JAX package and once from the port
(``dag_rider_tpu_torch``), from the same ``Config`` fields, seeds and keys,
and driven by the same sequence of calls. Every view's log of
``(round, source, digest)`` and every process's ``decided_wave`` must be
equal, and each run must deliver something. The recipes are those of
``tests/test_determinism.py`` (CPU vs device verifier, pipelined vs
synchronous, dedup on and off, dedup of corrupted copies, seeded
schedules), ``tests/test_e2e_sim.py`` (seven nodes), the RBC stage, the
threshold-BLS coin (leaders equal) and aggregated round certificates.

The port's device verifier is ``CUDAVerifier(device="cpu")``: the kernels'
plain torch versions, which the card's kernels equal bit for bit
(``tests/test_torch_cuda*.py``). The JAX side takes its host oracle
``CPUVerifier`` where its own tests take ``TPUVerifier``: they give equal
masks there (``tests/test_determinism.py``).
"""

import dataclasses
import sys
import types
from pathlib import Path

import pytest

from dag_rider_tpu.config import Config as JConfig
from dag_rider_tpu.consensus.coin import ThresholdCoin as JCoin
from dag_rider_tpu.consensus.simulator import (
    RandomizedScheduler as JScheduler,
    Simulation as JSimulation,
)
from dag_rider_tpu.core import types as JT
from dag_rider_tpu.crypto import threshold as jth
from dag_rider_tpu.transport.memory import InMemoryTransport as JBroker
from dag_rider_tpu.verifier.base import KeyRegistry as JKeyRegistry
from dag_rider_tpu.verifier.base import VertexSigner as JSigner
from dag_rider_tpu.verifier.cpu import CPUVerifier as JCPUVerifier
from dag_rider_tpu_torch.config import Config as TConfig
from dag_rider_tpu_torch.consensus.coin import ThresholdCoin as TCoin
from dag_rider_tpu_torch.consensus.simulator import (
    RandomizedScheduler as TScheduler,
    Simulation as TSimulation,
)
from dag_rider_tpu_torch.core import types as TT
from dag_rider_tpu_torch.crypto import threshold as tth
from dag_rider_tpu_torch.transport.memory import InMemoryTransport as TBroker
from dag_rider_tpu_torch.verifier.base import KeyRegistry as TKeyRegistry
from dag_rider_tpu_torch.verifier.base import VertexSigner as TSigner
from dag_rider_tpu_torch.verifier.cpu import CPUVerifier as TCPUVerifier
from dag_rider_tpu_torch.verifier.cuda import CUDAVerifier

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import shared_coin_factory  # noqa: E402

JAX = types.SimpleNamespace(
    Config=JConfig, Simulation=JSimulation, Scheduler=JScheduler, Broker=JBroker,
    KeyRegistry=JKeyRegistry, Signer=JSigner, T=JT,
)
PORT = types.SimpleNamespace(
    Config=TConfig, Simulation=TSimulation, Scheduler=TScheduler, Broker=TBroker,
    KeyRegistry=TKeyRegistry, Signer=TSigner, T=TT,
)


def logs(sim):
    return [[(v.id.round, v.id.source, v.digest()) for v in d] for d in sim.deliveries]


def outcome(sim):
    """Per-view logs and decided waves: what must be equal across packages."""
    return logs(sim), [p.decided_wave for p in sim.processes]


def assert_delivered(out):
    assert any(out[0]), "nothing was delivered"


@pytest.fixture(scope="module")
def keys8():
    """The n = 8 test PKI of both packages (equal seeds) and the port's
    plain-path device verifier over it, shared so its tables build once."""
    jreg, jseeds = JKeyRegistry.generate(8)
    treg, tseeds = TKeyRegistry.generate(8)
    assert treg.public_keys == jreg.public_keys and tseeds == jseeds
    return {
        "jax": (jreg, [JSigner(s) for s in jseeds]),
        "port": (treg, [TSigner(s) for s in tseeds]),
        "cuda": CUDAVerifier(treg, device="cpu"),
    }


# --- seeded schedules (tests/test_determinism.py:19) ------------------------------


def _scheduled(pkg, seed):
    cfg = pkg.Config(n=4, coin="round_robin", propose_empty=False)
    broker = pkg.Broker()
    sim = pkg.Simulation(cfg, transport=broker)
    sim.submit_blocks(per_process=8)
    for p in sim.processes:
        p.defer_steps = True
        p.start()
    sched = pkg.Scheduler(broker, seed=seed)
    for _ in range(5000):
        if not sched.run(max_messages=1):
            for p in sim.processes:
                p.step()
            if broker.pending == 0:
                break
    for p in sim.processes:
        p.step()
    sim.check_agreement()
    return outcome(sim)


@pytest.mark.parametrize("seed", [1234, 2])
def test_randomized_scheduler_same_order(seed):
    want = _scheduled(JAX, seed)
    assert _scheduled(PORT, seed) == want
    assert_delivered(want)


# --- CPU vs device verifier (tests/test_determinism.py:81) -------------------------


def _signed_run(pkg, n, verifier, signers, per_process, **sim_kw):
    cfg = pkg.Config(n=n, coin="round_robin", propose_empty=False)
    sim = pkg.Simulation(
        cfg, verifier_factory=lambda i: verifier, signer_factory=lambda i: signers[i],
        **sim_kw,
    )
    sim.submit_blocks(per_process=per_process)
    sim.run(max_messages=50_000)
    sim.check_agreement()
    return outcome(sim), sim


def test_cpu_vs_device_verifier_same_order():
    jreg, jseeds = JKeyRegistry.generate(4)
    treg, tseeds = TKeyRegistry.generate(4)
    jsig, tsig = [JSigner(s) for s in jseeds], [TSigner(s) for s in tseeds]
    want, _ = _signed_run(JAX, 4, JCPUVerifier(jreg), jsig, 10)
    got_cpu, _ = _signed_run(PORT, 4, TCPUVerifier(treg), tsig, 10)
    dev = CUDAVerifier(treg, device="cpu")
    got_dev, sim = _signed_run(PORT, 4, dev, tsig, 10)
    assert got_cpu == want
    assert got_dev == want
    assert_delivered(want)
    stats = sim._verify_pipe.stats()
    assert stats["dispatches"] > 0 and "poisoned_windows" not in stats


# --- pipelined vs synchronous (tests/test_determinism.py:112) ----------------------


def _lockstep(pkg, vf, signers, runs, dedup=True, n=8):
    cfg = pkg.Config(n=n, coin="round_robin", propose_empty=True)
    sim = pkg.Simulation(cfg, verifier_factory=vf, signer_factory=lambda i: signers[i])
    sim.dedup = dedup
    sim.submit_blocks(per_process=2)
    for _ in range(runs):
        sim.run(max_messages=n * (n - 1))
    sim.check_agreement()
    return outcome(sim), sim


def test_pipelined_and_sync_paths_same_order(keys8):
    # 12 lockstep runs, not the recipe's 24, and no fixed bucket of 128
    # (there it sets the JAX program's shape): each run is one plain-path
    # dispatch on the CPU, ~0.3 s
    jreg, jsig = keys8["jax"]
    treg, tsig = keys8["port"]
    dev = keys8["cuda"]
    # the port's pipelined path (shared device verifier, depth-K window)
    piped, sim = _lockstep(PORT, lambda i: dev, tsig, 12)
    assert sim._verify_pipe.dispatches > 0
    shared = JCPUVerifier(jreg)
    assert piped == _lockstep(JAX, lambda i: shared, jsig, 12)[0]
    # the recipe's own claim, across the packages: the pipelined log is a
    # prefix-match of the synchronous per-process one
    sync = _lockstep(JAX, lambda i: JCPUVerifier(jreg), jsig, 12)[0]
    a, b = piped[0][0], sync[0][0]
    assert len(a) > 20
    k = min(len(a), len(b))
    assert a[:k] == b[:k]


# --- dedup on and off (tests/test_determinism.py:153) ------------------------------


class AsyncOracle(TCPUVerifier):
    """The port's host oracle behind the async halves ``VerifierPipeline``
    drives, so a Simulation takes the pipelined path at host-oracle cost."""

    fixed_bucket = None

    def dispatch_batch(self, vertices):
        return self.verify_batch(vertices)

    def resolve_batch(self, pending):
        return pending


def test_dedup_on_and_off_same_order(keys8):
    jreg, jsig = keys8["jax"]
    treg, tsig = keys8["port"]
    outs, dispatched, applied = [], [], []
    for dedup in (True, False):
        shared_t = AsyncOracle(treg)
        shared_t.fixed_bucket = 128
        got, sim = _lockstep(PORT, lambda i: shared_t, tsig, 12, dedup=dedup)
        shared = JCPUVerifier(jreg)
        want, jsim = _lockstep(JAX, lambda i: shared, jsig, 12, dedup=dedup)
        assert got == want
        outs.append(got)
        dispatched.append(sim._verify_pipe.sigs_dispatched)
        applied.append(sum(p.metrics.verify_sigs_total for p in sim.processes))
        assert applied[-1] == sum(p.metrics.verify_sigs_total for p in jsim.processes)
    assert len(outs[0][0][0]) > 20
    assert outs[0] == outs[1]
    assert applied[0] == applied[1]
    assert dispatched[0] * 2 < dispatched[1], (dispatched, applied)


# --- dedup keeps corrupted copies apart (tests/test_determinism.py:198) -------------


def test_dedup_does_not_conflate_corrupted_copies(keys8):
    results = []
    for pkg, verifier in ((JAX, JCPUVerifier(keys8["jax"][0])), (PORT, keys8["cuda"])):
        T = pkg.T
        signer = keys8["jax" if pkg is JAX else "port"][1][1]
        v = signer.sign_vertex(T.Vertex(
            id=T.VertexID(3, 1), block=T.Block((b"tx",)),
            strong_edges=(T.VertexID(2, 0), T.VertexID(2, 1), T.VertexID(2, 2)),
        ))
        bad = dataclasses.replace(v, signature=bytes(64))
        uniq, inv = pkg.Simulation._dedup([v, v, bad, v])
        umask = verifier.verify_batch(uniq)
        results.append(([u.digest() for u in uniq], inv, [umask[j] for j in inv]))
    assert results[1] == results[0]
    assert results[0][2] == [True, True, False, True] and len(results[0][0]) == 2


# --- seven nodes, f = 2 (tests/test_e2e_sim.py:16) ---------------------------------


def test_seven_nodes_same_order():
    outs = []
    for pkg in (JAX, PORT):
        sim = pkg.Simulation(pkg.Config(n=7, coin="round_robin"))
        sim.submit_blocks(per_process=2)
        sim.run(max_messages=8000)
        sim.check_agreement()
        assert all(p.metrics.counters["waves_decided"] >= 1 for p in sim.processes)
        outs.append(outcome(sim))
    assert outs[1] == outs[0]
    assert_delivered(outs[0])


# --- the RBC stage, signed --------------------------------------------------------


def test_rbc_signed_same_order():
    outs = []
    for pkg in (JAX, PORT):
        cfg = pkg.Config(n=4, coin="round_robin", propose_empty=False)
        sim = pkg.Simulation(cfg, verifier="cpu", rbc=True)
        sim.submit_blocks(per_process=4)
        sim.run(max_messages=30_000)
        sim.check_agreement()
        assert sum(p.metrics.counters["msgs_ignored_kind"] for p in sim.processes) == 0
        outs.append(outcome(sim))
    assert outs[1] == outs[0]
    assert_delivered(outs[0])


# --- the threshold-BLS coin (tests/test_coin_e2e.py:26) ----------------------------


def test_threshold_coin_same_order_and_leaders():
    """n = 4 with one oracle's books shared by the four coins, as
    ``chip_smoke.py`` builds them at n = 256: each wave's coin is combined
    once, through the port's device MSM on the plain torch path."""
    jkeys = jth.ThresholdKeys.generate(4, 2)
    tkeys = tth.ThresholdKeys(jkeys.threshold, jkeys.group_pk, jkeys.share_pks,
                              jkeys.share_sks)
    builds = {
        "jax": (JAX, shared_coin_factory(JCoin, jkeys, 4)),
        "port": (PORT, shared_coin_factory(TCoin, tkeys, 4, msm="device", device="cpu")),
    }
    outs, leaders = {}, {}
    for name, (pkg, (make, oracle)) in builds.items():
        sim = pkg.Simulation(pkg.Config(n=4, coin="threshold_bls", propose_empty=False),
                             coin_factory=make)
        sim.submit_blocks(per_process=6)
        sim.run(max_messages=20_000)
        sim.check_agreement()
        outs[name] = outcome(sim)
        leaders[name] = {w: (sigma, sim.processes[0].coin.choose_leader(w))
                         for w, sigma in oracle._sigma.items()}
        assert all(p.coin.choose_leader(w) == leaders[name][w][1]
                   for p in sim.processes for w in oracle._sigma)
    assert outs["port"] == outs["jax"]
    assert leaders["port"] == leaders["jax"] and leaders["jax"]
    assert max(outs["jax"][1]) >= 1
    assert_delivered(outs["jax"])


# --- aggregated round certificates (tests/test_cert.py:241) ------------------------


def test_cert_mode_same_order():
    outs, snaps = [], []
    # the port's certificate MSM on the plain torch path (device="cpu")
    for pkg, kw in ((JAX, {"verifier": "cpu"}), (PORT, {"verifier": "cpu", "device": "cpu"})):
        cfg = pkg.Config(n=4, coin="round_robin", propose_empty=False, pump="vector")
        sim = pkg.Simulation(cfg, cert=True, **kw)
        for i in range(4):
            for k in range(4):
                sim.processes[i].submit(pkg.T.Block((f"s0-p{i}-b{k}".encode().ljust(32, b"."),)))
        sim.run(max_messages=400_000)
        sim.check_agreement()
        outs.append(outcome(sim))
        snaps.append([p.metrics.snapshot() for p in sim.processes])
    assert outs[1] == outs[0]
    assert_delivered(outs[0])
    keys = ("certs_assembled", "certs_verified", "sigs_saved", "certs_rejected")
    counts = [[{k: s.get(k, 0) for k in keys} for s in ss] for ss in snaps]
    assert counts[1] == counts[0]
    assert sum(c["certs_assembled"] for c in counts[0]) > 0
    assert all(c["certs_rejected"] == 0 for c in counts[0])
