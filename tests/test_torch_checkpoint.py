"""The port's checkpoint and attested snapshot join against the JAX package's.

A span donor (``tests/test_epoch_snapshot.py``'s recipe: n = 4, aggregate
certificates with ``cert_span`` 2, ``gc_depth`` 16, grown past round 32)
is built once in each package from the same calls; a mempool-fronted
cluster (``tests/test_mempool.py``'s checkpoint recipe) likewise.

- ``save`` writes byte-identical files in both packages (the manifest's
  metrics snapshot apart from its wall-clock gauges and the process-wide
  hash-to-G1 cache counters), the snapshot
  blobs (plain and attested) are byte-identical, and each package
  ``restore``s either package's files to the same state: the restored
  processes save the same bytes in both packages.
- ``restore_from_snapshot`` in the port, with ``CUDAVerifier(reg,
  device="cpu")`` as the signature seam and a ``CertVerifier`` whose
  pairing runs the plain torch path on the CPU, accepts the same blobs
  and refuses the same tampered blobs as the JAX package with
  ``CPUVerifier`` and its host ``CertVerifier``, to the same state and
  the same counters. These are host modules: the tolerance is zero.
"""

import dataclasses
import json
import os
import re
import struct
import types

import pytest

from dag_rider_tpu.config import Config as JConfig, MempoolConfig as JMempoolConfig
from dag_rider_tpu.consensus.process import Process as JProcess
from dag_rider_tpu.consensus.simulator import Simulation as JSimulation
from dag_rider_tpu.core.types import Block as JBlock
from dag_rider_tpu.mempool import Mempool as JMempool, loadgen as jload
from dag_rider_tpu.transport.memory import InMemoryTransport as JBroker
from dag_rider_tpu.utils import checkpoint as jck
from dag_rider_tpu.verifier.cpu import CPUVerifier
from dag_rider_tpu_torch.config import Config as TConfig, MempoolConfig as TMempoolConfig
from dag_rider_tpu_torch.consensus.process import Process as TProcess
from dag_rider_tpu_torch.consensus.simulator import Simulation as TSimulation
from dag_rider_tpu_torch.core.types import Block as TBlock
from dag_rider_tpu_torch.mempool import Mempool as TMempool, loadgen as tload
from dag_rider_tpu_torch.transport.memory import InMemoryTransport as TBroker
from dag_rider_tpu_torch.utils import checkpoint as tck
from dag_rider_tpu_torch.verifier.cert import CertVerifier
from dag_rider_tpu_torch.verifier.cuda import CUDAVerifier

JAX = types.SimpleNamespace(Config=JConfig, MempoolConfig=JMempoolConfig, Simulation=JSimulation,
                            Process=JProcess, Block=JBlock, Broker=JBroker, ck=jck, load=jload,
                            Mempool=JMempool,
                            sim_kw={})
PORT = types.SimpleNamespace(Config=TConfig, MempoolConfig=TMempoolConfig, Simulation=TSimulation,
                             Process=TProcess, Block=TBlock, Broker=TBroker, ck=tck, load=tload,
                             Mempool=TMempool,
                             sim_kw=dict(cert_msm="host", cert_pair="host", device="cpu"))
K_SPAN = 2
TARGET_ROUND = 32


def span_donor(pkg):
    """``tests/test_epoch_snapshot.py:_build_donor`` (epoch off) over either
    package, with the wall-clock sync cooldowns pinned to 0 so that the
    two runs cannot part under a loaded CPU; the port's donor aggregates
    and pairs on the host, as the JAX package's does."""
    cfg = pkg.Config(n=4, coin="round_robin", propose_empty=True, gc_depth=16,
                     cert_span=K_SPAN, epoch=False, epoch_waves=4,
                     sync_request_cooldown_s=0.0, sync_serve_cooldown_s=0.0)
    sim = pkg.Simulation(cfg, verifier="cpu", cert=True, **pkg.sim_kw)
    for i in range(4):
        sim.processes[i].submit(pkg.Block((f"sn0-p{i}".encode().ljust(32, b"."),)))
    for _ in range(40 * TARGET_ROUND):
        sim.run(max_messages=200)
        donor = sim.processes[0]
        if donor.round >= TARGET_ROUND and donor.dag.base_round > 0 and donor._span_chain:
            break
    assert donor.dag.base_round > 0 and donor._span_chain
    return sim


def mempool_cluster(pkg):
    cfg = pkg.Config(n=4, coin="round_robin", propose_empty=True, gc_depth=24,
                     sync_request_cooldown_s=0.0, sync_serve_cooldown_s=0.0)
    sim = pkg.Simulation(cfg)
    drv = pkg.load.ClusterLoadDriver(
        sim, pkg.load.LoadGenerator(clients=8, rate=3000.0, seed=5),
        mcfg=pkg.MempoolConfig(cap=4096, batch_bytes=256, batch_deadline_ms=20.0))
    drv.run(0.5, drain=False)
    return sim, drv


@pytest.fixture(scope="module")
def donors():
    return {"jax": span_donor(JAX), "port": span_donor(PORT)}


@pytest.fixture(scope="module")
def loaded():
    return {"jax": mempool_cluster(JAX), "port": mempool_cluster(PORT)}


#: the metrics snapshot's gauges that the run's schedule does not fix: the
#: wall-clock ones (timings, rates, the verify seam's overlap shares) and
#: the hash-to-G1 cache's counters, which are process-wide (they count what
#: earlier tests in the same process hashed)
UNFIXED = re.compile(r"(_ms|_ms_per_round|_per_s|_per_sec|_seconds|_fraction)$|^hash_g1_cache_")


def differing(a, b):
    """What differs between two checkpoints' ``files`` (or any two values):
    nested by file name and key, for a failure message."""
    if isinstance(a, dict) and isinstance(b, dict):
        return {k: differing(a.get(k), b.get(k)) for k in sorted(set(a) | set(b))
                if a.get(k) != b.get(k)}
    if isinstance(a, bytes) and isinstance(b, bytes):
        return "bytes differ"
    return (a, b)


def files(path):
    """Every file of a checkpoint as bytes; the manifest as JSON with the
    ``UNFIXED`` gauges of its metrics taken out."""
    out = {}
    for name in sorted(os.listdir(path)):
        data = open(os.path.join(path, name), "rb").read()
        if name == "manifest.json":
            data = json.loads(data)
            data["metrics"] = {k: v for k, v in data["metrics"].items()
                               if not UNFIXED.search(k)}
        out[name] = data
    return out


def test_snapshot_blobs_byte_identical(donors):
    jd, td = donors["jax"].processes[0], donors["port"].processes[0]
    assert jd.round == td.round and sorted(jd.dag.vertices) == sorted(td.dag.vertices)
    assert tck.snapshot_bytes(td) == jck.snapshot_bytes(jd)
    blob = tck.attested_snapshot_bytes(td)
    assert blob.startswith(tck.SNAP_ATTEST_MAGIC) and blob == jck.attested_snapshot_bytes(jd)


@pytest.mark.parametrize("cell", ["span_donor", "mempool"])
def test_save_byte_identical_and_cross_restore(cell, donors, loaded, tmp_path):
    if cell == "span_donor":
        sims = {k: donors[k] for k in ("jax", "port")}
        pools = {"jax": None, "port": None}
    else:
        sims = {k: loaded[k][0] for k in ("jax", "port")}
        pools = {k: loaded[k][1].mempools[0] for k in ("jax", "port")}
    paths = {k: str(tmp_path / k) for k in ("jax", "port")}
    jck.save(sims["jax"].processes[0], paths["jax"], mempool=pools["jax"])
    tck.save(sims["port"].processes[0], paths["port"], mempool=pools["port"])
    got, want = files(paths["port"]), files(paths["jax"])
    assert got == want, differing(got, want)
    assert tck.latest_round(paths["port"]) == jck.latest_round(paths["jax"])

    # each file restores in each package to the same state: a process that
    # restored it saves the same bytes in both packages
    for src in ("jax", "port"):
        cfg = sims[src].cfg
        saved = {}
        for name, pkg in (("jax", JAX), ("port", PORT)):
            proc = pkg.Process(cfg, 0, pkg.Broker())
            mp = None if pools[name] is None else pkg.Mempool(pools[name].cfg)
            pkg.ck.restore(proc, paths[src], mempool=mp)
            assert (proc.round, proc.decided_wave) == (
                sims[src].processes[0].round, sims[src].processes[0].decided_wave)
            again = str(tmp_path / f"{src}-in-{name}")
            pkg.ck.save(proc, again, mempool=mp)
            saved[name] = files(again)
        assert saved["port"] == saved["jax"], differing(saved["port"], saved["jax"])


def p_restore(p, blob, kw):
    ck = tck if type(p).__module__.startswith("dag_rider_tpu_torch") else jck
    return ck.restore_from_snapshot(p, blob, **kw)


def _blobs(pkg, donor):
    """The accepted and the tampered blobs of ``tests/test_epoch_snapshot.py``."""
    ck = pkg.ck
    plain = ck.snapshot_bytes(donor)
    attested = ck.attested_snapshot_bytes(donor)
    spans = [donor._span_chain[e] for e in sorted(donor._span_chain)]
    bad = tuple(tuple(b"\x13" * 32 for _ in row) for row in spans[0].digests)
    forged_chain = ck.wrap_attested(plain, [dataclasses.replace(spans[0], digests=bad)] + spans[1:])
    victim = donor.dag.vertices_in_round(donor.dag.base_round + 1)[0]
    forged = dataclasses.replace(victim, block=pkg.Block((b"forged-payload",)),
                                 signature=victim.signature)
    del donor.dag.vertices[victim.id]
    donor.dag.vertices[forged.id] = forged
    try:
        forged_window = ck.attested_snapshot_bytes(donor)
        forged_plain = ck.snapshot_bytes(donor)
    finally:
        del donor.dag.vertices[forged.id]
        donor.dag.vertices[victim.id] = victim
    torn = attested[: len(ck.SNAP_ATTEST_MAGIC) + 4 + 2]
    (hlen,) = struct.unpack_from("<I", plain, 0)
    head = plain[4: 4 + hlen].replace(b'"n": 4', b'"n": 5')
    wrong_n = struct.pack("<I", len(head)) + head + plain[4 + hlen:]
    return {"attested": attested, "plain": plain, "forged_chain": forged_chain,
            "forged_window": forged_window, "forged_plain": forged_plain, "torn": torn,
            "wrong_n": wrong_n}


def test_snapshot_join_verdicts_equal_jax(donors):
    jsim, tsim = donors["jax"], donors["port"]
    jblobs = _blobs(JAX, jsim.processes[0])
    tblobs = _blobs(PORT, tsim.processes[0])
    assert tblobs == jblobs

    treg = tsim.processes[0].verifier.registry
    card = CUDAVerifier(treg, device="cpu")
    span = CertVerifier(treg, tsim.cfg.quorum, msm="host", device="cpu")
    assert span.pair == "device" and span.device.type == "cpu"
    jver = CPUVerifier(jsim.processes[0].verifier.registry)
    # (blob, how it is checked): through the span chain, through the
    # per-vertex signature seam alone, or with no check at all
    cases = [("attested", "spans"), ("attested", "sigs"), ("plain", "sigs"),
             ("forged_chain", "spans"), ("forged_window", "spans"), ("forged_plain", "sigs"),
             ("torn", "spans"), ("torn", "none"), ("wrong_n", "sigs")]

    def run(sim, blobs, verifier, span_verifier):
        out = []
        for name, how in cases:
            kw = {"spans": dict(span_verifier=span_verifier), "sigs": dict(verifier=verifier),
                  "none": {}}[how]
            p = type(sim.processes[0])(sim.cfg, 0, type(sim.transport)())
            ok = p_restore(p, blobs[name], kw)
            out.append((name, how, ok, p.dag.base_round, p.dag.max_round, p.round,
                        sorted((vid, v.digest()) for vid, v in p.dag.vertices.items()),
                        {k: p.metrics.counters.get(k, 0) for k in (
                            "snapshot_attest_rejects", "snapshot_pairing_checks",
                            "snapshot_spans_verified")}))
        return out

    got = run(tsim, tblobs, card, span)
    want = run(jsim, jblobs, jver, jsim.cert_verifier)
    assert got == want
    verdicts = {(name, how): ok for name, how, ok, *_ in got}
    assert verdicts == {("attested", "spans"): True, ("attested", "sigs"): True,
                        ("plain", "sigs"): True, ("forged_chain", "spans"): False,
                        ("forged_window", "spans"): False, ("forged_plain", "sigs"): False,
                        ("torn", "spans"): False, ("torn", "none"): False,
                        ("wrong_n", "sigs"): False}
    # the span path really paired, and the signature path really dispatched
    assert got[0][-1]["snapshot_pairing_checks"] > 0 and span.stats["pairing_checks"] > 0
    assert card.total_dispatches > 0
