"""Span certificates (cert-of-certs) in the port against the JAX package.

The span tests of ``tests/test_cert_phase2.py`` (:255-347, :384-439,
:471-526) run against the port's ``CertVerifier`` with its default
pairing lane (``pair="device"``, here the plain torch path on the CPU;
the span aggregate also through the card MSM's plain path),
and the port's ``Simulation`` with ``cert_span=2`` must commit the JAX
``Simulation``'s logs at n = 4, byte for byte, with the same span books.
The cluster runs aggregate with the host group law (``cert_msm="host"``;
the MSM's plain path is held to the JAX package in
``tests/test_torch_coin.py``) so that the pairing is what runs here.
"""

import dataclasses

import pytest

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

from dag_rider_tpu.config import Config as JConfig
from dag_rider_tpu.consensus.simulator import Simulation as JSimulation
from dag_rider_tpu.core.types import Block as JBlock
from dag_rider_tpu.verifier.base import KeyRegistry as JKeyRegistry
from dag_rider_tpu.verifier.cert import CertVerifier as JCertVerifier
from dag_rider_tpu_torch import Config
from dag_rider_tpu_torch.consensus.simulator import Simulation
from dag_rider_tpu_torch.core.types import Block, BroadcastMessage, SpanCertificate
from dag_rider_tpu_torch.crypto import bls12381 as bls
from dag_rider_tpu_torch.verifier.base import CertSigner, KeyRegistry
from dag_rider_tpu_torch.verifier.cert import CertVerifier


@pytest.fixture(scope="module")
def cert_keys():
    reg, _seeds, sks = KeyRegistry.generate_with_cert(4)
    return reg, sks


def _entries(sks, digests):
    return [(i, d, CertSigner(sk).sign_digest(d)) for i, (sk, d) in enumerate(zip(sks, digests))]


def _digests(tag: bytes, k: int = 4):
    return [bytes([i]) * 16 + tag.ljust(16, b".") for i in range(k)]


def _verifier(reg, msm="host"):
    """The port's default pairing lane on the plain torch path
    (``device="cpu"``); the MSM on the host unless asked for."""
    cv = CertVerifier(reg, quorum=3, msm=msm, device="cpu")
    assert cv.pair == "device"
    return cv


def _span_fixture(cert_keys, tag=b"sp", first=5, msm="host"):
    reg, sks = cert_keys
    cv = _verifier(reg, msm)
    certs = [
        cv.make_certificate(first + i, _entries(sks, _digests(tag + bytes([i])))[:3])
        for i in range(2)
    ]
    return cv, certs


def test_make_span_requires_gap_free_rounds(cert_keys):
    cv, certs = _span_fixture(cert_keys)
    span = cv.make_span(5, certs)
    assert span is not None
    assert span.first_round == 5 and span.last_round == 6
    assert cv.make_span(4, certs) is None  # wrong anchor
    assert cv.make_span(5, [certs[0], certs[0]]) is None  # gap/duplicate
    assert cv.make_span(5, []) is None


def test_make_span_equals_jax_and_host(cert_keys):
    """The span aggregate through the card MSM's plain path equals the
    JAX verifier's and the host group law's, byte for byte."""
    reg, sks = cert_keys
    jreg, _, jsks = JKeyRegistry.generate_with_cert(4)
    assert jsks == sks
    cv, certs = _span_fixture(cert_keys, tag=b"eq", msm="device")
    span = cv.make_span(5, certs)
    host = CertVerifier(reg, quorum=3, msm="host", pair="host").make_span(5, certs)
    jspan = JCertVerifier(jreg, quorum=3).make_span(5, certs)
    assert span == host
    assert (span.first_round, span.signers, span.digests, span.agg_sig) == (
        jspan.first_round, jspan.signers, jspan.digests, jspan.agg_sig)
    assert span.signing_key() == jspan.signing_key()


def test_verify_span_accepts_and_memoizes(cert_keys):
    cv, certs = _span_fixture(cert_keys, tag=b"sv")
    span = cv.make_span(5, certs)
    assert cv.verify_span(span) is True
    checks = cv.stats["pairing_checks"]
    assert cv.verify_span(span) is True
    assert cv.stats["pairing_checks"] == checks  # memo hit


def test_verify_span_combined_verdict_isolated_from_certs(cert_keys):
    cv, certs = _span_fixture(cert_keys, tag=b"si")
    span = cv.make_span(5, certs)
    assert cv.verify_span(span) is True
    checks = cv.stats["pairing_checks"]
    # the span verdict never stands in for a component cert's own
    assert cv.verify_certificate(certs[0]) is True
    assert cv.stats["pairing_checks"] == checks + 1


SPAN_MUTATIONS = [
    # forged combined aggregate
    lambda s: dataclasses.replace(s, agg_sig=bls.g1_compress(bls.g1_mul(0xBAD))),
    # malformed aggregate bytes
    lambda s: dataclasses.replace(s, agg_sig=b"\xff" * 48),
    # one round's digest substituted after folding
    lambda s: dataclasses.replace(
        s, digests=(s.digests[0], (b"swapped!".ljust(32, b"?"),) + s.digests[1][1:])),
    # inner round below quorum
    lambda s: dataclasses.replace(
        s, signers=(s.signers[0][:2], s.signers[1]), digests=(s.digests[0][:2], s.digests[1])),
    # unknown signer inside a round
    lambda s: dataclasses.replace(s, signers=(s.signers[0], (0, 1, 9))),
    # genesis anchor is not certifiable
    lambda s: dataclasses.replace(s, first_round=0),
]


@pytest.mark.parametrize("mutate", range(len(SPAN_MUTATIONS)))
def test_byzantine_span_always_detected(cert_keys, mutate):
    cv, certs = _span_fixture(cert_keys, tag=b"sb")
    span = cv.make_span(5, certs)
    assert cv.verify_span(span) is True
    forged = SPAN_MUTATIONS[mutate](span)
    assert cv.verify_span(forged) is False
    # the host pairing says the same on the same span
    reg, _ = cert_keys
    assert CertVerifier(reg, quorum=3, msm="host", pair="host").verify_span(forged) is False
    # a defect never poisons the good verdict
    assert cv.verify_span(span) is True


def test_span_replay_consumer_under_one_check_per_round(cert_keys):
    reg, sks = cert_keys
    maker = CertVerifier(reg, quorum=3, msm="host", pair="host")
    k, epochs = 4, 2
    certs = [
        maker.make_certificate(r, _entries(sks, _digests(b"rp" + bytes([r])))[:3])
        for r in range(1, k * epochs + 1)
    ]
    spans = [maker.make_span(e * k + 1, certs[e * k:(e + 1) * k]) for e in range(epochs)]
    consumer = _verifier(reg)
    assert all(consumer.verify_span(s) for s in spans)
    assert consumer.stats["pairing_checks"] == epochs < k * epochs
    for e, s in enumerate(spans):
        for i in range(k):
            assert s.signers[i] == certs[e * k + i].signers
            assert s.digests[i] == certs[e * k + i].digests


# --- end to end: the port's Simulation with spans against the JAX package's --------


def _run(pkg_sim, pkg_cfg, block, n, seed, *, cert, span=0, **kw):
    cfg = pkg_cfg(n=n, coin="round_robin", propose_empty=False, pump="vector",
                  cert_span=span, cert_selfcheck=True)
    sim = pkg_sim(cfg, verifier="cpu", cert=cert, **kw)
    for i in range(n):
        for k in range(6):
            sim.processes[i].submit(block((f"s{seed}-p{i}-b{k}".encode().ljust(32, b"."),)))
    sim.run(max_messages=400_000)
    sim.check_agreement()
    logs = [[(v.id.round, v.id.source, v.digest()) for v in sim.deliveries[i]]
            for i in range(n)]
    return logs, sim


SPAN_BOOKS = ("spans_assembled", "spans_verified", "span_rounds_settled", "certs_assembled",
              "sigs_saved", "certs_rejected", "spans_rejected")


def _books(sim):
    return {k: sum(p.metrics.counters.get(k, 0) for p in sim.processes) for k in SPAN_BOOKS}


@pytest.fixture(scope="module")
def port_span_sim():
    """The port's n = 4 span cluster (seed 0): certificate MSM on the host,
    pairing on the device lane's plain path."""
    return _run(Simulation, Config, Block, 4, 0, cert=True, span=2, cert_msm="host",
                device="cpu")


def test_span_commit_order_equals_jax(port_span_sim):
    """tests/test_cert_phase2.py:384-406 across the packages: the port's
    span run commits the JAX span run's logs, which equal the JAX per-round
    certificate and certificate-off runs; the span books are the same."""
    logs, sim = port_span_sim
    assert sim.cert_verifier.pair == "device"
    jlogs, jsim = _run(JSimulation, JConfig, JBlock, 4, 0, cert=True, span=2)
    cert_logs, _ = _run(JSimulation, JConfig, JBlock, 4, 0, cert=True, span=0)
    ref_logs, _ = _run(JSimulation, JConfig, JBlock, 4, 0, cert=False)
    assert any(ref_logs)
    assert logs == jlogs == cert_logs == ref_logs
    books = _books(sim)
    assert books == _books(jsim)
    assert books["spans_assembled"] > 0 and books["spans_verified"] > 0
    assert books["span_rounds_settled"] > 0 and books["certs_rejected"] == 0
    assert sim.cert_verifier.stats["pairing_checks"] == jsim.cert_verifier.stats["pairing_checks"]


def test_byzantine_span_rejected_without_degradation(port_span_sim):
    """tests/test_cert_phase2.py:471-500: a forged span from the wire is
    rejected by the combined check; no round degrades and the delivered
    prefix stays."""
    _, sim = port_span_sim
    p = sim.processes[1]
    k = 2
    first = ((p.round // k) + 2) * k + 1  # an epoch beyond the settled rounds
    forged = SpanCertificate(
        first_round=first,
        signers=((0, 1, 2), (0, 1, 2)),
        digests=(tuple(bytes([i]) * 32 for i in range(3)),
                 tuple(bytes([i + 8]) * 32 for i in range(3))),
        agg_sig=bls.g1_compress(bls.g1_mul(0xBAD)),
    )
    degraded = p.metrics.counters.get("cert_rounds_degraded", 0)
    rejected = p.metrics.counters.get("spans_rejected", 0)
    pre_log = list(p.delivered_log)
    p._on_span(BroadcastMessage(vertex=None, round=first + k - 1, sender=3,
                                kind="cert_span", span=forged))
    assert p.metrics.counters.get("spans_rejected", 0) == rejected + 1
    assert p.metrics.counters.get("cert_rounds_degraded", 0) == degraded
    assert p.delivered_log[:len(pre_log)] == pre_log


def test_span_for_settled_rounds_ignored(port_span_sim, cert_keys):
    """tests/test_cert_phase2.py:503-526: a span covering only settled
    rounds is dropped without a product check."""
    _, sim = port_span_sim
    p = sim.processes[2]
    settled = sorted(r for r in p._cert_done if (r - 1) % 2 == 0 and r + 1 in p._cert_done)
    assert settled, "the run settled no aligned epoch"
    first = settled[0]
    p._span_done.discard((first - 1) // 2)
    cv, certs = _span_fixture(cert_keys, tag=b"ig", first=first)
    span = cv.make_span(first, certs)
    checks = sim.cert_verifier.stats["pairing_checks"]
    ignored = p.metrics.counters.get("spans_ignored", 0)
    p._on_span(BroadcastMessage(vertex=None, round=first + 1, sender=3,
                                kind="cert_span", span=span))
    assert p.metrics.counters.get("spans_ignored", 0) == ignored + 1
    assert sim.cert_verifier.stats["pairing_checks"] == checks
