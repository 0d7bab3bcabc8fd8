"""Port threshold coin and round certificates vs the JAX package, byte for byte.

The port's copies of ``crypto/threshold.py``, ``consensus/coin.py``,
``verifier/base.py`` (BLS keys, ``CertSigner``) and ``verifier/cert.py``
(``CertVerifier``), with the device MSM of ``ops/bls_msm.py`` run on the
CPU (``device="cpu"``: the plain torch path), against the JAX package's
host code:

- shares, group signatures and leaders are equal bytes;
- the JAX package's n = 4 ``Simulation`` with the port's ``ThresholdCoin``
  commits in the same order as with the JAX ``ThresholdCoin``, and the
  Byzantine-share run filters the same shares (the recipes of
  tests/test_coin_e2e.py);
- certificates carry equal aggregates and get equal verdicts on the
  tamper matrix of tests/test_cert.py.

Key material is carried across by building the port's objects from the
JAX objects' fields (plain ints and affine tuples).
"""

import dataclasses

import pytest
import torch

from dag_rider_tpu.config import Config
from dag_rider_tpu.consensus.coin import ThresholdCoin as JCoin
from dag_rider_tpu.consensus.simulator import Simulation
from dag_rider_tpu.crypto import bls12381 as jbls, threshold as jth
from dag_rider_tpu.verifier.base import CertSigner as JCertSigner
from dag_rider_tpu.verifier.base import KeyRegistry as JKeyRegistry
from dag_rider_tpu.verifier.cert import CertVerifier as JCertVerifier
from dag_rider_tpu_torch.consensus import coin as tcoin
from dag_rider_tpu_torch.consensus.coin import ThresholdCoin as TCoin
from dag_rider_tpu_torch.core.types import RoundCertificate
from dag_rider_tpu_torch.crypto import bls12381 as bls, threshold as th
from dag_rider_tpu_torch.ops import bls_msm, cuda_group381 as G
from dag_rider_tpu_torch.verifier.base import CertSigner, KeyRegistry
from dag_rider_tpu_torch.verifier.cert import CertVerifier


def cpu_msm(scalars, points):
    return bls_msm.msm(scalars, points, device="cpu")


def port_keys(jk):
    return th.ThresholdKeys(jk.threshold, jk.group_pk, jk.share_pks, jk.share_sks)


@pytest.fixture(scope="module")
def keys4():
    # n=4, f=1 -> (f+1)=2-of-4 threshold, as in tests/test_coin_e2e.py
    jk = jth.ThresholdKeys.generate(4, 2)
    return jk, port_keys(jk)


@pytest.fixture(autouse=True)
def _no_launches():
    G.reset_launches()
    yield
    assert G.LAUNCHES == {"padd381_xx": 0, "horner381": 0}, "a CPU tensor launched a kernel"


# --- threshold -------------------------------------------------------------


def test_shares_and_lagrange_equal_jax(keys4):
    jk, tk = keys4
    for i in range(4):
        share = th.sign_share(tk.share_sks[i], 3)
        assert share == jth.sign_share(jk.share_sks[i], 3)
        assert th.verify_share(tk.share_pks[i], 3, share)
    assert not th.verify_share(tk.share_pks[0], 4, th.sign_share(tk.share_sks[0], 3))
    assert th.lagrange_at_zero([1, 3, 4]) == jth.lagrange_at_zero([1, 3, 4])
    assert th.wave_tag(9) == jth.wave_tag(9)
    items = [(i, th.sign_share(tk.share_sks[i], 5)) for i in range(4)]
    assert th._rlc_coeffs(5, items) == jth._rlc_coeffs(5, items)


@pytest.mark.parametrize("bad", [(), (1,), (0, 2)])
def test_batch_verify_shares_with_port_msm_equals_jax(keys4, bad):
    """The RLC filter (one bad share: GT-defect localization; two: the
    bisection) keeps the same shares with the port's MSM."""
    jk, tk = keys4
    shares = {i: th.sign_share(tk.share_sks[i], 2) for i in range(4)}
    for i in bad:
        shares[i] = th.sign_share(tk.share_sks[i], 2 + 991)
    want = jth.batch_verify_shares(jk.share_pks, 2, shares)
    assert th.batch_verify_shares(tk.share_pks, 2, shares, msm=cpu_msm) == want
    assert sorted(want) == [i for i in range(4) if i not in bad]


# --- ThresholdCoin ---------------------------------------------------------


def test_coin_unit_path_equals_jax(keys4):
    """my_share / observe_share / ready / choose_leader, then a rotation
    and the GC floor, on both coins."""
    jk, tk = keys4
    jc = JCoin(jk, 1, 4)
    tc = TCoin(tk, 1, 4, msm=cpu_msm)
    assert tc.my_share(1) == jc.my_share(1)
    for coin in (jc, tc):
        coin.observe_share(1, 3, jth.sign_share(jk.share_sks[3], 1))
        coin.observe_share(1, 2, b"short")  # malformed: ignored
    assert not tc.ready(1) and not jc.ready(1)
    for coin in (jc, tc):
        coin.observe_share(1, 0, jth.sign_share(jk.share_sks[0], 1))
    assert tc.ready(1) and jc.ready(1)
    assert tc._sigma[1] == jc._sigma[1]
    assert tc.choose_leader(1) == jc.choose_leader(1)
    with pytest.raises(RuntimeError):
        tc.choose_leader(2)
    rotated = port_keys(jth.ThresholdKeys.generate(4, 2, seed=b"rotated"))
    tc.rotate(rotated, from_wave=3)
    assert tc._keys_for(2) is tk and tc._keys_for(3) is rotated
    assert tc.my_share(3) == th.sign_share(rotated.share_sks[1], 3)
    tc.prune_below(3)
    assert not tc._sigma and tc._schedule[0][1] is rotated


def test_keyless_coins_equal_jax():
    from dag_rider_tpu.consensus import coin as jcoin

    assert tcoin.FixedCoin(2).choose_leader(7) == jcoin.FixedCoin(2).choose_leader(7)
    rr, jrr = tcoin.RoundRobinCoin(4), jcoin.RoundRobinCoin(4)
    assert [rr.choose_leader(w) for w in range(9)] == [jrr.choose_leader(w) for w in range(9)]
    assert rr.ready(1) and rr.my_share(1) is None
    rr.observe_share(1, 0, b"x")
    rr.prune_below(5)
    rr.rotate(None, 3)


def _run_sim(coin_factory, blocks):
    cfg = Config(n=4, coin="threshold_bls", propose_empty=False)
    sim = Simulation(cfg, coin_factory=coin_factory)
    sim.submit_blocks(per_process=blocks)
    sim.run(max_messages=20_000)
    sim.check_agreement()
    return sim


def _logs(sim):
    return [
        [(v.id.round, v.id.source, v.digest()) for v in sim.deliveries[i]]
        for i in range(4)
    ]


def test_simulation_commit_order_with_port_coin(keys4):
    """tests/test_coin_e2e.py's n = 4 threshold-coin Simulation, with the
    port's coin combining shares on the plain torch MSM: the same
    (round, source, digest) log at every process, byte for byte, and the
    same group signature for every wave."""
    jk, tk = keys4
    jcoins, tcoins = {}, {}

    def jf(i):
        jcoins[i] = JCoin(jk, i, 4)
        return jcoins[i]

    def tf(i):
        tcoins[i] = TCoin(tk, i, 4, msm=cpu_msm)
        return tcoins[i]

    want = _run_sim(jf, blocks=12)
    got = _run_sim(tf, blocks=12)
    assert _logs(got) == _logs(want)
    assert all(len(log) > 4 for log in _logs(want)), "too little delivered"
    decided = [p.metrics.counters["waves_decided"] for p in got.processes]
    assert min(decided) >= 2, decided
    assert {i: c._sigma for i, c in tcoins.items()} == {i: c._sigma for i, c in jcoins.items()}


def test_byzantine_share_filtered_as_jax(keys4):
    """tests/test_coin_e2e.py:111: process 0 contributes corrupt shares;
    the batched filter of every coin discards the same shares as the JAX
    coin's, and the runs commit in the same order."""
    jk, tk = keys4

    class JByz(JCoin):
        def my_share(self, wave):
            return jth.sign_share(self.keys.share_sks[self.index], wave + 991)

    class TByz(TCoin):
        def my_share(self, wave):
            return th.sign_share(self.keys.share_sks[self.index], wave + 991)

    jcoins, tcoins = {}, {}

    def jf(i):
        jcoins[i] = (JByz if i == 0 else JCoin)(jk, i, 4)
        return jcoins[i]

    def tf(i):
        tcoins[i] = (TByz if i == 0 else TCoin)(tk, i, 4, msm=cpu_msm)
        return tcoins[i]

    want = _run_sim(jf, blocks=6)
    got = _run_sim(tf, blocks=6)
    assert _logs(got) == _logs(want)
    assert [tcoins[i].filtered for i in range(4)] == [jcoins[i].filtered for i in range(4)]
    assert sum(c.filtered for c in tcoins.values()) >= 1
    assert {i: c._shares for i, c in tcoins.items()} == {i: c._shares for i, c in jcoins.items()}


# --- round certificates ------------------------------------------------------


@pytest.fixture(scope="module")
def cert_keys():
    jreg, _seeds, jsks = JKeyRegistry.generate_with_cert(4)
    reg, _, sks = KeyRegistry.generate_with_cert(4)
    assert reg.public_keys == jreg.public_keys and sks == jsks
    assert reg.bls_public_keys == jreg.bls_public_keys
    return jreg, reg, sks


def _digests(tag: bytes, k: int = 4):
    return [bytes([i]) * 16 + tag.ljust(16, b".") for i in range(k)]


def _entries(sks, digests):
    return [
        (i, d, CertSigner(sk).sign_digest(d))
        for i, (sk, d) in enumerate(zip(sks, digests))
    ]


def test_cert_signer_bytes_equal_jax(cert_keys):
    _, _, sks = cert_keys
    digests = _digests(b"sig")
    for sk, d in zip(sks, digests):
        assert CertSigner(sk).sign_digest(d) == JCertSigner(sk).sign_digest(d)
        assert CertSigner(sk).sign_availability(d) == JCertSigner(sk).sign_availability(d)
    batched = CertSigner(sks[0]).sign_digests(digests)
    assert batched == JCertSigner(sks[0]).sign_digests(digests)
    assert batched == [CertSigner(sks[0]).sign_digest(d) for d in digests]
    assert bls.sign_many(sks, digests) == jbls.sign_many(sks, digests, backend="host")


@pytest.mark.parametrize("msm", ["host", "device"])
def test_certificate_agg_sig_equals_jax(cert_keys, msm):
    jreg, reg, sks = cert_keys
    entries = _entries(sks, _digests(b"agg"))
    want = JCertVerifier(jreg, quorum=3, msm="host").make_certificate(7, entries[::-1])
    cv = CertVerifier(reg, quorum=3, msm=msm, device="cpu")
    got = cv.make_certificate(7, entries[::-1])
    assert (got.round, got.signers, got.digests, got.agg_sig) == (
        want.round, want.signers, want.digests, want.agg_sig)
    assert got.signing_key() == want.signing_key()
    assert cv.verify_certificate(got) is True
    assert cv.verify_certificate(got) is True  # memo hit
    assert cv.stats == {"certs_checked": 2, "certs_valid": 1, "certs_invalid": 0,
                        "verdict_hits": 1, "pairing_checks": 1}


def test_certificate_refusals(cert_keys):
    jreg, reg, sks = cert_keys
    cv = CertVerifier(reg, quorum=3, msm="host")
    entries = _entries(sks, _digests(b"q"))
    assert cv.make_certificate(1, entries[:2]) is None  # below quorum
    bad = entries[:2] + [(2, entries[2][1], b"\xff" * 48)]
    assert cv.make_certificate(1, bad) is None  # malformed share
    with pytest.raises(ValueError):
        CertVerifier(KeyRegistry.generate(4)[0], quorum=3)
    with pytest.raises(ValueError):
        CertVerifier(reg, quorum=3, msm="sharded")


def test_cert_device_msm_without_card_raises(cert_keys, monkeypatch):
    _, reg, _ = cert_keys
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CertVerifier(reg, quorum=3, msm="device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CertVerifier(reg, quorum=3)  # the device MSM on cuda is the default
    assert CertVerifier(reg, quorum=3, msm="device", device="cpu").device.type == "cpu"


TAMPERS = [
    # bad bitmap: claims a signer that never signed
    lambda c: dataclasses.replace(c, signers=(0, 1, 3)),
    # bad bitmap: structurally broken lists
    lambda c: dataclasses.replace(c, signers=(0, 1, 1)),
    lambda c: dataclasses.replace(c, signers=(0, 1, 9)),
    lambda c: dataclasses.replace(c, signers=(0, 1)),
    # stale digests: one vertex substituted after aggregation
    lambda c: dataclasses.replace(
        c, digests=(c.digests[0], b"stale-digest!".ljust(32, b"?"), c.digests[2])
    ),
    # forged aggregate: a valid G1 point nobody's shares sum to
    lambda c: dataclasses.replace(c, agg_sig=jbls.g1_compress(jbls.g1_mul(0xBAD))),
    # malformed aggregate bytes
    lambda c: dataclasses.replace(c, agg_sig=b"\xff" * 48),
]


@pytest.mark.parametrize("tamper", range(len(TAMPERS)))
def test_tamper_matrix_verdicts_equal_jax(cert_keys, tamper):
    """tests/test_cert.py's Byzantine-certificate matrix: the same
    verdict (False) as the JAX verifier, no exception, and the good
    certificate's verdict survives."""
    jreg, reg, sks = cert_keys
    cv = CertVerifier(reg, quorum=3, msm="device", device="cpu")
    jcv = JCertVerifier(jreg, quorum=3)
    entries = _entries(sks, _digests(b"byz"))[:3]
    cert = cv.make_certificate(3, entries)
    jcert = jcv.make_certificate(3, entries)
    assert cv.verify_certificate(cert) is jcv.verify_certificate(jcert) is True
    forged, jforged = TAMPERS[tamper](cert), TAMPERS[tamper](jcert)
    assert isinstance(forged, RoundCertificate)
    assert cv.verify_certificate(forged) is jcv.verify_certificate(jforged) is False
    assert cv.stats["certs_invalid"] == 1
    assert cv.verify_certificate(cert) is True


def test_verify_many_equals_jax(cert_keys):
    jreg, reg, sks = cert_keys
    cv, jcv = CertVerifier(reg, quorum=3, msm="host"), JCertVerifier(jreg, quorum=3)
    certs = [cv.make_certificate(r, _entries(sks, _digests(bytes([r])))[:3]) for r in (1, 2)]
    forged = TAMPERS[5](certs[1])
    batch = [certs[0], forged, certs[1]]
    fired = []
    cv.on_certified = fired.append
    assert cv.verify_many(batch) == jcv.verify_many(batch) == [True, False, True]
    assert cv.verify_many(certs) == [True, True]
    assert fired == [certs[0], certs[1]]
