"""The port's device multi-pairing against the JAX package, on the CPU.

``dag_rider_tpu_torch.ops.bls_pairing`` batches the 72 field products of
one Fp12 product into one ``field381.mul`` call and takes the cross-pair
product as a tree. The tower products must equal the JAX twins limb for
limb (every limb op is elementwise); the Miller product must equal the
JAX package's and the host oracle's after ``canonical`` (exactly: the
tree changes the association, not the element); and the certificate
verdicts through ``pair="device"`` must equal the host pairing's and the
JAX verifier's on the Byzantine matrix of ``tests/test_cert_phase2.py``.
Tolerance: none, every comparison is exact.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

from dag_rider_tpu.crypto import bls12381 as jbls
from dag_rider_tpu.ops import bls_pairing as J
from dag_rider_tpu.verifier.base import KeyRegistry as JKeyRegistry
from dag_rider_tpu.verifier.cert import CertVerifier as JCertVerifier
from dag_rider_tpu_torch.crypto import bls12381 as bls
from dag_rider_tpu_torch.ops import bls_pairing as T
from dag_rider_tpu_torch.verifier.base import CertSigner, KeyRegistry
from dag_rider_tpu_torch.verifier.cert import CertVerifier

CPU = torch.device("cpu")


def _limbs(rng, *shape):
    """Reduced-range limbs (|limb| < 2^12 + 2^7), signed."""
    return rng.integers(-(1 << 12), (1 << 12) + (1 << 7), shape, dtype=np.int32)


def _jax_fp2(x):
    return (jnp.asarray(x[..., 0, :]), jnp.asarray(x[..., 1, :]))


def _jax_fp6(x):
    return tuple(_jax_fp2(x[..., k, :, :]) for k in range(3))


@pytest.mark.parametrize("level", ["fp2", "fp6", "fp12"])
def test_tower_products_equal_jax_limb_for_limb(level):
    rng = np.random.default_rng({"fp2": 1, "fp6": 2, "fp12": 3}[level])
    if level == "fp2":
        x, y = _limbs(rng, 9, 2, 33), _limbs(rng, 9, 2, 33)
        got = T.fp2_mul(torch.from_numpy(x), torch.from_numpy(y)).numpy()
        w = J._fp2_mul(_jax_fp2(x), _jax_fp2(y))
        want = np.stack([np.asarray(c) for c in w], axis=-2)
    elif level == "fp6":
        x, y = _limbs(rng, 9, 3, 2, 33), _limbs(rng, 9, 3, 2, 33)
        got = T.fp6_mul(torch.from_numpy(x), torch.from_numpy(y)).numpy()
        w = J._fp6_mul(_jax_fp6(x), _jax_fp6(y))
        want = np.stack([np.stack([np.asarray(c) for c in e], axis=-2) for e in w], axis=-3)
    else:
        x, y = _limbs(rng, 9, 12, 33), _limbs(rng, 9, 12, 33)
        got = T.fp12_mul(torch.from_numpy(x), torch.from_numpy(y)).numpy()
        want = np.asarray(J._mul_packed_jit(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_array_equal(got, want)


def test_fp12_product_broadcasts_and_chunks_exactly(monkeypatch):
    rng = np.random.default_rng(4)
    x, y = _limbs(rng, 5, 3, 12, 33), _limbs(rng, 3, 12, 33)
    whole = T.fp12_mul(torch.from_numpy(x), torch.from_numpy(y))
    monkeypatch.setattr(T, "MUL_ROWS", 7)  # many chunks of one mul call
    chunked = T.fp12_mul(torch.from_numpy(x), torch.from_numpy(y))
    assert torch.equal(whole, chunked)
    want = np.asarray(J._mul_packed_jit(jnp.asarray(x), jnp.asarray(y[None])))
    np.testing.assert_array_equal(whole.numpy(), want)


def test_eval_lines_equal_jax():
    rng = np.random.default_rng(5)
    lam, c = _limbs(rng, 4, 3, 12, 33), _limbs(rng, 4, 3, 12, 33)
    xp, yp = _limbs(rng, 3, 33), _limbs(rng, 3, 33)
    want = np.asarray(J._eval_lines(*(jnp.asarray(a) for a in (lam, c, xp, yp))))
    got = T.eval_lines(*(torch.from_numpy(a) for a in (lam, c, xp, yp)))
    np.testing.assert_array_equal(got.numpy(), want)


def _pairs(n, seed):
    return [(bls.g1_mul(1000 + 7 * i + seed, bls.G1_GEN),
             bls.g2_mul(50 + 3 * i + seed, bls.G2_GEN)) for i in range(n)]


def test_slot_limbs_equal_jax():
    q = bls.g2_mul(77, bls.G2_GEN)
    dl, dc, al, ac = T._slot_limbs(q)
    jdl, jdc, jal, jac = J._slot_limbs(q)
    np.testing.assert_array_equal(dl, jdl)
    np.testing.assert_array_equal(dc, jdc)
    # the port keeps the addition lines of the addition steps only
    steps = list(T.ADD_STEPS)
    assert len(steps) == 5
    np.testing.assert_array_equal(al, np.asarray(jal)[steps])
    np.testing.assert_array_equal(ac, np.asarray(jac)[steps])
    assert T._slot_limbs(q)[0] is dl  # cached


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_miller_product_equals_jax(n):
    """The tree at odd and even counts: the same Fp12 element as the JAX
    chain and the host oracle's loop, limb for limb after canonical."""
    pairs = _pairs(n, n)
    got = T.miller_product(pairs, CPU)
    assert got == J.miller_product(pairs)
    assert got == T.host_miller_product(pairs)
    assert (bls.final_exponentiation(got) == bls.FP12_ONE) is bls.multi_pairing_check(pairs)


def test_miller_product_skips_identity_factors():
    pairs = _pairs(2, 9)
    assert T.miller_product([(None, pairs[0][1])] + pairs, CPU) == T.miller_product(pairs, CPU)
    assert T.miller_product([(None, None)], CPU) == bls.FP12_ONE
    assert T.multi_pairing_check([], CPU) is True


def test_walk_on_cpu_is_the_eager_walk():
    pairs = _pairs(3, 4)
    xp, yp, slots = T.marshal(pairs)
    dprod, aprod = T.line_products(xp, yp, slots, CPU)
    assert dprod.shape == (63, 12, 33) and aprod.shape == (5, 12, 33)
    assert torch.equal(T.walk_on_device(dprod, aprod), T.walk(dprod, aprod))


def test_vertical_slot_routes_to_host_and_is_counted(monkeypatch):
    pairs = _pairs(2, 11)
    vertical = pairs[1][1]
    real = T._slot_limbs
    monkeypatch.setattr(T, "_slot_limbs", lambda q: None if q == vertical else real(q))
    T.reset_host_routed()
    assert T.miller_product(pairs, CPU) is None
    assert T.multi_pairing_check(pairs, CPU) is bls.multi_pairing_check(pairs)
    assert T.HOST_ROUTED["checks"] == 1
    T.reset_host_routed()
    assert T.multi_pairing_check(pairs[:1], CPU) is bls.multi_pairing_check(pairs[:1])
    assert T.HOST_ROUTED["checks"] == 0


# --- the Byzantine certificate matrix (tests/test_cert_phase2.py:148-206) -------


@pytest.fixture(scope="module")
def keys():
    jreg, _, sks = JKeyRegistry.generate_with_cert(4)
    reg, _, port_sks = KeyRegistry.generate_with_cert(4)
    assert port_sks == sks
    return jreg, reg, sks


def _entries(sks, digests):
    return [(i, d, CertSigner(sk).sign_digest(d)) for i, (sk, d) in enumerate(zip(sks, digests))]


def _digests(tag: bytes, k: int = 4):
    return [bytes([i]) * 16 + tag.ljust(16, b".") for i in range(k)]


MUTATIONS = [
    lambda c: dataclasses.replace(c, signers=(0, 1, 3)),
    lambda c: dataclasses.replace(c, signers=(0, 1, 1)),
    lambda c: dataclasses.replace(c, signers=(0, 1, 9)),
    lambda c: dataclasses.replace(c, signers=(0, 1)),
    lambda c: dataclasses.replace(
        c, digests=(c.digests[0], b"stale-digest!".ljust(32, b"?"), c.digests[2])),
    lambda c: dataclasses.replace(c, agg_sig=jbls.g1_compress(jbls.g1_mul(0xBAD))),
    lambda c: dataclasses.replace(c, agg_sig=b"\xff" * 48),
]

CASES = ["full", "quorum_only"] + [f"mutation{i}" for i in range(len(MUTATIONS))]


@pytest.fixture(scope="module")
def matrix(keys):
    _, reg, sks = keys
    host = CertVerifier(reg, quorum=3, msm="host", pair="host")
    full = host.make_certificate(3, _entries(sks, _digests(b"byz")))
    quorum_only = host.make_certificate(4, _entries(sks, _digests(b"byq"))[:3])
    certs = [full, quorum_only] + [m(quorum_only) for m in MUTATIONS]
    return dict(zip(CASES, certs))


@pytest.mark.parametrize("case", CASES)
def test_device_pairing_verdicts_equal_host_and_jax(keys, matrix, case):
    """Fresh verifiers per case, so no memo carries a verdict across."""
    jreg, reg, _ = keys
    cert = matrix[case]
    dev = CertVerifier(reg, quorum=3, msm="host", pair="device", device="cpu")
    host = CertVerifier(reg, quorum=3, msm="host", pair="host")
    jax_host = JCertVerifier(jreg, quorum=3, pair="host")
    want = host.verify_certificate(cert)
    assert dev.verify_certificate(cert) is want
    assert jax_host.verify_certificate(cert) is want
    assert want is (case in ("full", "quorum_only"))
    assert dev.stats["pairing_checks"] == host.stats["pairing_checks"]
