"""The device pairing and the device signing ladder on the card against
their CPU runs.

``ops/bls_pairing.py`` and ``ops/bls_g1.py`` are torch programs: the same
ops on CUDA tensors must give the same int32 limbs as on the CPU, and the
CUDA-graph replays (the pairing's schedule walk, the ladder's step) the
same limbs as the eager runs. Then the certificate verdicts through
``pair="device"`` and ``sign_many(backend="device")`` on the card. Every
comparison is exact.

These tests need a card and skip without one. They import no JAX:

    python -m pytest tests/test_torch_cuda_pairing.py -m cuda -p no:xdist --noconftest
"""

import dataclasses
import random

import pytest
import torch

from dag_rider_tpu_torch.crypto import bls12381 as bls
from dag_rider_tpu_torch.ops import bls_g1, bls_pairing as T, field381 as F
from dag_rider_tpu_torch.verifier.base import CertSigner, KeyRegistry
from dag_rider_tpu_torch.verifier.cert import CertVerifier

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m cuda")
    return torch.device("cuda")


def _pairs(n, seed):
    return [(bls.g1_mul(1000 + 7 * i + seed, bls.G1_GEN),
             bls.g2_mul(50 + 3 * i + seed, bls.G2_GEN)) for i in range(n)]


@pytest.mark.parametrize("n", [1, 5, 17])
def test_line_products_and_walk_equal_cpu(dev, n):
    xp, yp, slots = T.marshal(_pairs(n, n))
    d_cpu, a_cpu = T.line_products(xp, yp, slots, torch.device("cpu"))
    d_dev, a_dev = T.line_products(xp, yp, slots, dev)
    assert torch.equal(d_dev.cpu(), d_cpu) and torch.equal(a_dev.cpu(), a_cpu)
    want = T.walk(d_cpu, a_cpu)
    assert torch.equal(T.walk(d_dev, a_dev).cpu(), want)  # eager on the card
    assert torch.equal(T.walk_on_device(d_dev, a_dev).cpu(), want)  # graph replay
    assert torch.equal(T.walk_on_device(d_dev, a_dev).cpu(), want)  # replayed again


def test_miller_product_on_the_card_equals_host(dev):
    pairs = _pairs(6, 3)
    assert T.miller_product(pairs, dev) == T.host_miller_product(pairs)


def test_certificate_verdicts_on_the_card_equal_host(dev):
    reg, _, sks = KeyRegistry.generate_with_cert(4)
    digests = [bytes([i]) * 16 + b"cuda-byz".ljust(16, b".") for i in range(4)]
    entries = [(i, d, CertSigner(sk).sign_digest(d)) for i, (sk, d) in enumerate(zip(sks, digests))]
    host = CertVerifier(reg, quorum=3, msm="host", pair="host")
    cert = host.make_certificate(3, entries[:3])
    cases = [cert,
             dataclasses.replace(cert, digests=(cert.digests[0], b"x" * 32, cert.digests[2])),
             dataclasses.replace(cert, agg_sig=bls.g1_compress(bls.g1_mul(0xBAD)))]
    for c in cases:
        card = CertVerifier(reg, quorum=3)  # the defaults: MSM and pairing on the card
        assert (card.pair, card.device.type) == ("device", "cuda")
        assert card.verify_certificate(c) is CertVerifier(
            reg, quorum=3, msm="host", pair="host").verify_certificate(c)


def test_ladder_on_the_card_equals_cpu(dev):
    rng = random.Random(4)
    pts = [bls.g1_mul(rng.randrange(1, bls.R), bls.G1_GEN) for _ in range(5)]
    scalars = [rng.randrange(1, bls.R) * bls._H1_COFACTOR for _ in range(4)] + [bls.R + 2]
    bits, _ = bls_g1._bit_columns(scalars)
    px = torch.from_numpy(F.to_limbs_bulk([p[0] for p in pts]))
    py = torch.from_numpy(F.to_limbs_bulk([p[1] for p in pts]))
    want = bls_g1.ladder(px, py, torch.from_numpy(bits))
    b = torch.from_numpy(bits).to(dev)
    for graph in (False, True, True):
        got = bls_g1.ladder(px.to(dev), py.to(dev), b, graph=graph)
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    assert want[3].tolist() == [False] * 4 + [True]


def test_sign_many_device_lane_on_the_card(dev):
    rng = random.Random(9)
    sks = [rng.randrange(1, bls.R * 2) for _ in range(9)] + [bls.R, bls.R - 1]
    msgs = [bytes([rng.randrange(256) for _ in range(32)]) for _ in range(11)]
    want = [bls.sign(sk, m) for sk, m in zip(sks, msgs)]
    bls.reset_sign_host_rows()
    bls.hash_g1_cache_clear()
    assert bls.sign_many(sks, msgs, backend="device") == want
    assert bls.SIGN_HOST_ROWS == {"unavailable": 0, "resigned": 0}
