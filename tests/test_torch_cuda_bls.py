"""The BLS12-381 G1 addition kernel vs its plain torch version, on the card.

``cuda_group381.padd381_xx`` launches the hand-written sm_90a kernel of
``csrc/bls381_group.cu`` on CUDA tensors; the same inputs through
``padd381_xx_plain`` must give the same int32 limbs exactly. Widths are
the MSM's at n = 256: the first tree level of the coin's T = 128 MSM adds
64 * 128 / 2 = 4,096 lanes, the certificate's T = 256 MSM 8,192, and the
table steps 128 lanes. ``horner381`` (the Horner chain and the canonical
form in one launch) against its plain version on real and edge window
sums. Then the MSM on the card against the host group law, with its
launch counts, and the coin and certificate seams.

These tests need a card and skip without one. They import no JAX, so
they run on a machine without it:

    python -m pytest tests/test_torch_cuda_bls.py -m cuda -p no:xdist --noconftest
"""

import random

import numpy as np
import pytest
import torch

from dag_rider_tpu_torch.consensus.coin import ThresholdCoin
from dag_rider_tpu_torch.crypto import bls12381 as bls, threshold as th
from dag_rider_tpu_torch.ops import bls_msm, cuda_group381 as G, field381 as F
from dag_rider_tpu_torch.verifier.base import CertSigner, KeyRegistry
from dag_rider_tpu_torch.verifier.cert import CertVerifier

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m cuda")
    G.reset_launches()
    return torch.device("cuda")


def _operands(width, seed):
    """Limb-major [99, width] operand pair: real curve points (the
    identity, doublings and inverses among them) on the first lanes,
    random reduced limbs on the rest."""
    rng = np.random.default_rng(seed)
    p = rng.integers(-(1 << 7), 1 << 12, (G.ROWS, width)).astype(np.int32)
    q = rng.integers(-(1 << 7), 1 << 12, (G.ROWS, width)).astype(np.int32)
    pts = [bls.g1_mul(k) for k in (1, 2, 3, 5, 8)]
    real = [(pts[0], pts[0]), (pts[1], None), (pts[2], bls.g1_neg(pts[2])),
            (pts[3], pts[4]), (None, None)]
    for lane, (a, b) in enumerate(real[:width]):
        for arr, pt in ((p, a), (q, b)):
            if pt is None:
                arr[:, lane] = np.concatenate([F.ZERO, F.ONE, F.ZERO])
            else:
                arr[:, lane] = np.concatenate([F.to_limbs(pt[0]), F.to_limbs(pt[1]), F.ONE])
    return torch.from_numpy(p), torch.from_numpy(q)


@pytest.mark.parametrize("width", [1, 128, 4096, 8192, 65536])
def test_padd381_kernel_equals_plain(dev, width):
    p, q = _operands(width, width)
    got = G.padd381_xx(p.to(dev), q.to(dev))
    torch.cuda.synchronize()
    assert G.LAUNCHES["padd381_xx"] == 1
    assert torch.equal(got.cpu(), G.padd381_xx_plain(p, q))


def test_padd381_kernel_on_column_slices(dev):
    p, q = _operands(8192, 3)
    x = torch.cat([p, q], dim=1).to(dev)
    got = G.padd381_xx(x[:, :8192], x[:, 8192:])  # strided views, as in the tree
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), G.padd381_xx_plain(p, q))


def test_tree_sum_kernel_equals_plain_tree(dev):
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.integers(-(1 << 7), 1 << 12, (G.ROWS, 128 * 64)).astype(np.int32))
    got = G.tree_sum_xyz381(x.to(dev), 128)
    torch.cuda.synchronize()
    assert G.LAUNCHES["padd381_xx"] == 7
    assert torch.equal(got.cpu(), G.tree_sum_xyz381(x, 128))


@pytest.mark.parametrize("t, n, launches", [(128, 86, 22), (256, 171, 23)])
def test_msm_on_card_equals_host_and_plain(dev, t, n, launches):
    rng = random.Random(t)
    scalars = [rng.randrange(bls.R) for _ in range(n)]
    points = [bls.g1_mul(rng.randrange(1, bls.R)) for _ in range(n)]
    arrays = bls_msm.pack_inputs(scalars, points, t)
    got = bls_msm.msm_kernel(*(torch.from_numpy(a).to(dev) for a in arrays))
    torch.cuda.synchronize()
    assert G.LAUNCHES == {"padd381_xx": launches, "horner381": 1}
    G.reset_launches()
    plain = bls_msm.msm_kernel(*(torch.from_numpy(a) for a in arrays))
    for g, w in zip(got, plain):
        assert torch.equal(g.cpu(), w)
    assert bls_msm.unpack_point(*got) == bls.g1_msm(scalars, points)
    assert bls_msm.msm(scalars, points) == bls.g1_msm(scalars, points)
    assert bls_msm.sum_points(points) == bls.g1_sum(points)


def test_coin_and_certificate_on_card_equal_host(dev):
    keys = th.ThresholdKeys.generate(7, 3)
    shares = {i: th.sign_share(keys.share_sks[i], 1) for i in range(7)}
    shares[1] = th.sign_share(keys.share_sks[1], 992)  # a Byzantine share
    sigmas = []
    for msm in (bls_msm.msm, "host"):
        coin = ThresholdCoin(keys, 0, 7, msm=msm)
        for src, share in shares.items():
            coin.observe_share(1, src, share)
        assert coin.ready(1) and coin.filtered == 1
        sigmas.append((coin._sigma[1], coin.choose_leader(1)))
    assert sigmas[0] == sigmas[1]
    assert G.LAUNCHES["padd381_xx"] > 0

    reg, _, sks = KeyRegistry.generate_with_cert(5)
    digests = [bytes([i]) * 32 for i in range(5)]
    entries = [(i, d, CertSigner(sk).sign_digest(d)) for i, (sk, d) in enumerate(zip(sks, digests))]
    cv = CertVerifier(reg, quorum=4, msm="device")
    assert cv.device.type == "cuda"
    cert = cv.make_certificate(2, entries)
    host = CertVerifier(reg, quorum=4, msm="host")
    assert cert.agg_sig == host.make_certificate(2, entries).agg_sig
    assert cv.verify_certificate(cert) is True


def _window_sums(t, seed):
    """Real window sums [99, 64] of an MSM over t random points."""
    rng = random.Random(seed)
    scalars = [rng.randrange(bls.R) for _ in range(t)]
    points = [bls.g1_mul(rng.randrange(1, bls.R)) for _ in range(t)]
    nib, px, py, pz = (torch.from_numpy(a) for a in bls_msm.pack_inputs(scalars, points, t))
    return bls_msm.window_sums(nib, torch.cat([px, py, pz], dim=-1).t().contiguous())


def _edge_window_sums(kind):
    w = _window_sums(4, 3)
    if kind == "identity":
        w = torch.zeros_like(w)
        w[F.LIMBS] = 1
    elif kind == "all equal":
        w = w[:, :1].repeat(1, 64)
    else:  # X = 0 on every window
        w = w.clone()
        w[: F.LIMBS] = 0
    return w


@pytest.mark.parametrize("kind", ["real", "identity", "all equal", "x zero"])
def test_horner381_kernel_equals_plain(dev, kind):
    w = _window_sums(8, 7) if kind == "real" else _edge_window_sums(kind)
    raw, canon = G.horner381(w.to(dev))
    torch.cuda.synchronize()
    assert G.LAUNCHES == {"padd381_xx": 0, "horner381": 1}
    want_raw, want_canon = G.horner381_plain(w)
    assert torch.equal(raw.cpu(), want_raw)
    assert torch.equal(canon.cpu(), want_canon)


def test_horner381_kernel_on_strided_window_sums(dev):
    w = _window_sums(8, 8)
    wide = torch.cat([w, w], dim=1).to(dev)
    raw, canon = G.horner381(wide[:, 64:])  # row stride 128
    torch.cuda.synchronize()
    want_raw, want_canon = G.horner381_plain(w)
    assert torch.equal(raw.cpu(), want_raw) and torch.equal(canon.cpu(), want_canon)
