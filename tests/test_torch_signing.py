"""The port's BLS signing lanes against the JAX package and the oracle.

``ops/bls_g1.py`` (the ``device`` lane, here its torch ops on the CPU) and
``ops/native381.py`` (the ``native`` lane: ``csrc/native381.c`` built with
gcc into ``build/`` and bound with ctypes) against the JAX package's
``bls_g1`` on seeded rows, and ``sign_many`` on both lanes against
``sign``, byte for byte, over the signing fuzz of
``tests/test_cert_phase2.py:84-118``. The host routes that keep the lanes
exact are counted (``bls12381.SIGN_HOST_ROWS``, ``native381.HOST_ROWS``).
Tolerance: none, every comparison is exact.
"""

import random

import pytest

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

from dag_rider_tpu.ops import bls_g1 as J
from dag_rider_tpu_torch.crypto import bls12381 as bls
from dag_rider_tpu_torch.ops import bls_g1, native381
from dag_rider_tpu_torch.utils.build import BUILD_DIR
from dag_rider_tpu_torch.verifier.base import CertSigner, KeyRegistry


@pytest.fixture(autouse=True)
def counters():
    bls.reset_sign_host_rows()
    native381.reset_host_rows()
    yield


def _no_host_rows():
    assert bls.SIGN_HOST_ROWS == {"unavailable": 0, "resigned": 0}
    assert native381.HOST_ROWS == {"pow": 0, "ladder": 0}


@pytest.mark.parametrize("exp", ["sqrt", "inverse", "small"])
def test_pow_p_batch_equals_jax_and_native(exp):
    e = {"sqrt": (bls.P + 1) // 4, "inverse": bls.P - 2, "small": 5}[exp]
    rng = random.Random(len(exp))
    vals = [rng.randrange(bls.P) for _ in range(5)] + [0, 1, bls.P - 1]
    want = [pow(v, e, bls.P) for v in vals]
    assert bls_g1.pow_p_batch(vals, e, "cpu") == J.pow_p_batch(vals, e) == want
    assert native381.pow_p_batch(vals, e) == want
    _no_host_rows()


def _ladder_rows(seed):
    """Seeded rows: random r-order points under merged-size scalars, a
    zero scalar (the identity), a scalar of one bit, and r + 2 on the
    generator, whose ladder meets the base mid-way (H == 0: the device
    lane flags the row; the C ladder takes the doubling branch)."""
    rng = random.Random(seed)
    pts = [bls.g1_mul(rng.randrange(1, bls.R), bls.G1_GEN) for _ in range(4)]
    scalars = [rng.randrange(1, bls.R) * bls._H1_COFACTOR for _ in range(4)]
    return scalars + [0, 1, bls.R + 2], pts + [pts[0], pts[1], bls.G1_GEN]


@pytest.mark.parametrize("seed", [0, 1])
def test_g1_ladder_batch_equals_jax(seed):
    scalars, points = _ladder_rows(seed)
    got = bls_g1.g1_ladder_batch(scalars, points, "cpu")
    assert got == J.g1_ladder_batch(scalars, points)
    results, flags = got
    assert flags == [False] * 6 + [True]
    for s, p, res in list(zip(scalars, points, results))[:6]:
        assert res == bls.g1_mul(s, p)  # None for the identity


@pytest.mark.parametrize("seed", [0, 1])
def test_native_ladder_equals_oracle(seed):
    scalars, points = _ladder_rows(seed)
    results, flags = native381.g1_ladder_batch(scalars, points)
    assert flags == [False] * len(scalars)
    assert results == [bls.g1_mul(s, p) for s, p in zip(scalars, points)]
    _no_host_rows()


def test_native_library_builds_into_build_dir():
    assert native381.available()
    so = native381.library_path()
    assert so.parent == BUILD_DIR and so.exists()
    assert so.name.startswith("libdagrider_native381-")


def test_device_ladder_step_graph_flag_is_eager_on_cpu():
    """On CPU tensors the ladder runs eagerly whatever ``graph`` says."""
    import torch

    from dag_rider_tpu_torch.ops import field381 as F

    scalars, points = _ladder_rows(2)
    bits, _ = bls_g1._bit_columns(scalars)
    px = torch.from_numpy(F.to_limbs_bulk([p[0] for p in points]))
    py = torch.from_numpy(F.to_limbs_bulk([p[1] for p in points]))
    a = bls_g1.ladder(px, py, torch.from_numpy(bits), graph=True)
    b = bls_g1.ladder(px, py, torch.from_numpy(bits), graph=False)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# --- sign_many on both lanes (tests/test_cert_phase2.py:78-118) --------------------


def _sign_batch(rng, size):
    sks = [rng.randrange(1, bls.R * 2) for _ in range(size)]
    msgs = [bytes([rng.randrange(256) for _ in range(32)]) for _ in range(size)]
    return sks, msgs


@pytest.mark.parametrize("backend", ["native", "device"])
@pytest.mark.parametrize("seed", [0, 1])
def test_sign_many_matches_sequential(backend, seed):
    rng = random.Random(1000 + seed)
    for size in (1, 2, 7, 33):
        sks, msgs = _sign_batch(rng, size)
        want = [bls.sign(sk, m) for sk, m in zip(sks, msgs)]
        bls.hash_g1_cache_clear()  # every row runs the batched try-and-increment
        assert bls.sign_many(sks, msgs, backend=backend, device="cpu") == want
    _no_host_rows()


@pytest.mark.parametrize("backend", ["native", "device"])
def test_sign_many_edge_scalars_and_cache_hits(backend):
    # sk = 0 mod r -> the infinity encoding; repeated messages exercise
    # the hash-to-curve cache-hit path; a custom domain must be honored
    # on every internal route too
    sks = [bls.R, 5, 5, bls.R * 2, 7, bls.R - 1]
    msgs = [b"a" * 32, b"b" * 32, b"b" * 32, b"c" * 32, b"b" * 32, b"d" * 32]
    for domain in (b"dagrider-coin-v1", b"phase2-test-domain"):
        want = [bls.g1_compress(bls.g1_mul(sk, bls.hash_to_g1(m, domain)))
                for sk, m in zip(sks, msgs)]
        bls.hash_g1_cache_clear()
        assert bls.sign_many(sks, msgs, domain=domain, backend=backend, device="cpu") == want
    _no_host_rows()


def test_flagged_rows_are_resigned_on_the_host_and_counted():
    sks, msgs = _sign_batch(random.Random(7), 4)
    want = [bls.sign(sk, m) for sk, m in zip(sks, msgs)]

    def ladder(scalars, points):
        results, _ = native381.g1_ladder_batch(scalars, points)
        return results, [i == 1 for i in range(len(scalars))]

    assert bls._sign_many_via(native381.pow_p_batch, ladder, sks, msgs,
                              b"dagrider-coin-v1") == want
    assert bls.SIGN_HOST_ROWS["resigned"] == 1


def test_native_lane_without_its_library_signs_on_the_host_and_counts(monkeypatch):
    sks, msgs = _sign_batch(random.Random(8), 3)
    want = [bls.sign(sk, m) for sk, m in zip(sks, msgs)]
    monkeypatch.setattr(native381, "load", lambda: None)
    assert bls.sign_many(sks, msgs, backend="native") == want
    assert bls.SIGN_HOST_ROWS["unavailable"] == 3
    assert native381.pow_p_batch([4], 3) == [64]
    assert native381.g1_ladder_batch([3], [bls.G1_GEN]) == ([None], [True])
    assert native381.HOST_ROWS == {"pow": 1, "ladder": 1}


@pytest.mark.parametrize("lane", ["native", "device"])
def test_cert_signer_sign_digests_through_the_knob(monkeypatch, lane):
    _reg, _seeds, sks = KeyRegistry.generate_with_cert(4)
    signer = CertSigner(sks[0])
    digests = [bytes([i]) * 32 for i in range(5)]
    monkeypatch.setenv("DAGRIDER_CERT_SIGN", lane)
    if lane == "device":
        # the device lane defaults to the card: run it on the CPU here
        import functools

        monkeypatch.setattr(bls, "sign_many", functools.partial(bls.sign_many, device="cpu"))
    assert signer.sign_digests(digests) == [signer.sign_digest(d) for d in digests]
    _no_host_rows()
