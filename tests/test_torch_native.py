"""The port's native challenge batch vs hashlib and the JAX package.

The recipes of tests/test_native.py against the port's
``dag_rider_tpu_torch.utils.native``: the challenge scalars
SHA-512(R || A || M) mod L of the C++ batch are byte-identical to hashlib
(extreme digests included), and ``CUDAVerifier`` gives the same masks with
``DAGRIDER_NATIVE`` on and off (the recipe's masks). The library is
built from the port's own source into the repository's ``build/``
directory, never into the JAX package, and a missing toolchain leaves the
hashlib route.
"""

import dataclasses
import hashlib
from pathlib import Path

import numpy as np
import pytest

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

from dag_rider_tpu.core.types import Block, Vertex, VertexID
from dag_rider_tpu.verifier.base import KeyRegistry as JKeyRegistry
from dag_rider_tpu.verifier.base import VertexSigner as JSigner
from dag_rider_tpu_torch.crypto import ed25519
from dag_rider_tpu_torch.utils import native
from dag_rider_tpu_torch.verifier.base import KeyRegistry
from dag_rider_tpu_torch.verifier.cuda import CUDAVerifier

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def lib():
    lib = native.load()
    assert lib is not None, "g++ could not build csrc/challenge.cpp"
    return lib


def _hashlib_k(r: bytes, pk: bytes, msg: bytes) -> bytes:
    k = int.from_bytes(hashlib.sha512(r + pk + msg).digest(), "little") % ed25519.L
    return k.to_bytes(32, "little")


def test_challenge_batch_matches_hashlib(lib):
    rng = np.random.default_rng(0)
    n = 300
    rs = rng.integers(0, 256, size=(n, 32)).astype(np.uint8)
    pks = rng.integers(0, 256, size=(n, 32)).astype(np.uint8)
    msgs = [
        rng.integers(0, 256, size=int(ln)).astype(np.uint8).tobytes()
        for ln in rng.integers(0, 400, size=n)
    ]
    out = native.challenge_batch(rs, pks, msgs)
    for i in range(n):
        assert out[i].tobytes() == _hashlib_k(rs[i].tobytes(), pks[i].tobytes(), msgs[i]), i
    # both routes of challenges() give these bytes
    assert np.array_equal(native.challenges(rs, pks, msgs, use_native=False), out)
    assert np.array_equal(native.challenges(rs, pks, msgs, use_native=True), out)


def test_challenge_batch_extreme_digests(lib):
    """Rows near the reduction's edge: all-0xFF inputs, empty messages."""
    rs = np.full((4, 32), 0xFF, dtype=np.uint8)
    pks = np.full((4, 32), 0xFF, dtype=np.uint8)
    msgs = [b"", b"\xff" * 500, b"\x00", b"x" * 127]
    out = native.challenge_batch(rs, pks, msgs)
    for i in range(4):
        assert out[i].tobytes() == _hashlib_k(rs[i].tobytes(), pks[i].tobytes(), msgs[i])


def test_verifier_masks_identical_native_on_off(lib, monkeypatch):
    jreg, seeds = JKeyRegistry.generate(4)
    signers = [JSigner(s) for s in seeds]
    vs = []
    for i in range(4):
        v = Vertex(
            id=VertexID(1, i),
            block=Block((f"tx{i}".encode(),)),
            strong_edges=(VertexID(0, 0), VertexID(0, 1), VertexID(0, 2)),
        )
        vs.append(signers[i].sign_vertex(v))
    vs.append(dataclasses.replace(vs[1], signature=b"\x11" * 64))
    ver = CUDAVerifier(KeyRegistry(jreg.public_keys), device="cpu")
    masks, arrays = {}, {}
    for flag, route in (("1", "native"), ("0", "hashlib")):
        monkeypatch.setenv("DAGRIDER_NATIVE", flag)
        before = dict(native.ROWS_HASHED)
        masks[flag] = ver.verify_batch(vs)
        arrays[flag] = ver.prepare_batch(vs)
        other = "hashlib" if route == "native" else "native"
        # 4 prevalid rows (the 0x11 signature's s is >= L), twice
        assert native.ROWS_HASHED[route] - before[route] == 8
        assert native.ROWS_HASHED[other] == before[other]
    assert masks["1"] == masks["0"] == [True, True, True, True, False]
    for a, b in zip(arrays["1"], arrays["0"]):
        assert a.tobytes() == b.tobytes()


def test_library_builds_under_build_never_in_jax_package(lib, monkeypatch):
    """A cold load (flags no earlier build used, so a new file name)
    compiles the port's source into the repository's build/ directory;
    the JAX package's native/ directory is untouched."""
    jax_native = ROOT / "dag_rider_tpu" / "native"
    before = {p.name: p.stat().st_mtime_ns for p in jax_native.iterdir()}
    monkeypatch.setattr(native, "GXX_FLAGS", [*native.GXX_FLAGS, "-DDAGRIDER_COLD_BUILD"])
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    so = native.library_path()
    so.unlink(missing_ok=True)
    try:
        assert native.load() is not None
        assert so.exists() and so.parent == ROOT / "build"
        assert native.last_build_s > 0
    finally:
        so.unlink(missing_ok=True)
    assert native.SRC == ROOT / "dag_rider_tpu_torch" / "csrc" / "challenge.cpp"
    assert {p.name: p.stat().st_mtime_ns for p in jax_native.iterdir()} == before


def test_missing_toolchain_takes_hashlib_route(monkeypatch, tmp_path):
    """No g++ and no cached build: load() returns None, and challenges()
    hashes on the hashlib route with the same bytes."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setenv("PATH", str(tmp_path))
    assert native.load() is None
    rs = np.arange(64, dtype=np.uint8).reshape(2, 32)
    before = dict(native.ROWS_HASHED)
    out = native.challenges(rs, rs[::-1], [b"a", b""], use_native=True)
    assert native.ROWS_HASHED["hashlib"] - before["hashlib"] == 2
    assert native.ROWS_HASHED["native"] == before["native"]
    assert out[1].tobytes() == _hashlib_k(rs[1].tobytes(), rs[0].tobytes(), b"")
