"""The port reads every verify and certificate knob where the reference does.

One case per row of the knob table: each knob either takes the port's real
branch (``DAGRIDER_COMB``, ``DAGRIDER_COMB_BITS``, ``DAGRIDER_PREP_WORKERS``,
``DAGRIDER_NATIVE``, ``DAGRIDER_CERT_SIGN``, ``DAGRIDER_CERT_PAIR``,
``DAGRIDER_CERT_MSM``'s "sharded" value, ``DAGRIDER_MESH``) or, where the
port has no such branch, raises — never a quiet fall-through to another
route (``DAGRIDER_SHARDED_COMB_IMPL`` names JAX implementations). The seams
that once raised for an unported module (lanes, the mempool, DKG
rotation) now build what the reference builds.
"""

import warnings


import pytest

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

from dag_rider_tpu_torch import Config
from dag_rider_tpu_torch.consensus.simulator import Simulation
from dag_rider_tpu_torch.core.types import Block, Vertex, VertexID
from dag_rider_tpu_torch.crypto import bls12381 as bls
from dag_rider_tpu_torch.epoch.manager import derive_epoch_keys
from dag_rider_tpu_torch.parallel import mesh as M
from dag_rider_tpu_torch.parallel.sharded_verifier import ShardedCUDAVerifier
from dag_rider_tpu_torch.utils import native
from dag_rider_tpu_torch.verifier.base import KeyRegistry, VertexSigner
from dag_rider_tpu_torch.verifier.cert import CertVerifier
from dag_rider_tpu_torch.verifier.cuda import CUDAVerifier


@pytest.fixture(scope="module")
def reg():
    return KeyRegistry.generate(4)[0]


@pytest.fixture(scope="module")
def cert_reg():
    return KeyRegistry.generate_with_cert(4)[0]


# -- DAGRIDER_COMB / comb= ------------------------------------------------


def test_comb_off_raises_naming_the_windowed_path(reg, monkeypatch):
    """comb=False and DAGRIDER_COMB=0 select the windowed path: its nine
    prep arrays, no staging, no warmup."""
    v = CUDAVerifier(reg, comb=False, device="cpu")
    assert not v._comb and len(v.prepare_batch([])) == 9 and v.warmup() == 0.0
    monkeypatch.setenv("DAGRIDER_COMB", "0")
    assert len(CUDAVerifier(reg, device="cpu").prepare_batch([])) == 9
    # the explicit argument beats the knob
    assert CUDAVerifier(reg, comb=True, device="cpu").u8_cols == 131


# -- DAGRIDER_COMB_BITS -----------------------------------------------------


@pytest.mark.parametrize("bits, cols", [("", 131), ("4", 131), ("8", 67)])
def test_comb_bits_selects_the_layout(reg, monkeypatch, bits, cols):
    monkeypatch.setenv("DAGRIDER_COMB_BITS", bits)
    v = CUDAVerifier(reg, device="cpu")
    u8, i32 = v.prepare_batch([])
    assert v.u8_cols == cols and u8.shape == (16, cols) and i32.shape == (16, 23)


def test_comb_bits_rejects_other_widths(reg, monkeypatch):
    monkeypatch.setenv("DAGRIDER_COMB_BITS", "16")
    with pytest.raises(ValueError, match="DAGRIDER_COMB_BITS"):
        CUDAVerifier(reg, device="cpu")


# -- DAGRIDER_PREP_WORKERS / DAGRIDER_NATIVE --------------------------------


def test_prep_workers_knob_sizes_the_engine(reg, monkeypatch):
    monkeypatch.setenv("DAGRIDER_PREP_WORKERS", "3")
    v = CUDAVerifier(reg, device="cpu")
    assert v.prep_stats()["workers"] == 3
    v.prep_workers = 1  # the attribute beats the knob
    assert v.prep_stats()["workers"] == 1


@pytest.mark.parametrize("flag, route", [("1", "native"), ("0", "hashlib")])
def test_native_knob_picks_the_hash_route(monkeypatch, flag, route):
    reg, seeds = KeyRegistry.generate(2)
    vs = [
        VertexSigner(seeds[i]).sign_vertex(
            Vertex(id=VertexID(1, i), block=Block((b"k",)), strong_edges=(VertexID(0, 0),))
        )
        for i in range(2)
    ]
    monkeypatch.setenv("DAGRIDER_NATIVE", flag)
    before = dict(native.ROWS_HASHED)
    CUDAVerifier(reg, device="cpu").prepare_batch(vs)
    other = "hashlib" if route == "native" else "native"
    assert native.ROWS_HASHED[route] - before[route] == 2
    assert native.ROWS_HASHED[other] == before[other]


# -- DAGRIDER_CERT_SIGN / sign_many(backend=) -------------------------------


SKS = [3, 5, 0, bls.R - 1]
MSGS = [b"a", b"wave-7", b"", b"x" * 100]


def test_sign_many_host_backend_equals_sign(monkeypatch):
    want = [bls.sign(sk, m) for sk, m in zip(SKS, MSGS)]
    assert bls.sign_many(SKS, MSGS, backend="host") == want
    assert bls.sign_many(SKS, MSGS) == want  # the knob's default is host
    monkeypatch.setenv("DAGRIDER_CERT_SIGN", "device")
    assert bls.sign_many(SKS, MSGS, backend="host") == want  # argument beats knob


@pytest.mark.parametrize("backend", ["native", "device"])
def test_sign_many_lane_backends_equal_sign(monkeypatch, backend):
    """Each lane, by argument and by knob, signs the bytes of ``sign``;
    the device lane runs on the card unless the caller passes "cpu", and
    without a card it raises instead of signing elsewhere."""
    want = [bls.sign(sk, m) for sk, m in zip(SKS, MSGS)]
    bls.reset_sign_host_rows()
    assert bls.sign_many(SKS, MSGS, backend=backend, device="cpu") == want
    monkeypatch.setenv("DAGRIDER_CERT_SIGN", backend)
    if backend == "device":
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bls.sign_many(SKS, MSGS)
        assert bls.sign_many(SKS, MSGS, device="cpu") == want
    else:
        assert bls.sign_many(SKS, MSGS) == want
    assert bls.sign_many(SKS, MSGS, backend="host") == want  # argument beats knob
    assert bls.SIGN_HOST_ROWS == {"unavailable": 0, "resigned": 0}


def test_sign_many_rejects_unknown_backend():
    with pytest.raises(ValueError, match="sign_many backend"):
        bls.sign_many(SKS, MSGS, backend="gpu")


# -- DAGRIDER_CERT_PAIR / CertVerifier(pair=) ------------------------------


def test_cert_pair_knob_then_device_default(cert_reg, monkeypatch):
    """pair=None pairs on the device unless DAGRIDER_CERT_PAIR says
    otherwise; the argument beats the knob; the device lane runs on the
    card unless the caller passes "cpu", and without a card it raises."""
    monkeypatch.delenv("DAGRIDER_CERT_PAIR", raising=False)
    cv = CertVerifier(cert_reg, 3, msm="host", device="cpu")
    assert (cv.pair, cv.device.type) == ("device", "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CertVerifier(cert_reg, 3, msm="host")
    monkeypatch.setenv("DAGRIDER_CERT_PAIR", "host")
    cv = CertVerifier(cert_reg, 3, msm="host")
    assert (cv.pair, cv.device) == ("host", None)  # honoured over the default
    assert CertVerifier(cert_reg, 3, msm="host", pair="device", device="cpu").pair == "device"
    monkeypatch.setenv("DAGRIDER_CERT_PAIR", "device")
    assert CertVerifier(cert_reg, 3, msm="host", device="cpu").pair == "device"
    assert CertVerifier(cert_reg, 3, msm="host", pair="host").pair == "host"
    with pytest.raises(ValueError, match="cert pairing"):
        CertVerifier(cert_reg, 3, msm="host", pair="gpu")


# -- the seams that named Queue 1 items 6 and 8 now work ----------------------


def test_unported_seams_name_their_item():
    """The three seams that raised until their modules were ported (the
    lanes, the mempool, DKG) now build what the reference builds."""
    from dag_rider_tpu_torch.epoch.manager import EpochTransition
    from dag_rider_tpu_torch.mempool import Mempool
    from dag_rider_tpu_torch.transport.lanebus import LaneBus

    sim = Simulation(Config(n=4, coin="round_robin", lanes=True))
    assert isinstance(sim.lane_bus, LaneBus)
    assert all(p.lanes is not None for p in sim.processes)
    mps = Simulation(Config(n=4, coin="round_robin")).attach_mempools()
    assert len(mps) == 4 and all(isinstance(mp, Mempool) for mp in mps)
    keys = derive_epoch_keys(EpochTransition(1, 4, b"s" * 32, ()), 4, 2, "dkg", 0)
    assert keys is not None and keys.threshold == 2 and len(keys.share_pks) == 4


# -- DAGRIDER_MESH / DAGRIDER_SHARDED_COMB_IMPL -------------------------------


def test_mesh_knob_sizes_and_clamps(monkeypatch):
    """DAGRIDER_MESH is read in mesh_from_env: a CPU mesh takes it as
    given (8 when unset); on the card a request above the visible count
    clamps to it with the reference's warning."""
    monkeypatch.delenv("DAGRIDER_MESH", raising=False)
    assert M.mesh_from_env("cpu").size == 8
    monkeypatch.setenv("DAGRIDER_MESH", "3")
    assert M.mesh_from_env("cpu").size == 3
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.mesh_from_env()
    monkeypatch.setattr(M.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(M.torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("DAGRIDER_MESH", "4")
    with pytest.warns(UserWarning, match="DAGRIDER_MESH=4 but only 1 device"):
        mesh = M.mesh_from_env()
    assert mesh.devices == (M.torch.device("cuda", 0),) and not mesh.virtual
    monkeypatch.delenv("DAGRIDER_MESH")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert M.mesh_from_env().size == 1


def test_sharded_comb_impl_knob_raises_for_jax_names(reg, monkeypatch):
    mesh = M.make_mesh(2, device="cpu")
    monkeypatch.setenv("DAGRIDER_SHARDED_COMB_IMPL", "")
    assert ShardedCUDAVerifier(reg, mesh, comb=False).mesh_devices == 2
    for impl in ("jnp", "pallas", "pallas_interpret"):
        monkeypatch.setenv("DAGRIDER_SHARDED_COMB_IMPL", impl)
        with pytest.raises(ValueError, match="DAGRIDER_SHARDED_COMB_IMPL"):
            ShardedCUDAVerifier(reg, mesh)


# -- CertVerifier(msm="sharded") ----------------------------------------------


def test_cert_msm_sharded_gives_the_host_bytes(cert_reg):
    """msm="sharded" sums the certificate on the mesh (8 CPU entries
    here): the bytes of msm="host" and msm="device"; Simulation passes
    cert_msm through."""
    from dag_rider_tpu_torch.verifier.base import CertSigner

    _, _, sks = KeyRegistry.generate_with_cert(4)
    entries = [(i, bytes([i]) * 32, CertSigner(sks[i]).sign_digest(bytes([i]) * 32))
               for i in range(3)]
    certs = {m: CertVerifier(cert_reg, 3, msm=m, pair="host", device="cpu").make_certificate(
        5, entries) for m in ("host", "device", "sharded")}
    assert certs["sharded"] == certs["host"] == certs["device"] is not None
    sim = Simulation(Config(n=4, coin="round_robin"), verifier="cpu", cert=True,
                     cert_msm="sharded", cert_pair="host", device="cpu")
    assert (sim.cert_verifier.msm, sim.cert_verifier.device.type) == ("sharded", "cpu")
    with pytest.raises(ValueError, match='"host", "device" or "sharded"'):
        CertVerifier(cert_reg, 3, msm="gpu", device="cpu")
