"""The port reads every verify and certificate knob where the reference does.

One case per row of the knob table: each knob either takes the port's real
branch (``DAGRIDER_COMB``, ``DAGRIDER_COMB_BITS``, ``DAGRIDER_PREP_WORKERS``,
``DAGRIDER_NATIVE``, ``DAGRIDER_CERT_SIGN``, ``DAGRIDER_CERT_PAIR``,
``DAGRIDER_CERT_MSM`` with each of its values, ``DAGRIDER_MESH``) or, where
the port has no such branch, raises — never a quiet fall-through to another
route (``DAGRIDER_SHARDED_COMB_IMPL`` names JAX implementations,
``DAGRIDER_PALLAS_GROUP=0`` and ``DAGRIDER_MSM_PALLAS=0`` a plain route on the
card). ``CertVerifier(msm="sharded")`` as an argument is a case of its own.
A scan of the whole port holds every registered knob to that rule. The seams
that once raised for an unported module (lanes, the mempool, DKG rotation)
now build what the reference builds, and the package surfaces re-export
the reference's names.
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


# -- DAGRIDER_CERT_MSM / CertVerifier(msm=None) ------------------------------


@pytest.mark.parametrize("value", ["host", "device", "sharded"])
def test_cert_msm_knob_is_read(cert_reg, monkeypatch, value):
    """msm=None reads DAGRIDER_CERT_MSM when it is set (each value); the
    argument beats the knob."""
    monkeypatch.setenv("DAGRIDER_CERT_MSM", value)
    assert CertVerifier(cert_reg, 3, pair="host", device="cpu").msm == value
    other = "device" if value == "host" else "host"
    assert CertVerifier(cert_reg, 3, msm=other, pair="host", device="cpu").msm == other
    monkeypatch.setenv("DAGRIDER_CERT_MSM", "gpu")
    with pytest.raises(ValueError, match="DAGRIDER_CERT_MSM"):
        CertVerifier(cert_reg, 3, pair="host", device="cpu")


def test_cert_msm_knob_unset_is_device_and_simulation_passes_none(cert_reg, monkeypatch):
    """Unset, msm=None is "device"; Simulation(cert_msm=None) hands None to
    CertVerifier, so the knob reaches the cluster's certificate verifier."""
    monkeypatch.delenv("DAGRIDER_CERT_MSM", raising=False)
    assert CertVerifier(cert_reg, 3, pair="host", device="cpu").msm == "device"

    def sim_msm():
        sim = Simulation(Config(n=4, coin="round_robin"), verifier="cpu", cert=True,
                         cert_pair="host", device="cpu")
        return sim.cert_verifier.msm

    assert sim_msm() == "device"
    monkeypatch.setenv("DAGRIDER_CERT_MSM", "host")
    assert sim_msm() == "host"
    monkeypatch.setenv("DAGRIDER_CERT_MSM", "sharded")
    assert sim_msm() == "sharded"


# -- DAGRIDER_PALLAS_GROUP / DAGRIDER_MSM_PALLAS ------------------------------


@pytest.mark.parametrize("value", ["0", "1", None])
def test_pallas_group_knob_zero_raises(reg, monkeypatch, value):
    """0 asked the reference for its jnp group ops on a TPU; the port has
    no plain route on the card (the device of the tensors decides), so 0
    raises naming the knob and the rule; 1 (the default) changes nothing."""
    if value is None:
        monkeypatch.delenv("DAGRIDER_PALLAS_GROUP", raising=False)
    else:
        monkeypatch.setenv("DAGRIDER_PALLAS_GROUP", value)
    if value == "0":
        with pytest.raises(ValueError, match="DAGRIDER_PALLAS_GROUP=0.*device of the tensors"):
            CUDAVerifier(reg, device="cpu")
        with pytest.raises(ValueError, match="DAGRIDER_PALLAS_GROUP"):
            ShardedCUDAVerifier(reg, M.make_mesh(2, device="cpu"), comb=False)
    else:
        assert CUDAVerifier(reg, device="cpu").u8_cols == 131


@pytest.mark.parametrize("value", ["0", "1", None])
def test_msm_pallas_knob_zero_raises(monkeypatch, value):
    """As DAGRIDER_PALLAS_GROUP, for the G1 MSM: ``bls_msm.msm`` (the
    counterpart of the reference's ``msm_impl``) and ``ShardedMSM``."""
    from dag_rider_tpu_torch.ops import bls_msm
    from dag_rider_tpu_torch.parallel.msm import ShardedMSM

    if value is None:
        monkeypatch.delenv("DAGRIDER_MSM_PALLAS", raising=False)
    else:
        monkeypatch.setenv("DAGRIDER_MSM_PALLAS", value)
    g = bls.G1_GEN
    if value == "0":
        with pytest.raises(ValueError, match="DAGRIDER_MSM_PALLAS=0.*device of the tensors"):
            bls_msm.msm([1], [g], device="cpu")
        with pytest.raises(ValueError, match="DAGRIDER_MSM_PALLAS"):
            ShardedMSM(M.make_mesh(2, device="cpu")).window_partials([1], [g])
    else:
        assert bls_msm.check_msm_knob() is None


# -- every registered knob is read or refused ---------------------------------


def _string_constants(path):
    import ast

    return [n for n in ast.walk(ast.parse(path.read_text(), filename=str(path)))
            if isinstance(n, ast.Constant) and isinstance(n.value, str)]


def _knob_reads_and_refusals(pkg):
    """(knobs passed as literals to a config accessor, knobs named in a
    ``raise``) over every module of ``pkg``."""
    import ast

    accessors = {"env_flag", "env_str", "env_choice", "env_int", "env_opt_int",
                 "env_float", "env_is_set"}
    read, refused = set(), set()
    for path in pkg.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Call):
                f = node.func
                name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", None)
                if (name in accessors and node.args and isinstance(node.args[0], ast.Constant)
                        and isinstance(node.args[0].value, str)):
                    read.add(node.args[0].value)
            elif isinstance(node, ast.Raise):
                refused.update(c.value for c in ast.walk(node)
                               if isinstance(c, ast.Constant) and isinstance(c.value, str))
    return read, refused


def test_every_registered_knob_is_read_where_the_reference_reads_it():
    """Each knob of the port's registry that the reference PACKAGE reads is
    read in the port through an env_* accessor, or named in a raise. The
    knobs that only ``bench.py``, ``scripts/`` or ``tests/conftest.py`` read
    (benchmark outputs, the cluster script, the race hook) have no port
    reader yet, and the scan of the reference proves that is all they are.
    Faults 4, 6, 8 and 9 of the ROADMAP were this rule broken."""
    from pathlib import Path

    from dag_rider_tpu_torch.config import KNOBS

    root = Path(__file__).resolve().parents[1]
    read, refused_strings = _knob_reads_and_refusals(root / "dag_rider_tpu_torch")
    refused = {k for k in KNOBS if any(k in s for s in refused_strings)}
    ref_pkg = root / "dag_rider_tpu"
    in_ref = set()
    for path in ref_pkg.rglob("*.py"):
        if path.relative_to(ref_pkg).as_posix() == "config.py":
            continue
        in_ref.update(c.value for c in _string_constants(path) if c.value in KNOBS)
    missing = sorted(k for k in in_ref if k not in read and k not in refused)
    assert not missing, f"knobs the reference package reads and the port neither reads nor refuses: {missing}"
    outside = set(KNOBS) - in_ref - read
    for k in outside:
        readers = [p for p in (root / "bench.py", root / "tests" / "conftest.py",
                               *sorted((root / "scripts").glob("*.py")))
                   if any(c.value == k for c in _string_constants(p))]
        assert readers, f"{k} is registered but read nowhere in the repo"
    for k in ("DAGRIDER_CERT_MSM", "DAGRIDER_VERIFY_RETRY", "DAGRIDER_VERIFY_FALLBACK"):
        assert k in read
    assert {"DAGRIDER_PALLAS_GROUP", "DAGRIDER_MSM_PALLAS"} <= read & refused


# -- the package surfaces -----------------------------------------------------

#: package __init__ -> (names only the reference exports, names only the port
#: exports): the JAX sharding helper stays behind, the sharded verifier is
#: the card's, and the port's mesh has its own constructors
SURFACE_EXCEPTIONS = {
    "parallel/__init__.py": ({"ShardedTPUVerifier", "batch_sharding"},
                             {"ShardedCUDAVerifier", "Mesh", "mesh_from_env", "virtual_mesh"}),
}


def _module_all(path):
    import ast

    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            return ast.literal_eval(node.value)
    return None


def test_package_surfaces_equal_the_reference():
    """Every ``__all__`` of a module both packages have is the reference's,
    but for the named exceptions; the names import on a machine with no
    card, and importing the surfaces builds or loads no card module."""
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    ref, port = root / "dag_rider_tpu", root / "dag_rider_tpu_torch"
    shared = 0
    for rp in sorted(ref.rglob("*.py")):
        rel = rp.relative_to(ref).as_posix()
        pp = port / rel
        if not pp.exists():
            continue
        want, got = _module_all(rp), _module_all(pp)
        if want is None and got is None:
            continue
        shared += 1
        only_ref, only_port = SURFACE_EXCEPTIONS.get(rel, (set(), set()))
        assert set(want or ()) - only_ref == set(got or ()) - only_port, rel
        assert only_ref <= set(want) and only_port <= set(got), rel
    assert shared >= 10
    import dag_rider_tpu
    import dag_rider_tpu_torch

    assert dag_rider_tpu_torch.__version__ == dag_rider_tpu.__version__
    code = (
        "import sys\n"
        "from dag_rider_tpu_torch.verifier import CPUVerifier, KeyRegistry, NullVerifier, "
        "ResilientVerifier, VertexSigner\n"
        "from dag_rider_tpu_torch.ops import wave_commit_votes\n"
        "from dag_rider_tpu_torch.utils import Metrics, Timer, NOOP, EventLog, capture, stdlib_sink\n"
        "from dag_rider_tpu_torch.crypto import ed25519\n"
        "from dag_rider_tpu_torch import __version__\n"
        "card = [m for m in ('dag_rider_tpu_torch.verifier.cuda', "
        "'dag_rider_tpu_torch.ops.cuda_group', 'dag_rider_tpu_torch.ops.cuda_group381', "
        "'dag_rider_tpu_torch.ops.cuda_field', 'dag_rider_tpu_torch.utils.build') "
        "if m in sys.modules]\n"
        "assert not card, card\n"
        "assert NullVerifier().verify_batch([None, None]) == [True, True]\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True, timeout=120)
