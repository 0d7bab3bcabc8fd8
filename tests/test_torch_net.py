"""The port's gRPC transport and verifier sidecar, held to the reference.

Every recipe of ``tests/test_net_transport.py`` runs unchanged against the
port's ``GrpcTransport``, ``RbcTransport``, ``FrameAuth``, ``WanFault`` and
``RemoteVerifier``/``VerifierSidecarServer`` (``tests/torch_replay.py``),
the 16-node RBC committee included (in the slow tier, as the reference
files it). Then what the recipes leave out: the sidecar's batch frames are
the reference's bytes over the corruptions of
``tests/test_verifier_tpu.py``, a ``RemoteVerifier`` fails closed per
attempt exactly as the reference's does (a mis-sized reply included), and
the sidecar's declared seam (the backend warms up before the port opens,
with no XLA cache) behaves as declared. ``tests/test_torch_wire.py``
crosses the packages on one socket.
"""

import pytest

from dag_rider_tpu.core.types import Block, Vertex, VertexID
from dag_rider_tpu.verifier.base import KeyRegistry as JKeyRegistry
from dag_rider_tpu.verifier.base import VertexSigner as JSigner
from dag_rider_tpu.verifier import sidecar as jsidecar
from dag_rider_tpu_torch.verifier import sidecar
from dag_rider_tpu_torch.verifier.base import KeyRegistry
from dag_rider_tpu_torch.verifier.cpu import CPUVerifier
from test_verifier_tpu import corruptions
from torch_replay import replay

REPLAYED = replay("test_net_transport.py", globals())


def test_every_reference_recipe_is_replayed():
    import ast

    from torch_replay import TESTS

    tree = ast.parse((TESTS / "test_net_transport.py").read_text())
    names = [n.name for n in tree.body if isinstance(n, ast.FunctionDef)
             and n.name.startswith("test_")]
    assert REPLAYED == names and len(names) >= 19


@pytest.fixture(scope="module")
def rows():
    """8 signed vertices, then the 12 corruptions of
    tests/test_verifier_tpu.py: 20 rows, 8 valid."""
    reg, seeds = JKeyRegistry.generate(8)
    signers = [JSigner(s) for s in seeds]
    vs = [
        signers[i].sign_vertex(Vertex(
            id=VertexID(3, i), block=Block((f"tx-{i}".encode(),)),
            strong_edges=(VertexID(2, 0), VertexID(2, 1), VertexID(2, 2))))
        for i in range(8)
    ]
    return reg, vs + corruptions(vs)


def test_batch_frames_are_the_references_bytes(rows):
    _, batch = rows
    payload = jsidecar._encode_batch(batch)
    port_rows = sidecar._decode_batch(payload)
    assert sidecar._encode_batch(port_rows) == payload
    assert [jsidecar._encode_batch([v]) for v in batch] == [
        sidecar._encode_batch([v]) for v in port_rows]
    with pytest.raises(ValueError):
        sidecar._decode_batch(payload[:-1])


def test_sidecar_warms_its_backend_before_the_port_opens():
    """The declared seam: a backend with ``warmup`` is warmed (no XLA cache
    call), before the server binds; ``warmup=False`` skips it; a backend
    without one is served as it is."""
    order = []

    class Backend(CPUVerifier):
        def warmup(self):
            order.append("warmup")
            return 1.5

    reg, _ = KeyRegistry.generate(2)
    real_server = sidecar.grpc.server

    def server(*a, **kw):
        order.append("server")
        return real_server(*a, **kw)

    sidecar.grpc.server = server
    try:
        for backend, warm, want in ((Backend(reg), True, ["warmup", "server"]),
                                    (Backend(reg), False, ["server"]),
                                    (CPUVerifier(reg), True, ["server"])):
            order.clear()
            srv = sidecar.VerifierSidecarServer(backend, warmup=warm)
            srv.stop()
            assert order == want
            assert srv.warmup_compile_s == (1.5 if want[0] == "warmup" else 0.0)
    finally:
        sidecar.grpc.server = real_server


def test_remote_verifier_fails_closed_per_attempt_as_the_reference(rows):
    reg, batch = rows
    server = sidecar.VerifierSidecarServer(CPUVerifier(KeyRegistry(reg.public_keys)))
    addr = server.address
    server.stop()
    for mod in (sidecar, jsidecar):
        remote = mod.RemoteVerifier(addr, timeout=0.5, retries=1, backoff_s=0.01)
        assert remote.verify_batch(batch[:3]) == [False] * 3
        assert (remote.rpc_failures, remote.retries_total) == (2, 1)
        assert not remote.ping()
        remote.close()
        strict = mod.RemoteVerifier(addr, timeout=0.5, raise_on_unavailable=True)
        with pytest.raises(Exception) as err:
            strict.verify_batch(batch[:1])
        assert type(err.value).__name__ == "VerifierUnavailableError"
        strict.close()


def test_a_mis_sized_reply_is_a_transport_fault():
    reg, _ = KeyRegistry.generate(2)
    v = Vertex(id=VertexID(1, 0))

    class Short(CPUVerifier):
        def verify_batch(self, vertices):
            return super().verify_batch(vertices)[:-1]

    server = sidecar.VerifierSidecarServer(Short(reg))
    try:
        remote = sidecar.RemoteVerifier(server.address)
        assert remote.verify_batch([v, v]) == [False, False]
        assert remote.rpc_failures == 1
        remote.close()
    finally:
        server.stop()
