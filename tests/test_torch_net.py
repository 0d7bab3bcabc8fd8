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
crosses the packages on one socket. Last, the transport's batch mode (the
port's own, off by default): frames wait for ``flush`` and go out in
order, one ``DeliverMany`` RPC a peer up to ``batch_bytes``; each frame of
a batch passes the frame auth on its own; a truncated entry ends a batch;
a failed batch is retried as a batch; an authenticated 4-process RBC
committee in batch mode agrees.
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


# -- batch mode (the port's addition to GrpcTransport, off by default) --------


def _batch_pair(batch_bytes=1 << 20, auth=False, n=3):
    from dag_rider_tpu_torch.transport.auth import FrameAuth
    from dag_rider_tpu_torch.transport.net import GrpcTransport

    auths = FrameAuth.derive(b"batch-secret", n) if auth else [None] * n
    nets = [GrpcTransport(i, "127.0.0.1:0", {}, auth=auths[i],
                          batch_bytes=batch_bytes if i == 0 else 0) for i in range(n)]
    addrs = {i: f"127.0.0.1:{t.bound_port}" for i, t in enumerate(nets)}
    for t in nets:
        t._peers.update(addrs)
    got = {i: [] for i in range(n)}
    for i, t in enumerate(nets):
        t.subscribe(i, got[i].append)
    return nets, got


def _msgs(k):
    from dag_rider_tpu_torch.core.types import Block as TBlock, BroadcastMessage
    from dag_rider_tpu_torch.core.types import Vertex as TVertex, VertexID as TVertexID

    return [BroadcastMessage(vertex=TVertex(id=TVertexID(r, 0), block=TBlock((b"tx%d" % r,)),
                                            strong_edges=()), round=r, sender=0)
            for r in range(1, k + 1)]


def _pump_until(nets, got, want, timeout=10.0):
    import time

    end = time.time() + timeout
    while time.time() < end and any(len(got[i]) < want for i in range(1, len(nets))):
        for t in nets:
            t.pump()
        time.sleep(0.005)


@pytest.mark.parametrize("auth", [False, True])
def test_batch_mode_holds_frames_until_flush_and_keeps_their_order(auth):
    import time

    nets, got = _batch_pair(auth=auth)
    try:
        for m in _msgs(5):
            nets[0].broadcast(m)
        time.sleep(0.2)
        for t in nets:
            t.pump()
        assert got[1] == got[2] == [] and "net_sends" not in nets[0].metrics.counters
        nets[0].flush()
        _pump_until(nets, got, 5)
        for i in (1, 2):
            assert [m.round for m in got[i]] == [1, 2, 3, 4, 5]
        assert nets[0].metrics.counters["net_sends"] == 2  # one RPC a peer
        assert all(t.metrics.counters.get("net_auth_rejects", 0) == 0 for t in nets)
        nets[0].flush()  # an empty outbox sends nothing
        assert nets[0].metrics.counters["net_sends"] == 2
    finally:
        for t in nets:
            t.close()


def test_batch_mode_splits_at_batch_bytes():
    from dag_rider_tpu_torch.core import codec

    msgs = _msgs(6)
    size = max(len(codec.encode_message(m)) for m in msgs) + 4
    nets, got = _batch_pair(batch_bytes=2 * size, n=2)
    try:
        for m in msgs:
            nets[0].broadcast(m)
        nets[0].flush()
        _pump_until(nets, got, 6)
        assert sorted(m.round for m in got[1]) == [1, 2, 3, 4, 5, 6]
        assert nets[0].metrics.counters["net_sends"] == 3  # two frames an RPC
    finally:
        for t in nets:
            t.close()


def test_off_by_default_and_flush_is_a_no_op():
    nets, got = _batch_pair(n=2)
    try:
        assert nets[1]._outbox is None
        nets[1].broadcast(_msgs(1)[0])  # sent at once, one RPC
        nets[1].flush()
        import time

        end = time.time() + 10
        while time.time() < end and not got[0]:
            nets[0].pump()
            time.sleep(0.005)
        assert [m.round for m in got[0]] == [1]
        assert nets[1].metrics.counters["net_sends"] == 1
    finally:
        for t in nets:
            t.close()


def test_split_batch_keeps_whole_entries_and_drops_a_truncated_tail():
    import struct

    from dag_rider_tpu_torch.transport.net import split_batch

    body = b"".join(struct.pack("<I", len(f)) + f for f in (b"ab", b"", b"cde"))
    assert split_batch(body) == [b"ab", b"", b"cde"]
    assert split_batch(body + struct.pack("<I", 9) + b"xy") == [b"ab", b"", b"cde"]
    assert split_batch(body + b"\x01\x00") == [b"ab", b"", b"cde"]
    assert split_batch(b"") == []


def test_each_frame_of_a_batch_passes_the_frame_auth_on_its_own():
    """A DeliverMany body holding a good frame, one whose MAC is wrong and
    another good one: the receiver admits the two good frames and counts
    one auth reject, as if the three had come as plain Delivers."""
    import struct
    import time

    import grpc as _grpc

    from dag_rider_tpu_torch.core import codec
    from dag_rider_tpu_torch.transport.auth import FrameAuth

    nets, got = _batch_pair(auth=True, n=2)
    try:
        auth0 = FrameAuth.derive(b"batch-secret", 2)[0]
        frames = []
        for k, m in enumerate(_msgs(3)):
            payload = codec.encode_message(m)
            tag = auth0.tag(1, payload)
            if k == 1:
                tag = bytes(len(tag))
            frames.append(struct.pack("<I", 0) + payload + tag)
        body = b"".join(struct.pack("<I", len(f)) + f for f in frames)
        with _grpc.insecure_channel(f"127.0.0.1:{nets[1].bound_port}") as chan:
            call = chan.unary_unary("/dagrider.Transport/DeliverMany",
                                    request_serializer=lambda b: b,
                                    response_deserializer=lambda b: b)
            assert call(body, timeout=10) == b"\x01"
        end = time.time() + 10
        while time.time() < end and len(got[1]) < 2:
            nets[1].pump()
            time.sleep(0.005)
        assert [m.round for m in got[1]] == [1, 3]
        assert nets[1].metrics.counters["net_auth_rejects"] == 1
    finally:
        for t in nets:
            t.close()


def test_a_failed_batch_is_retried_as_a_batch_then_dropped():
    import time

    from dag_rider_tpu_torch.transport.net import GrpcTransport

    t = GrpcTransport(0, "127.0.0.1:0", {1: "127.0.0.1:1"}, retries=1,
                      retry_backoff_s=0.01, rpc_timeout_s=0.5, batch_bytes=1 << 20)
    try:
        for m in _msgs(4):
            t.broadcast(m)
        t.flush()
        end = time.time() + 15
        while time.time() < end and not t.metrics.counters.get("net_drops"):
            time.sleep(0.01)
        c = t.metrics.counters
        assert (c["net_sends"], c["net_retries"], c["net_drops"], c["net_send_errors"]) == (
            2, 1, 1, 2)
        assert set(t._many_stubs) == {1}
    finally:
        t.close()


def test_an_authenticated_batched_committee_reaches_consensus():
    """The reference's authenticated 4-process RBC committee, every
    transport in batch mode and flushed after each step: n vertices
    delivered everywhere, the logs agree, no frame refused."""
    import time

    from dag_rider_tpu_torch.config import Config
    from dag_rider_tpu_torch.consensus.process import Process
    from dag_rider_tpu_torch.core.types import Block as TBlock
    from dag_rider_tpu_torch.transport.auth import FrameAuth
    from dag_rider_tpu_torch.transport.net import GrpcTransport
    from dag_rider_tpu_torch.transport.rbc import RbcTransport

    n = 4
    cfg = Config(n=n, coin="round_robin", propose_empty=False)
    auths = FrameAuth.derive(b"cluster-master-secret", n)
    nets = [GrpcTransport(i, "127.0.0.1:0", {}, auth=auths[i], batch_bytes=1 << 20)
            for i in range(n)]
    addrs = {i: f"127.0.0.1:{t.bound_port}" for i, t in enumerate(nets)}
    for t in nets:
        t._peers.update(addrs)
    try:
        delivered = [[] for _ in range(n)]
        procs = [Process(cfg, i, RbcTransport(nets[i], i, n, cfg.f),
                         on_deliver=delivered[i].append) for i in range(n)]
        for p in procs:
            p.defer_steps = True
            for k in range(10):
                p.submit(TBlock((f"p{p.index}-b{k}".encode(),)))
        for p in procs:
            p.start()
        deadline = time.time() + 60
        while time.time() < deadline and not all(len(d) >= n for d in delivered):
            moved = False
            for t in nets:
                moved |= t.pump(64) > 0
            for p, t in zip(procs, nets):
                p.step()
                t.flush()
            if not moved:
                time.sleep(0.002)
        assert all(len(d) >= n for d in delivered)
        logs = [[(v.id.round, v.id.source, v.digest()) for v in d] for d in delivered]
        k = min(len(log) for log in logs)
        assert all(log[:k] == logs[0][:k] for log in logs)
        assert all(t.metrics.counters.get("net_auth_rejects", 0) == 0 for t in nets)
        assert all(t.metrics.counters["net_sends"] > 0 for t in nets)
        assert not any(t.metrics.counters.get("net_drops", 0) for t in nets)
    finally:
        for t in nets:
            t.close()
