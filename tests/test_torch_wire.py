"""The port and the reference on one wire.

Two packages that frame, authenticate and encode alike can share a
committee and a sidecar. A mixed committee: two reference ``Node``s and
two port ``Node``s from one key file (CPU verifiers, ``round_robin``
coin, Bracha RBC, frame auth on) reach one prefix-consistent log over
gRPC on localhost, with no frame refused. Sidecars both ways: the port's
``RemoteVerifier`` against the reference's sidecar over ``CPUVerifier``,
and the reference's ``RemoteVerifier`` against the port's sidecar over
``CUDAVerifier(reg, device="cpu")`` (the card's program through its plain
torch versions), give the reference's masks on the corruptions of
``tests/test_verifier_tpu.py``.
"""

import time

import pytest

from dag_rider_tpu import node as ref_node
from dag_rider_tpu.core.types import Block as JBlock
from dag_rider_tpu.core.types import Vertex, VertexID
from dag_rider_tpu.verifier import sidecar as ref_sidecar
from dag_rider_tpu.verifier.base import KeyRegistry as JKeyRegistry
from dag_rider_tpu.verifier.base import VertexSigner as JSigner
from dag_rider_tpu.verifier.cpu import CPUVerifier as JCPUVerifier
from dag_rider_tpu_torch import node as port_node
from dag_rider_tpu_torch.core.types import Block
from dag_rider_tpu_torch.verifier import sidecar
from dag_rider_tpu_torch.verifier.base import KeyRegistry
from dag_rider_tpu_torch.verifier.cuda import CUDAVerifier
from test_verifier_tpu import corruptions
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def test_mixed_committee_reaches_one_log(tmp_path):
    n = 4
    keys = tmp_path / "keys.json"
    port_node._dump_secret_file(str(keys), port_node.generate_keys(n, 2, "mixed"))
    kinds = [ref_node, port_node, ref_node, port_node]
    nodes = [
        mod.Node({"index": i, "n": n, "listen": "127.0.0.1:0", "peers": {},
                  "keys": str(keys), "rbc": True, "verifier": "cpu",
                  "coin": "round_robin", "propose_empty": True,
                  "auth_master": "5e" * 32})
        for i, mod in enumerate(kinds)
    ]
    addrs = {i: f"127.0.0.1:{nd.net.bound_port}" for i, nd in enumerate(nodes)}
    for i, nd in enumerate(nodes):
        nd.net._peers.update({j: a for j, a in addrs.items() if j != i})
    try:
        for nd in nodes:
            nd.start()
        for i, nd in enumerate(nodes):
            block = (JBlock if kinds[i] is ref_node else Block)
            for k in range(4):
                nd.submit(block((f"n{i}-b{k}".encode(),)))
        deadline = time.time() + 60
        while time.time() < deadline and not all(
                len(nd.delivered) >= 2 * n and nd.process.decided_wave >= 2 for nd in nodes):
            time.sleep(0.05)
    finally:
        for nd in nodes:
            nd.stop()
    logs = [[(v.id.round, v.id.source, v.digest()) for v in nd.delivered] for nd in nodes]
    assert all(len(log) >= 2 * n for log in logs), [len(log) for log in logs]
    k = min(len(log) for log in logs)
    assert all(log[:k] == logs[0][:k] for log in logs)
    assert {src for _, src, _ in logs[0][:k]} == set(range(n))
    for nd in nodes:
        counters = nd.process.metrics.counters
        assert counters.get("net_auth_rejects", 0) == 0
        assert counters.get("net_sends_ok", 0) > 0


@pytest.fixture(scope="module")
def rows():
    """8 signed vertices, then the 12 corruptions of
    tests/test_verifier_tpu.py: 20 rows, 8 valid (bucket 32)."""
    reg, seeds = JKeyRegistry.generate(8)
    signers = [JSigner(s) for s in seeds]
    vs = [
        signers[i].sign_vertex(Vertex(
            id=VertexID(3, i), block=JBlock((f"tx-{i}".encode(),)),
            strong_edges=(VertexID(2, 0), VertexID(2, 1), VertexID(2, 2))))
        for i in range(8)
    ]
    return reg, vs + corruptions(vs)


def test_port_client_against_the_reference_sidecar(rows):
    reg, batch = rows
    want = JCPUVerifier(reg).verify_batch(batch)
    server = ref_sidecar.VerifierSidecarServer(JCPUVerifier(reg))
    try:
        client = sidecar.RemoteVerifier(server.address)
        assert client.verify_batch(batch) == want == [True] * 8 + [False] * 12
        assert client.verify_batch([]) == [] and client.ping()
        client.close()
    finally:
        server.stop()


def test_reference_client_against_the_port_sidecar_over_the_card_program(rows):
    reg, batch = rows
    want = JCPUVerifier(reg).verify_batch(batch)
    backend = CUDAVerifier(KeyRegistry(reg.public_keys), device="cpu")
    server = sidecar.VerifierSidecarServer(backend)
    try:
        assert server.warmup_compile_s > 0 and backend._warm  # warmed before the port opened
        client = ref_sidecar.RemoteVerifier(server.address)
        assert client.verify_batch(batch) == want == [True] * 8 + [False] * 12
        assert backend.total_dispatches == 1 and backend.total_sigs_dispatched == len(batch)
        assert client.ping() and backend.total_dispatches == 1  # an empty batch dispatches nothing
        client.close()
    finally:
        server.stop()
