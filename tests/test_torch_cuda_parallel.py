"""The windowed path and the mesh on the card.

The windowed verify's card program (``ops/windowed.py``: ``padd_xx`` and
``pow22523`` launches, the walk replayed from its step graph) gives the
masks of its twin ``curve.verify_core`` on the CPU and of the comb path on
the card, with exactly its launches; ``ShardedCUDAVerifier`` and
``ShardedMSM`` on virtual meshes of one card (4 and 5 entries) give the
single-card masks and the host group law's point.

These tests need a card and skip without one. They import no JAX:

    python -m pytest tests/test_torch_cuda_parallel.py -m cuda -p no:xdist --noconftest
"""

import dataclasses
import random

import pytest
import torch

from dag_rider_tpu_torch.core.types import Block, Vertex, VertexID
from dag_rider_tpu_torch.crypto import bls12381 as bls
from dag_rider_tpu_torch.ops import bls_msm, cuda_group as CG, cuda_group381 as G, windowed
from dag_rider_tpu_torch.parallel.mesh import virtual_mesh
from dag_rider_tpu_torch.parallel.msm import ShardedMSM
from dag_rider_tpu_torch.parallel.sharded_verifier import ShardedCUDAVerifier
from dag_rider_tpu_torch.verifier.base import KeyRegistry, VertexSigner
from dag_rider_tpu_torch.verifier.cpu import CPUVerifier
from dag_rider_tpu_torch.verifier.cuda import CUDAVerifier

pytestmark = pytest.mark.cuda

N = 16


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m cuda")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def committee():
    reg, seeds = KeyRegistry.generate(N)
    vs = [
        VertexSigner(seeds[i]).sign_vertex(
            Vertex(id=VertexID(3, i), block=Block((f"tx-{i}".encode(),)),
                   strong_edges=tuple(VertexID(2, j) for j in range(11)))
        )
        for i in range(N)
    ]
    bad = [
        dataclasses.replace(vs[0], signature=b"\x00" * 64),
        dataclasses.replace(vs[1], signature=vs[2].signature),
        dataclasses.replace(vs[3], block=Block((b"tampered",))),
        dataclasses.replace(vs[4], signature=(2**255 - 10).to_bytes(32, "little")
                            + vs[4].signature[32:]),
        dataclasses.replace(vs[5], id=VertexID(3, 999)),
    ]
    return reg, vs + bad


def test_windowed_card_masks_equal_twin_comb_and_oracle(dev, committee):
    reg, batch = committee
    want = CPUVerifier(reg).verify_batch(batch)
    card = CUDAVerifier(reg, comb=False)
    card.verify_batch(batch[:17])  # builds the step graph at this width (32 rows) once
    CG.reset_launches()
    got = card.verify_batch(batch)
    torch.cuda.synchronize()
    launches = dict(CG.LAUNCHES)
    assert got == want == CUDAVerifier(reg).verify_batch(batch)
    assert CUDAVerifier(reg, comb=False, device="cpu").verify_batch(batch) == want
    assert launches == {"padd_xx": 80, "tree_sum_xyzt": 0, "finish_check": 0, "pow22523": 1}


def test_windowed_graph_equals_eager(dev, committee):
    reg, batch = committee
    args = [torch.from_numpy(a).to(dev) for a in CUDAVerifier(reg, comb=False).prepare_batch(batch)]
    from dag_rider_tpu_torch.ops import field as F

    one = F.const("ONE", dev).expand_as(args[2])
    point = (args[2], args[3], one, args[4])
    eager = windowed.verify(args[0], args[1], point, *args[5:], graph=False)
    graph = windowed.verify(args[0], args[1], point, *args[5:], graph=True)
    assert torch.equal(eager, graph)


@pytest.mark.parametrize("k", [4, 5])
def test_sharded_on_a_virtual_mesh_equals_one_card(dev, committee, k):
    reg, batch = committee
    want = CUDAVerifier(reg).verify_batch(batch)
    sv = ShardedCUDAVerifier(reg, virtual_mesh(k))
    CG.reset_launches()
    assert sv.verify_batch(batch) == want
    torch.cuda.synchronize()
    assert CG.LAUNCHES["tree_sum_xyzt"] == k and CG.LAUNCHES["finish_check"] == k
    assert sv.mesh_devices == k and len(sv.table_bytes()) == 1
    assert ShardedCUDAVerifier(reg, virtual_mesh(k), comb=False).verify_batch(batch) == want


def test_sharded_msm_on_a_virtual_mesh(dev):
    rng = random.Random(9)
    pts = [bls.g1_mul(rng.randrange(1, bls.R)) for _ in range(32)]
    ks = [rng.randrange(0, bls.R) for _ in range(32)]
    ks[5] = 0
    pts[7] = None
    want = bls.g1_msm(ks, pts)
    assert bls_msm.msm(ks, pts) == want
    sm = ShardedMSM(virtual_mesh(4))
    G.reset_launches()
    assert sm(ks, pts) == want
    torch.cuda.synchronize()
    # 4 shards of 8 points: 15 + 3 additions each, 2 fold levels, one Horner chain
    assert G.LAUNCHES == {"padd381_xx": 4 * 18 + 2, "horner381": 1}
    assert sm.sum_points(pts[:8]) == bls.g1_sum([p for p in pts[:8] if p is not None])
