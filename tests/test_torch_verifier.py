"""Port verifier vs the JAX package — bytes, masks and commit order.

``CUDAVerifier(reg, device="cpu")`` runs the port's whole device program
through the kernels' plain torch versions. It must pack the same transfer
bytes as the JAX ``TPUVerifier._prepare(comb=True)``, return the accept
masks of JAX ``TPUVerifier`` and of both CPU oracles on signed and
corrupted rounds, and, plugged into the JAX package's ``Simulation``,
deliver the same commit order as the CPU oracle, byte for byte.
"""

import dataclasses

import numpy as np
import pytest
import torch

from dag_rider_tpu.config import Config
from dag_rider_tpu.consensus.simulator import Simulation
from dag_rider_tpu.core.types import Block, Vertex, VertexID
from dag_rider_tpu.verifier.base import KeyRegistry as JKeyRegistry
from dag_rider_tpu.verifier.base import VertexSigner as JSigner
from dag_rider_tpu.verifier.cpu import CPUVerifier as JCPUVerifier
from dag_rider_tpu.verifier.tpu import TPUVerifier
from dag_rider_tpu_torch.core import types as T
from dag_rider_tpu_torch.verifier.base import (
    KeyRegistry,
    VerifierUnavailableError,
    VertexSigner,
)
from dag_rider_tpu_torch.verifier.cpu import CPUVerifier
from dag_rider_tpu_torch.verifier.cuda import CUDAVerifier
from test_verifier_tpu import corruptions


@pytest.fixture(scope="module")
def keys():
    return JKeyRegistry.generate(8)


@pytest.fixture(scope="module")
def batch(keys):
    """8 signed vertices (the shapes of tests/test_verifier_tpu.py), then
    the corruptions: bad signature bytes, another vertex's signature,
    tampered block, missing signature, s >= L, R.y >= p, bit flips, plus
    a wrong source and an out-of-range source."""
    _, seeds = keys
    signers = [JSigner(s) for s in seeds]
    vs = [
        signers[i].sign_vertex(
            Vertex(
                id=VertexID(3, i),
                block=Block((f"tx-{i}".encode(),)),
                strong_edges=(VertexID(2, 0), VertexID(2, 1), VertexID(2, 2)),
            )
        )
        for i in range(8)
    ]
    bad = corruptions(vs) + [
        dataclasses.replace(vs[1], id=VertexID(3, 2)),
        dataclasses.replace(vs[0], id=VertexID(3, 999)),
    ]
    return vs + bad  # 22 rows: bucket 32, as the JAX test's batch


@pytest.fixture(scope="module")
def port_verifier(keys):
    v = CUDAVerifier(KeyRegistry(keys[0].public_keys), device="cpu")
    v.comb_tables()
    return v


@pytest.fixture(scope="module")
def jax_mask(keys, batch):
    return TPUVerifier(keys[0]).verify_batch(batch)


def test_registry_and_signer_byte_identical(keys, batch):
    jreg, jseeds = keys
    reg, seeds = KeyRegistry.generate(8)
    assert reg.public_keys == jreg.public_keys and seeds == jseeds
    assert reg.key_of(3) == jreg.key_of(3) and reg.key_of(8) is None
    assert reg.key_of(-1) is None and reg.n == 8
    v = dataclasses.replace(batch[2], signature=None)
    assert VertexSigner(seeds[2]).sign_vertex(v).signature == batch[2].signature
    assert VertexSigner(seeds[2]).public_key == jreg.public_keys[2]


def test_vertex_encoding_byte_identical():
    kw = dict(
        block=Block((b"a", b"", b"ccc")),
        strong_edges=(VertexID(4, 3), VertexID(4, 0), VertexID(4, 1)),
        weak_edges=(VertexID(1, 2),),
        coin_share=b"share",
    )
    jv = Vertex(id=VertexID(5, 2), **kw)
    tv = T.Vertex(
        id=T.VertexID(5, 2),
        block=T.Block(kw["block"].transactions),
        strong_edges=tuple(T.VertexID(*e) for e in kw["strong_edges"]),
        weak_edges=tuple(T.VertexID(*e) for e in kw["weak_edges"]),
        coin_share=b"share",
    )
    assert tv.signing_bytes() == jv.signing_bytes()
    assert tv.digest() == jv.digest()
    assert T.Block.decode(tv.block.encode())[0] == tv.block


@pytest.mark.parametrize("size", [32, 64])
def test_prepare_bytes_identical_to_jax(keys, batch, port_verifier, size):
    want_u8, want_i32 = TPUVerifier(keys[0])._prepare(batch, size, comb=True)
    u8, i32 = port_verifier._prepare(batch, size)
    assert u8.dtype == want_u8.dtype and i32.dtype == want_i32.dtype
    assert u8.tobytes() == want_u8.tobytes()
    assert i32.tobytes() == want_i32.tobytes()


def test_verify_batch_matches_tpu_and_cpu_oracles(keys, batch, port_verifier, jax_mask):
    got = port_verifier.verify_batch(batch)
    assert got == jax_mask
    assert got == JCPUVerifier(keys[0]).verify_batch(batch)
    assert got == CPUVerifier(port_verifier.registry).verify_batch(batch)
    assert got[:8] == [True] * 8 and not any(got[8:])


def test_verify_rounds_merged_and_chunked(batch, port_verifier, jax_mask):
    rounds = [batch[:5], [], batch[5:]]
    want = [jax_mask[:5], [], jax_mask[5:]]
    assert port_verifier.verify_rounds(rounds) == want
    port_verifier.fixed_bucket = 16  # 22 rows -> chunks of 16 and 6
    try:
        assert port_verifier.verify_rounds(rounds) == want
    finally:
        port_verifier.fixed_bucket = None
    assert port_verifier.verify_rounds([[], []]) == [[], []]
    assert port_verifier.verify_batch([]) == []
    assert port_verifier.verify_batch(batch[:1]) == [True]


def test_invalid_registry_key_rejects():
    reg, seeds = KeyRegistry.generate(4)
    pubs = list(reg.public_keys)
    pubs[2] = int.to_bytes(2, 32, "little")  # y = 2 is not on the curve
    broken = KeyRegistry(tuple(pubs))
    v = VertexSigner(seeds[2]).sign_vertex(
        T.Vertex(id=T.VertexID(1, 2), strong_edges=(T.VertexID(0, 0),))
    )
    ver = CUDAVerifier(broken, device="cpu")
    u8, _ = ver._prepare([v], 16)
    assert u8[0, 129] == 1 and u8[0, 130] == 0  # prevalid, key invalid
    assert ver.verify_batch([v]) == [False]
    assert CPUVerifier(broken).verify_batch([v]) == [False]


def test_default_device_is_cuda_and_never_falls_back():
    reg, _ = KeyRegistry.generate(1)
    if torch.cuda.is_available():
        assert CUDAVerifier(reg).device.type == "cuda"
    else:
        with pytest.raises(VerifierUnavailableError):
            CUDAVerifier(reg)
    assert CUDAVerifier(reg, device="cpu").device == torch.device("cpu")


def test_commit_order_matches_cpu_oracle():
    """The slice end to end: the JAX package's n = 4 Simulation (the recipe
    of tests/test_determinism.py) with the port's verifier and signers
    delivers the (round, source, digest) log of the same run with the
    JAX CPUVerifier, byte for byte — and delivers something."""

    def run(verifier, signers):
        cfg = Config(n=4, coin="round_robin", propose_empty=False)
        sim = Simulation(
            cfg,
            verifier_factory=lambda i: verifier,
            signer_factory=lambda i: signers[i],
        )
        sim.submit_blocks(per_process=10)
        sim.run(max_messages=50_000)
        sim.check_agreement()
        return [
            [(v.id.round, v.id.source, v.digest()) for v in sim.deliveries[i]]
            for i in range(4)
        ]

    jreg, jseeds = JKeyRegistry.generate(4)
    reg, seeds = KeyRegistry.generate(4)
    port = CUDAVerifier(reg, device="cpu")
    port_logs = run(port, [VertexSigner(s) for s in seeds])
    cpu_logs = run(JCPUVerifier(jreg), [JSigner(s) for s in jseeds])
    assert any(cpu_logs), "nothing delivered"
    assert port_logs == cpu_logs
    assert np.isfinite(port.last_prepare_s) and port.last_dispatch_s > 0
