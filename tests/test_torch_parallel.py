"""The port's parallel layer on CPU meshes, against the JAX package.

A CPU mesh of k entries stands where the JAX tests put 8 virtual CPU
devices (``tests/conftest.py``). Sharding must change placement, never
results: ``ShardedCUDAVerifier`` at k = 1, 2, 5 and 8 gives the masks of
``CPUVerifier``, of ``CUDAVerifier(device="cpu")`` and of the JAX
``ShardedTPUVerifier(reg, make_mesh(8))`` on ``tests/test_parallel.py``'s
batch; ``ShardedMSM`` at k = 1, 3 and 8 the affine point of ``bls_msm.msm``,
the host group law and the JAX ``ShardedMSM``; ``make_round_step`` the JAX
round step's (accept, commit, votes); and ``Simulation(verifier="sharded")``
the commit logs of ``verifier="cpu"`` and of the JAX sharded simulation.
The JAX references are built once per module at the JAX tests' shapes.
"""

import dataclasses
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

from tests import fixtures
from dag_rider_tpu.core.types import Block, Vertex, VertexID
from dag_rider_tpu.crypto import bls12381 as jbls
from dag_rider_tpu.ops import bls_msm as jmsm
from dag_rider_tpu.parallel.mesh import make_mesh as jax_mesh
from dag_rider_tpu.parallel.msm import ShardedMSM as JShardedMSM
from dag_rider_tpu.parallel.round_step import make_round_step as jax_round_step
from dag_rider_tpu.parallel.sharded_verifier import ShardedTPUVerifier
from dag_rider_tpu.verifier.base import KeyRegistry, VertexSigner
from dag_rider_tpu.verifier.tpu import TPUVerifier
from dag_rider_tpu_torch import Config
from dag_rider_tpu_torch.consensus.simulator import Simulation
from dag_rider_tpu_torch.crypto import bls12381 as bls, threshold as th
from dag_rider_tpu_torch.ops import bls_msm, cuda_group381 as G
from dag_rider_tpu_torch.parallel import mesh as M
from dag_rider_tpu_torch.parallel.msm import ShardedMSM, padded_size
from dag_rider_tpu_torch.parallel.round_step import make_round_step
from dag_rider_tpu_torch.parallel.sharded_verifier import ShardedCUDAVerifier
from dag_rider_tpu_torch.verifier.cpu import CPUVerifier
from dag_rider_tpu_torch.verifier.cuda import CUDAVerifier


@pytest.fixture(scope="module")
def keys():
    return KeyRegistry.generate(8)


@pytest.fixture(scope="module")
def batch(keys):
    """tests/test_parallel.py's batch: 8 signed vertices, then a bad
    signature, a swapped signature and a tampered payload (11 rows)."""
    _, seeds = keys
    vs = []
    for i in range(8):
        v = Vertex(
            id=VertexID(2, i),
            block=Block((f"tx-{i}".encode(),)),
            strong_edges=tuple(VertexID(1, s) for s in range(6)),
        )
        vs.append(VertexSigner(seeds[i]).sign_vertex(v))
    vs.append(dataclasses.replace(vs[0], signature=b"\x01" * 64))
    vs.append(dataclasses.replace(vs[1], signature=vs[2].signature))
    vs.append(dataclasses.replace(vs[3], block=Block((b"tampered",))))
    return vs


@pytest.fixture(scope="module")
def tables(keys):
    """One CPU build of the n = 8 comb tables, shared by every verifier."""
    return CUDAVerifier(keys[0], device="cpu").comb_tables()


@pytest.fixture(scope="module")
def want(keys, batch):
    return CPUVerifier(keys[0]).verify_batch(batch)


@pytest.fixture(scope="module")
def jax_sharded_mask(keys, batch):
    return ShardedTPUVerifier(keys[0], jax_mesh(8)).verify_batch(batch)


def _sharded(keys, k, tables, **kw):
    v = ShardedCUDAVerifier(keys[0], M.make_mesh(k, device="cpu"), **kw)
    v._tables = tables
    return v


# -- mesh --------------------------------------------------------------------


def test_mesh_shapes_and_helpers():
    mesh = M.make_mesh(8, device="cpu")
    assert mesh.size == 8 and mesh.axis_name == "batch" and not mesh.virtual
    assert mesh.distinct() == (torch.device("cpu"),)
    assert M.make_mesh(device="cpu").size == M.CPU_DEVICES == 8
    v = M.virtual_mesh(3, "cpu")
    assert v.virtual and v.size == 3 and repr(v).startswith("virtual Mesh(batch:")
    x = torch.arange(20).reshape(10, 2)
    parts = M.split_rows(x, 5)
    assert [tuple(p.shape) for p in parts] == [(2, 2)] * 5
    assert torch.equal(M.gather_rows(parts, torch.device("cpu")), x)
    with pytest.raises(ValueError, match="do not split"):
        M.split_rows(x, 3)


def test_no_card_mesh_raises_unless_the_cpu_is_asked_for():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.virtual_mesh(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedMSM()


# -- sharded verifier ----------------------------------------------------------


@pytest.mark.parametrize("k", [1, 5, 8])
def test_sharded_masks_equal_cpu_single_and_jax(keys, batch, tables, want, jax_sharded_mask, k):
    v = _sharded(keys, k, tables)
    got = v.verify_batch(batch)
    assert got == want == jax_sharded_mask
    single = CUDAVerifier(keys[0], device="cpu")
    single._tables = tables
    assert single.verify_batch(batch) == want
    assert want == [True] * 8 + [False] * 3
    assert v.mesh_devices == k and v.last_shard_batch == v._size_for(len(batch)) // k


def test_sharded_windowed_masks_equal_cpu(keys, batch, want):
    v = ShardedCUDAVerifier(keys[0], M.make_mesh(2, device="cpu"), comb=False)
    assert v.verify_batch(batch) == want
    assert v.last_shard_batch == 8


def test_sharded_bucket_rounds_to_mesh_multiple(keys, tables):
    v5 = _sharded(keys, 5, tables)
    assert v5._round_bucket(16) == 20
    assert v5._size_for(11) % 5 == 0 and v5._size_for(11) >= 16
    assert v5._size_for(33) % 5 == 0 and v5._size_for(33) >= 64
    v8 = _sharded(keys, 8, tables)
    for n in (1, 11, 16, 33, 100):
        assert v8._size_for(n) == max(16, 1 << (n - 1).bit_length())
    v5.fixed_bucket = 16
    assert v5._size_for(3) == 20
    u8, i32 = v5.prepare_batch([])
    assert u8.shape == (20, 131) and i32.shape == (20, 23)


def test_sharded_put_splits_over_the_mesh(keys, batch, tables):
    v = _sharded(keys, 8, tables)
    u8, _ = v.prepare_batch(batch)
    parts = v._put(u8)
    assert len(parts) == 8 and all(p.shape == (2, 131) for p in parts)
    assert np.concatenate([p.numpy() for p in parts]).tobytes() == u8.tobytes()
    per_dev, _ = v._comb_tables_dev()
    assert list(per_dev) == [torch.device("cpu")]  # one copy per distinct device


def test_sharded_async_seam_and_verify_rounds_dispatch_on_the_mesh(keys, batch, tables, want):
    """dispatch_batch/resolve_batch, warmup and the chunk-streaming
    verify_rounds are the mesh's: the shard gauges move on every path."""
    sv = _sharded(keys, 8, tables)
    sv.fixed_bucket = 16
    assert sv.warmup() > 0.0 and sv.warmup() == 0.0
    pending = sv.dispatch_batch(batch)
    assert pending.count == len(batch) and pending.mask.shape == (16,)
    assert sv.resolve_batch(pending) == want
    assert (sv.mesh_devices, sv.last_shard_batch) == (8, 2)
    assert sv.last_shard_imbalance == 1.0  # 11 rows: the last shards are all padding
    p1 = sv.dispatch_batch(batch[:6])
    p2 = sv.dispatch_batch(batch[6:])
    assert sv.resolve_batch(p1) + sv.resolve_batch(p2) == want
    s3 = _sharded(keys, 3, tables)
    s3.fixed_bucket = 8  # 22 rows stream in chunks of 8 (9 rows a dispatch)
    assert s3.verify_rounds([batch, batch]) == [want, want]
    assert s3.total_dispatches == 3 and s3.last_shard_batch == 3
    assert s3.total_shard_imbalance > 0.0  # the last chunk: 6 rows over 3 shards of 3


def test_sharded_pins_four_bit_windows(keys, monkeypatch):
    monkeypatch.setenv("DAGRIDER_COMB_BITS", "8")
    with pytest.warns(UserWarning, match="pins comb windows to 4 bits"):
        v = ShardedCUDAVerifier(keys[0], M.make_mesh(2, device="cpu"))
    assert v.u8_cols == 131


# -- sharded MSM ---------------------------------------------------------------


@pytest.fixture(scope="module")
def msm_inputs():
    """tests/test_parallel.py's MSM: 32 points, a zero scalar, an identity."""
    rng = random.Random(9)
    pts = [jbls.g1_mul(rng.randrange(1, jbls.R)) for _ in range(32)]
    ks = [rng.randrange(0, jbls.R) for _ in range(32)]
    ks[5] = 0
    pts[7] = None
    return ks, pts


@pytest.fixture(scope="module")
def msm_want(msm_inputs):
    ks, pts = msm_inputs
    want = jbls.g1_msm(ks, pts)
    assert JShardedMSM(jax_mesh(8))(ks, pts) == want
    assert bls.g1_msm(ks, pts) == want
    assert bls_msm.msm(ks, pts, device="cpu") == want
    return want


@pytest.mark.parametrize("k", [1, 3, 8])
def test_sharded_msm_equals_single_device_host_and_jax(msm_inputs, msm_want, k):
    ks, pts = msm_inputs
    sm = ShardedMSM(M.make_mesh(k, device="cpu"))
    assert sm(ks, pts) == msm_want
    assert sm.window_partials(ks, pts).shape == (k, G.ROWS, G.WINDOWS)
    assert padded_size(len(pts), k) % k == 0


def test_sharded_msm_plugs_into_aggregate():
    keys = th.ThresholdKeys.generate(8, 3)
    shares = {i: th.sign_share(keys.share_sks[i], 2) for i in range(4)}
    sm = ShardedMSM(M.make_mesh(3, device="cpu"))
    sigma = th.aggregate(shares, 3, msm=sm)
    assert sigma == th.aggregate(shares, 3)
    assert th.verify_group(keys.group_pk, 2, sigma)


@pytest.mark.parametrize("t", [1, 2, 3, 5, 8])
def test_tree_reduce_matches_jax_limb_for_limb(t):
    rng = np.random.default_rng(t)
    acc = rng.integers(-2000, 2000, (t, G.ROWS, 3), dtype=np.int32)
    coords = tuple(jnp.asarray(np.moveaxis(acc[:, c * 33 : (c + 1) * 33], 1, 2)) for c in range(3))
    want = jmsm.tree_reduce(coords)  # 3 x [1, N, 33]
    got = bls_msm.tree_reduce(torch.from_numpy(acc))
    assert got.shape == (1, G.ROWS, 3)
    for c in range(3):
        port = np.moveaxis(got[:, c * 33 : (c + 1) * 33].numpy(), 1, 2)
        assert (port == np.asarray(want[c])).all()


@pytest.mark.parametrize("n, k", [(5, 1), (5, 2), (5, 3), (32, 8), (1024, 1), (1024, 4), (9, 5)])
def test_padded_size_is_the_references_where_it_divides(n, k):
    t = padded_size(n, k)
    ref = bls_msm._pad(n, base=max(4, k))
    assert t % k == 0 and (t // k) & (t // k - 1) == 0 and t >= n
    assert t == ref or ref % k


# -- round step -----------------------------------------------------------------


@pytest.fixture(scope="module")
def round_inputs(keys, batch):
    """The prep arrays of tests/test_parallel.py's round step (16 rows)
    and the Figure-1 wave-1 tensors."""
    args = TPUVerifier(keys[0])._prepare(batch, 16)
    exists, strong, _ = fixtures.figure1_tensors()
    return args, np.ascontiguousarray(strong[4:1:-1]), exists[4]


@pytest.fixture(scope="module")
def jax_steps(round_inputs):
    args, strong_wave, exists_r4 = round_inputs
    step = jax_round_step(jax_mesh(8), quorum=3)
    out = {}
    for leader in range(4):
        acc, commit, votes = step(*(jnp.asarray(a) for a in args), jnp.asarray(strong_wave),
                                  jnp.asarray(exists_r4), jnp.int32(leader))
        out[leader] = (np.asarray(acc), bool(commit), np.asarray(votes))
    return out


@pytest.mark.parametrize("leader", [0, 3])
def test_round_step_equals_jax(round_inputs, jax_steps, want, leader):
    args, strong_wave, exists_r4 = round_inputs
    step = make_round_step(M.make_mesh(2, device="cpu"), quorum=3)
    accept, commit, votes = step(*args, strong_wave, exists_r4, leader)
    j_accept, j_commit, j_votes = jax_steps[leader]
    assert (accept.numpy() == j_accept).all() and accept[:11].tolist() == want
    assert bool(commit) == j_commit and (votes.numpy() == j_votes).all()


def test_round_step_votes_for_every_leader(round_inputs, jax_steps):
    from dag_rider_tpu_torch.ops import dag_kernels as T

    _, strong_wave, exists_r4 = round_inputs
    for leader, (_, j_commit, j_votes) in jax_steps.items():
        commit, votes = T.wave_commit_votes(torch.from_numpy(strong_wave),
                                            torch.from_numpy(exists_r4), leader, quorum=3)
        assert (votes.numpy() == j_votes).all() and bool(commit) == j_commit
        host = T.reach_chain_np(strong_wave)[:, leader] & exists_r4
        assert (votes.numpy() == host).all()


# -- Simulation(verifier="sharded") ---------------------------------------------


def _run(sim):
    sim.submit_blocks(per_process=2)
    for _ in range(8):
        sim.run(max_messages=12)
    sim.check_agreement()
    return [[(v.id.round, v.id.source, v.digest()) for v in d] for d in sim.deliveries]


def test_sharded_simulation_commits_as_cpu_and_jax(monkeypatch):
    from dag_rider_tpu.config import Config as JConfig
    from dag_rider_tpu.consensus.simulator import Simulation as JSimulation

    cfg = dict(n=4, coin="round_robin", propose_empty=True)
    cpu_logs = _run(Simulation(Config(**cfg), verifier="cpu"))
    monkeypatch.setenv("DAGRIDER_MESH", "2")  # two CPU entries: the split and the fold
    sim = Simulation(Config(**cfg), verifier="sharded", device="cpu")
    shared = sim.processes[0].verifier
    assert isinstance(shared, ShardedCUDAVerifier) and shared.mesh_devices == 2
    assert all(p.verifier is shared for p in sim.processes)
    logs = _run(sim)
    assert len(logs[0]) > 4 and logs == cpu_logs
    monkeypatch.delenv("DAGRIDER_MESH")
    jax_logs = _run(JSimulation(JConfig(**cfg), verifier="sharded"))
    assert jax_logs == logs
    imb = [s for p in sim.processes for s in p.metrics.verify_shard_imbalance]
    assert imb and "verify_shard_imbalance_p50" in sim.processes[0].metrics.snapshot()
    assert sim._verify_pipe.stats()["mesh_devices"] == 2
