"""The port's 8-bit comb vs the JAX package: tables and masks.

``DAGRIDER_COMB_BITS=8`` builds [n, 32, 256, 4, 22] key tables (256-entry
windows in the block order of ``DIGIT_POS8``) and sums 32 gathered entries
a side through the same tree and finish kernels as the 4-bit path (their
plain versions on the CPU). At n = 4 every table entry, the base table's
included, equals the JAX ``build_key_tables8``'s limb for limb, and the
accept masks on the corrupted rows of tests/test_comb.py (``_adversarial``)
and its seeded fuzz equal the JAX package's masks and the port's 4-bit
masks. (The JAX package's own tests hold its 8-bit device masks to its
host oracle, so the JAX masks here are its ``CPUVerifier``'s: its jnp
8-bit core takes about half a minute a batch shape to compile on a CPU.)
"""

import dataclasses
import random

import jax.numpy as jnp
import numpy as np
import pytest

from test_comb import _adversarial

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

from dag_rider_tpu.core.types import Block, Vertex, VertexID
from dag_rider_tpu.crypto import ed25519 as jed
from dag_rider_tpu.ops import comb as jcomb
from dag_rider_tpu.ops import field as jF
from dag_rider_tpu.verifier.base import KeyRegistry as JKeyRegistry
from dag_rider_tpu.verifier.base import VertexSigner as JSigner
from dag_rider_tpu.verifier.cpu import CPUVerifier as JCPUVerifier
from dag_rider_tpu_torch.ops import comb
from dag_rider_tpu_torch.verifier.base import KeyRegistry
from dag_rider_tpu_torch.verifier.cuda import CUDAVerifier

N_KEYS = 4


@pytest.fixture(scope="module")
def keys():
    return JKeyRegistry.generate(N_KEYS)


@pytest.fixture(scope="module")
def port8(keys):
    """The port's 8-bit verifier with its tables built."""
    mp = pytest.MonkeyPatch()
    mp.setenv("DAGRIDER_COMB_BITS", "8")
    try:
        v = CUDAVerifier(KeyRegistry(keys[0].public_keys), device="cpu")
    finally:
        mp.undo()
    v.comb_tables()
    return v


@pytest.fixture(scope="module")
def batch(keys):
    """Six signed vertices over the four keys, the six corruptions of
    ``_adversarial``, and 24 seeded fuzz rows (test_comb.py's recipe)."""
    reg, seeds = keys
    signers = [JSigner(s) for s in seeds]
    vs = [
        signers[i % N_KEYS].sign_vertex(
            Vertex(
                id=VertexID(2, i % N_KEYS),
                block=Block((f"tx-{i}".encode(),)),
                strong_edges=(VertexID(1, 0), VertexID(1, 1), VertexID(1, 2)),
            )
        )
        for i in range(6)
    ]
    rng = random.Random(1234)
    fuzz = []
    for _ in range(24):
        v = rng.choice(vs)
        mode = rng.randrange(5)
        if mode == 0:  # signature damage
            sig = bytearray(v.signature)
            for _ in range(rng.randrange(1, 4)):
                sig[rng.randrange(64)] ^= 1 << rng.randrange(8)
            v = dataclasses.replace(v, signature=bytes(sig))
        elif mode == 1:  # payload damage
            v = dataclasses.replace(v, block=Block((rng.randbytes(rng.randrange(1, 40)),)))
        elif mode == 2:  # source redirect
            v = dataclasses.replace(v, id=VertexID(v.id.round, rng.randrange(reg.n)))
        elif mode == 3:  # edge tamper
            v = dataclasses.replace(
                v,
                strong_edges=tuple(
                    VertexID(e.round, (e.source + 1) % reg.n) for e in v.strong_edges
                ),
            )
        fuzz.append(v)
    return vs + _adversarial(vs) + fuzz


def test_digit_positions_equal_jax():
    assert np.array_equal(comb.DIGIT_POS8, jcomb.DIGIT_POS8)
    assert sorted(comb.DIGIT_POS8.tolist()) == list(range(comb.ENTRIES8))


def test_key_and_base_tables8_equal_jax(port8):
    """One JAX build over the four keys and the base point B (as a fifth
    key) against the port's flat key and base tables."""
    bx, by, _, bt = jed.B
    rows = [
        np.concatenate([a, jF.to_limbs(c)[None]])
        for a, c in ((port8._a_x, bx), (port8._a_y, by), (port8._a_t, bt))
    ]
    want = np.asarray(jcomb.build_key_tables8(*(jnp.asarray(r) for r in rows)))
    assert want.shape == (N_KEYS + 1, 32, 256, 4, 22)
    key_tables, b_table = port8.comb_tables()
    assert key_tables.shape == (N_KEYS * 32 * 256, 88) and b_table.shape == (32 * 256, 88)
    assert np.array_equal(key_tables.numpy(), want[:N_KEYS].reshape(-1, 88))
    assert np.array_equal(b_table.numpy(), want[N_KEYS].reshape(-1, 88))


def test_masks_equal_jax_and_4bit(keys, port8, batch):
    want = JCPUVerifier(keys[0]).verify_batch(batch)
    assert want[:6] == [True] * 6 and not any(want[6:12]) and not all(want[12:])
    port4 = CUDAVerifier(port8.registry, comb=True, device="cpu")
    assert port8.u8_cols == 67 and port4.u8_cols == 131
    assert port8.verify_batch(batch) == want
    assert port4.verify_batch(batch) == want
    # streamed in chunks of 16 through the async prep path, 8-bit layout
    port8.fixed_bucket = 16
    try:
        assert port8.verify_rounds([batch[:20], [], batch[20:]]) == [want[:20], [], want[20:]]
    finally:
        port8.fixed_bucket = None


def test_tree_at_32_entries_equals_plain(port8, batch):
    """The 8-bit gather hands the tree [B, 2, 32, 4, 22]; its sum equals
    a sequential left fold of the 32 entries' group law (same point,
    projectively), and the mask built on it is the verifier's."""
    import torch

    from dag_rider_tpu_torch.ops import cuda_group
    from dag_rider_tpu_torch.verifier.cuda import unpack8

    u8, i32 = port8.prepare_batch(batch)
    x = unpack8(torch.from_numpy(u8), torch.from_numpy(i32))
    tables, b_tab = port8.comb_tables()
    entries = comb.gather_entries8(x.s_nibbles, x.k_nibbles, x.key_idx, tables, b_tab)
    assert entries.shape == (u8.shape[0], 2, 32, 4, 22)
    acc = cuda_group.tree_sum_xyzt(entries)
    fold = entries[..., 0, :, :]
    for m in range(1, 32):
        fold = comb.padd_cached(fold, comb.to_cached(entries[..., m, :, :]))
    assert _affine_all(acc) == _affine_all(fold)
    ok = cuda_group.finish_check(x.r_y, x.r_sign, acc) & x.a_valid & x.prevalid
    assert ok.tolist()[: len(batch)] == port8.verify_batch(batch)


def _affine_all(points):
    """Affine (x, y) of every packed XYZT point in a [..., 4, 22] tensor."""
    from dag_rider_tpu_torch.ops import field as F

    out = []
    for p in points.reshape(-1, 4, 22).numpy():
        xs, ys, zs = (F.from_limbs(p[i]) % F.P_INT for i in range(3))
        zi = pow(zs, F.P_INT - 2, F.P_INT)
        out.append((xs * zi % F.P_INT, ys * zi % F.P_INT))
    return out
