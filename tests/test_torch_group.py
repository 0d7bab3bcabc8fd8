"""Port group layer and comb path vs the JAX package — raw limbs and bits.

The plain torch versions behind the CUDA wrappers of
``dag_rider_tpu_torch.ops.cuda_group`` are held against the Pallas kernel
bodies of ``dag_rider_tpu/ops/pallas_group.py``, run on mock refs as
tests/test_pallas_group.py runs them, or against the jnp path those
bodies are pinned to: raw coordinates for padd and the tree, accept bits
for the finish tail. Then the whole comb core: on-device key tables entry
for entry, and accept masks on valid and adversarial batches. Exact
equality throughout (integer arithmetic). On CPU tensors no kernel
launches.
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dag_rider_tpu.core.types import Block, Vertex, VertexID
from dag_rider_tpu.crypto import ed25519 as host
from dag_rider_tpu.ops import comb as JC, curve as JCV, field as JF, pallas_group as PG
from dag_rider_tpu.verifier import tpu as JT
from dag_rider_tpu.verifier.base import KeyRegistry as JKeyRegistry
from dag_rider_tpu.verifier.base import VertexSigner as JSigner
from dag_rider_tpu.verifier.cpu import CPUVerifier as JCPUVerifier
from dag_rider_tpu_torch.ops import comb as TC, cuda_group as CG
from dag_rider_tpu_torch.verifier import cuda as TV
from test_comb import _adversarial
from test_verifier_tpu import corruptions


class _Ref:
    """Minimal stand-in for a pallas VMEM ref: slice-read, slice-write."""

    def __init__(self, arr):
        self.arr = np.array(arr)

    @property
    def shape(self):
        return self.arr.shape

    def __getitem__(self, idx):
        return jnp.asarray(self.arr[idx])

    def __setitem__(self, idx, val):
        self.arr[idx] = np.asarray(val)


def _host_points(m, start=1):
    acc = host.B
    for _ in range(start - 1):
        acc = host.point_add(acc, host.B)
    out = np.zeros((m, 4, 22), np.int32)
    for i in range(m):
        for c in range(4):
            out[i, c] = JF.to_limbs(acc[c] % JF.P_INT)
        acc = host.point_add(acc, host.B)
    return out


def _random_reduced(shape, seed):
    """Reduced limbs that are no curve point: the kernels' arithmetic is
    defined on every reduced input, not only on the curve."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-8191, 8192, size=(*shape, 22), dtype=np.int32)
    x[..., 0] = rng.integers(-16383, 16384, size=shape, dtype=np.int32)
    return x


def _lm(pts):  # [m, 4, 22] -> limb-major [88, m]
    return np.ascontiguousarray(np.moveaxis(pts, 0, -1).reshape(PG.ROWS, pts.shape[0]))


def _pallas_padd(p_lm, q_lm):
    out = _Ref(np.zeros_like(p_lm))
    PG._padd_xx_kernel(_Ref(p_lm), _Ref(q_lm), out)
    return out.arr


@pytest.fixture(autouse=True)
def _no_kernel_launches():
    CG.reset_launches()
    yield
    assert CG.LAUNCHES == {"padd_xx": 0, "finish_check": 0, "pow22523": 0}


@pytest.mark.parametrize("kind", ["curve", "random"])
def test_padd_xx_plain_matches_pallas_body(kind):
    if kind == "curve":
        p_np, q_np = _host_points(8, start=1), _host_points(8, start=9)
    else:
        p_np, q_np = _random_reduced((8, 4), 3), _random_reduced((8, 4), 4)
    want = _pallas_padd(_lm(p_np), _lm(q_np))
    got = CG.padd_xx(torch.from_numpy(_lm(p_np)), torch.from_numpy(_lm(q_np)))
    assert (got.numpy() == want).all()


def test_padd_xx_identity_is_neutral():
    p_np = _host_points(2, start=3)
    ident = np.zeros((2, 4, 22), np.int32)
    ident[:, 1] = JF.ONE
    ident[:, 2] = JF.ONE
    out = CG.padd_xx(torch.from_numpy(_lm(ident)), torch.from_numpy(_lm(p_np)))
    out = out.numpy().reshape(4, 22, 2)

    def affine(coords):  # [4, 22] -> (x, y)
        X, Y, Z = (JF.from_limbs(coords[c]) % JF.P_INT for c in range(3))
        zi = pow(Z, JF.P_INT - 2, JF.P_INT)
        return X * zi % JF.P_INT, Y * zi % JF.P_INT

    for i in range(2):
        assert affine(out[:, :, i]) == affine(p_np[i])


def test_padd_xx_rejects_bad_operands():
    good = torch.zeros((88, 4), dtype=torch.int32)
    with pytest.raises(TypeError):
        CG.padd_xx(good.long(), good.long())
    with pytest.raises(ValueError):
        CG.padd_xx(good[:80], good[:80])
    with pytest.raises(ValueError):
        CG.padd_xx(good.t().contiguous().t(), good)  # lanes not contiguous
    with pytest.raises(ValueError):
        CG.padd_xx(good, good[:, :2])


def test_tree_sum_matches_pallas_tree_and_plain_twin():
    """[3, 2, 8, 4, 22] entries: the port's tree (padd per level) equals
    the Pallas tree (the kernel body per level, tree_sum_xyzt's layout and
    first-half/second-half pairing) and the plain comb.tree_sum_packed."""
    entries = _random_reduced((3, 2, 8, 4), 5)
    flat, m = 6, 8
    x = np.moveaxis(entries.reshape(flat, m, 4, 22), 0, -1)
    x = np.moveaxis(x, 0, -2).reshape(PG.ROWS, m * flat)
    while m > 1:
        half = m // 2 * flat
        x = _pallas_padd(np.ascontiguousarray(x[:, :half]), np.ascontiguousarray(x[:, half:]))
        m //= 2
    want = np.moveaxis(np.moveaxis(x.reshape(4, 22, 3, 2), 1, -1), 0, -2)
    got = CG.tree_sum_xyzt(torch.from_numpy(entries))
    assert got.shape == (3, 2, 4, 22)
    assert (got.numpy() == want).all()
    assert torch.equal(TC.tree_sum_packed(torch.from_numpy(entries)), got)


def _finish_cases():
    """(r_y limbs, sign, acc) rows from a real signature: valid, wrong lhs,
    a y with no square root, and x == 0 with the sign bit set."""
    sk, pk = host.generate_keypair(b"\x07" * 32)
    msg = b"finish-kernel-test"
    sig = host.sign(sk, msg)
    r_int = int.from_bytes(sig[:32], "little")
    r_sign, r_y = r_int >> 255, r_int & ((1 << 255) - 1)
    s = int.from_bytes(sig[32:], "little")
    k = int.from_bytes(hashlib.sha512(sig[:32] + pk + msg).digest(), "little") % host.L
    lhs = host.scalar_mult(s, host.B)
    ka = host.scalar_mult(k, host.point_decompress(pk))

    def limbs(pt):
        return np.stack([JF.to_limbs(c % JF.P_INT) for c in pt])

    no_root_y = next(y for y in range(2, 100) if host._recover_x(y, 0) is None)
    cases = [
        (r_y, r_sign, limbs(lhs), limbs(ka)),  # valid
        (r_y, r_sign, limbs(host.point_add(lhs, host.B)), limbs(ka)),  # wrong lhs
        (r_y, 1 - r_sign, limbs(lhs), limbs(ka)),  # other root
        (no_root_y, 0, limbs(lhs), limbs(ka)),  # no square root
        (1, 1, limbs(host.IDENTITY), limbs(host.IDENTITY)),  # x == 0, sign set
        (1, 0, limbs(host.IDENTITY), limbs(host.IDENTITY)),  # identity, valid
    ]
    y = np.stack([JF.to_limbs(c[0]) for c in cases])
    sign = np.array([c[1] for c in cases], np.int32)
    acc = np.stack([np.stack([c[2], c[3]]) for c in cases]).astype(np.int32)
    return y, sign, acc


def test_finish_check_plain_matches_jnp_tail():
    y, sign, acc = _finish_cases()
    lhs = JC.unpack_point(jnp.asarray(acc[:, 0]))
    ka = JC.unpack_point(jnp.asarray(acc[:, 1]))
    r_point, r_valid = JCV.decompress(jnp.asarray(y), jnp.asarray(sign))
    want = np.asarray(JCV.points_equal(lhs, JCV.padd(r_point, ka)) & r_valid)
    got = CG.finish_check(torch.from_numpy(y), torch.from_numpy(sign), torch.from_numpy(acc))
    assert got.dtype == torch.bool
    assert (got.numpy() == want).all()
    assert want.tolist() == [True, False, False, False, False, True]


def test_pow22523_plain_matches_field():
    z = _random_reduced((6,), 6)
    want = np.asarray(JF.pow22523(jnp.asarray(z)))
    got = CG.pow22523(torch.from_numpy(np.ascontiguousarray(z.T)))
    assert (got.numpy() == want.T).all()


@pytest.mark.parametrize("op", ["padd", "pdouble", "pneg", "pselect", "points_equal"])
def test_curve_ops_match_jax(op):
    """The port's curve.* on the same points as the JAX curve.*: raw limbs
    for the point ops, bits for the equality (equal and unequal pairs)."""
    from dag_rider_tpu_torch.ops import curve as TCV

    p_np, q_np = _host_points(6, start=2), _host_points(6, start=5)
    q_np[::2] = p_np[::2]  # equal pairs for points_equal
    jp, jq = (tuple(jnp.asarray(x[:, c]) for c in range(4)) for x in (p_np, q_np))
    tp, tq = (tuple(torch.from_numpy(x[:, c].copy()) for c in range(4)) for x in (p_np, q_np))
    cond = np.arange(6) % 3 == 0
    args = {
        "padd": ((jp, jq), (tp, tq)),
        "pdouble": ((jp,), (tp,)),
        "pneg": ((jp,), (tp,)),
        "pselect": ((jnp.asarray(cond), jp, jq), (torch.from_numpy(cond), tp, tq)),
        "points_equal": ((jp, jq), (tp, tq)),
    }[op]
    want = getattr(JCV, op)(*args[0])
    got = getattr(TCV, op)(*args[1])
    if op == "points_equal":
        assert got.tolist() == np.asarray(want).tolist() == [True, False] * 3
    else:
        for w, g in zip(want, got):
            assert (g.numpy() == np.asarray(w)).all()


# ---------------------------------------------------------------------------
# comb tables and the comb verify core
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    """n = 8 registry (the shapes of tests/test_verifier_tpu.py), both
    packages' key tables, and a signed round."""
    reg, seeds = JKeyRegistry.generate(8)
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
    jv = JT.TPUVerifier(reg)
    jtables = JC.build_key_tables(
        jnp.asarray(jv._a_x), jnp.asarray(jv._a_y), jnp.asarray(jv._a_t)
    )
    ttables = TC.build_key_tables(
        torch.from_numpy(jv._a_x), torch.from_numpy(jv._a_y), torch.from_numpy(jv._a_t)
    )
    return reg, vs, jv, np.asarray(jtables), ttables


def test_build_key_tables_matches_jax_entry_for_entry(setup):
    *_, jtables, ttables = setup
    assert ttables.shape == (8, 64, 16, 4, 22) and ttables.dtype == torch.int32
    assert (ttables.numpy() == jtables).all()


def test_base_table_matches_jax():
    assert (TC.base_table_xyzt() == JC.base_table_xyzt()).all()


def test_comb_verify_core_matches_jax_on_adversarial_batch(setup):
    reg, vs, jv, jtables, ttables = setup
    batch = vs + corruptions(vs) + _adversarial(vs[:6])  # 26 rows -> bucket 32
    u8, i32 = jv._prepare(batch, 32, comb=True)
    want = np.asarray(
        JT._device_verify_comb(
            jnp.asarray(u8),
            jnp.asarray(i32),
            JC.pad_rows(jnp.asarray(jtables)),
            JC.pad_rows(jnp.asarray(JC.base_table_xyzt())),
            impl="jnp",
        )
    )
    x = TV.unpack(torch.from_numpy(u8), torch.from_numpy(i32))
    got = TC.comb_verify_core(
        x.s_nibbles, x.k_nibbles, x.key_idx,
        ttables.reshape(-1, 88),
        torch.from_numpy(TC.base_table_xyzt()).reshape(-1, 88),
        x.a_valid, x.r_y, x.r_sign, x.prevalid,
    )
    assert (got.numpy() == want).all()
    oracle = JCPUVerifier(reg).verify_batch(batch)
    assert got.tolist() == oracle + [False] * (32 - len(batch))
    assert oracle[:8] == [True] * 8 and not any(oracle[8:])
