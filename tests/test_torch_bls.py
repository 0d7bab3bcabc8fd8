"""Port BLS12-381 field, group law and G1 MSM vs the JAX package — raw limbs.

The torch twins of ``dag_rider_tpu/ops/field381.py`` and ``ops/bls_msm.py``
(``dag_rider_tpu_torch.ops.field381`` / ``bls_msm``) and the plain version
behind the CUDA wrapper ``cuda_group381.padd381_xx`` are held against the
JAX functions on the same numpy inputs: equal int32 limbs everywhere
(tolerance 0), since the MSM's tree and Horner chain consume raw limbs.
The kernel body ``pallas_group381._padd381_core`` runs directly on row
lists, as ``tests/test_pallas_group381.py`` runs it (interpret-mode
``pallas_call`` takes minutes per launch). The MSM results are then held
against the host group law, and the threshold aggregate against the JAX
host aggregate, byte for byte. On CPU tensors no kernel launches.
"""

import random
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dag_rider_tpu.crypto import bls12381 as jbls, threshold as jth
from dag_rider_tpu.ops import bls_msm as JM, field381 as JF, pallas_group381 as PG
from dag_rider_tpu_torch.crypto import threshold as th
from dag_rider_tpu_torch.ops import bls_msm as TM, cuda_group381 as G, field381 as TF

CU_SOURCE = Path(TM.__file__).resolve().parents[1] / "csrc" / "bls381_group.cu"


def _reduced(shape, seed):
    """Signed limbs in the reduced range every op accepts."""
    rng = np.random.default_rng(seed)
    return rng.integers(-(1 << 7), 1 << 12, (*shape, TF.LIMBS)).astype(np.int32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _eq(jax_out, torch_out):
    np.testing.assert_array_equal(np.asarray(jax_out), torch_out.numpy())


def _rand_points(k, seed):
    rng = random.Random(seed)
    return [jbls.g1_mul(rng.randrange(1, jbls.R)) for _ in range(k)]


def _lm(xyz):
    """Points int32 [k, 3, 33] -> limb-major tensor [99, k]."""
    return _t(xyz.reshape(len(xyz), G.ROWS).T)


def _coord(x, c):
    """Coordinate c of limb-major points [99, ...] -> [..., 33]."""
    return x[c * TF.LIMBS : (c + 1) * TF.LIMBS].movedim(0, -1)


def _xyz(points):
    """Host affine points (None = identity) -> int32 [k, 3, 33]."""
    out = np.zeros((len(points), 3, TF.LIMBS), np.int32)
    for i, pt in enumerate(points):
        if pt is None:
            out[i, 1] = TF.ONE
        else:
            out[i] = [TF.to_limbs(pt[0]), TF.to_limbs(pt[1]), TF.ONE]
    return out


@pytest.fixture(autouse=True)
def _no_launches():
    G.reset_launches()
    yield
    assert G.LAUNCHES == {"padd381_xx": 0}, "a CPU tensor launched a kernel"


# --- field381 --------------------------------------------------------------


def test_constants_equal_jax():
    for name in ("FOLD", "_FOLD_TOP", "ZERO", "ONE", "_BIG_P"):
        np.testing.assert_array_equal(getattr(TF, name), getattr(JF, name), err_msg=name)
    for k in (1, 2, 4, 8):
        np.testing.assert_array_equal(TF._KP[k], JF._KP[k])
    assert (TF.LIMBS, TF.LIMB_BITS, TF._NCOLS, TF.P_INT) == (
        JF.LIMBS, JF.LIMB_BITS, JF._NCOLS, JF.P_INT)
    assert TM.R_INT == JM.R_INT == jbls.R


def test_kernel_fold_table_equals_field381():
    """The literal ``kFold`` table of csrc/bls381_group.cu is FOLD."""
    src = CU_SOURCE.read_text()
    body = src[src.index("kFold[35][32] = {"):]
    body = body[: body.index("};")]
    body = re.sub(r"//[^\n]*", "", body)
    vals = [int(v) for v in re.findall(r"-?\d+", body)[2:]]
    np.testing.assert_array_equal(np.array(vals, np.int32).reshape(35, 32), TF.FOLD)


def test_host_limb_helpers_equal_jax():
    rng = random.Random(3)
    vals = [rng.randrange(2**396) for _ in range(20)] + [0, 2**396 - 1, TF.P_INT]
    for v in vals:
        np.testing.assert_array_equal(TF.to_limbs(v), JF.to_limbs(v))
        assert TF.from_limbs(TF.to_limbs(v)) == v
    np.testing.assert_array_equal(TF.to_limbs_bulk(vals), JF.to_limbs_bulk(vals))
    signed = _reduced((4,), 9)
    assert [TF.from_limbs(r) for r in signed] == [JF.from_limbs(r) for r in signed]


@pytest.mark.parametrize("op", ["carry", "add", "sub", "neg", "mul", "square",
                                "mul_small", "canonical", "is_zero", "eq", "select"])
def test_field_op_limbs_equal_jax(op):
    a, b = _reduced((64,), 1), _reduced((64,), 2)
    b[:8] = a[:8]  # equal operands: eq/is_zero true rows
    ta, tb = _t(a), _t(b)
    if op == "carry":
        _eq(JF.carry(a + b, steps=3), TF.carry(ta + tb, steps=3))
    elif op in ("add", "sub", "mul", "eq"):
        _eq(getattr(JF, op)(a, b), getattr(TF, op)(ta, tb))
    elif op == "mul_small":
        _eq(JF.mul_small(a, 12), TF.mul_small(ta, 12))
    elif op == "is_zero":
        _eq(JF.is_zero(a - b), TF.is_zero(ta - tb))
    elif op == "select":
        cond = np.arange(64) % 3 == 0
        _eq(JF.select(cond, a, b), TF.select(torch.from_numpy(cond), ta, tb))
    else:
        _eq(getattr(JF, op)(a), getattr(TF, op)(ta))


def test_field_mul_chain_worst_case_equals_jax_and_host():
    """50 chained squarings (tests/test_bls_msm.py's worst case for the
    reduced invariant): raw limbs equal JAX at every step, and the value
    equals the host product chain."""
    x = random.Random(1234).randrange(TF.P_INT)
    j, t, host = JF.to_limbs(x), _t(TF.to_limbs(x)), x
    for _ in range(50):
        j, t, host = JF.mul(j, j), TF.mul(t, t), host * host % TF.P_INT
        _eq(j, t)
    assert TF.from_limbs(TF.canonical(t).numpy()) == host


def test_canonical_is_unique_representative():
    """canonical() of signed reduced limbs is the value mod p, in [0, p),
    with strict 12-bit limbs."""
    x = _reduced((32,), 5)
    x[0] = 0
    x[1, :] = -(1 << 7)  # negative value
    x[2] = TF.to_limbs(TF.P_INT)  # p itself
    got = TF.canonical(_t(x)).numpy()
    assert ((got >= 0) & (got <= TF.LIMB_MASK)).all()
    for row, canon in zip(x, got):
        assert TF.from_limbs(canon) == TF.from_limbs(row) % TF.P_INT


# --- group law -------------------------------------------------------------


@pytest.mark.parametrize("case", ["generic", "double", "inverse", "identity"])
def test_padd_limbs_equal_jax_and_value_equals_host(case):
    p1, p2 = _rand_points(2, len(case))
    if case == "double":
        p2 = p1
    elif case == "inverse":
        p2 = jbls.g1_neg(p1)
    elif case == "identity":
        p2 = None
    a, b = _xyz([p1]), _xyz([p2])
    want = JM.padd(tuple(a[:, c] for c in range(3)), tuple(b[:, c] for c in range(3)))
    got = TM.padd(tuple(_t(a[:, c]) for c in range(3)), tuple(_t(b[:, c]) for c in range(3)))
    for w, g in zip(want, got):
        _eq(w, g)
    assert TM.unpack_point(*(c[0] for c in got)) == jbls.g1_add(p1, p2)


def _rows(arr):
    return [jnp.asarray(arr[:, i][None, :]) for i in range(TF.LIMBS)]


def test_padd381_plain_equals_pallas_core_on_rows():
    """The kernel's plain version vs the Pallas kernel body on REAL curve
    points (doublings, mixed and identity operands), the recipe of
    tests/test_pallas_group381.py."""
    pts, acc = [], jbls.G1_GEN
    for _ in range(5):
        pts.append(acc)
        acc = jbls.g1_double(acc)
    a = _xyz(pts)
    b = np.roll(a, 1, axis=0)
    b[0] = _xyz([None])[0]
    b[2] = a[2]  # a doubling lane
    rows_a = [_rows(a[:, c]) for c in range(3)]
    rows_b = [_rows(b[:, c]) for c in range(3)]
    core = PG._padd381_core(rows_a, rows_b)
    want = np.concatenate(
        [np.concatenate([np.asarray(r) for r in core[c]], axis=0) for c in range(3)])
    got = G.padd381_xx(_lm(a), _lm(b))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, G.padd381_xx_plain(_lm(a), _lm(b)))


def test_padd381_accepts_column_slices_and_single_lanes():
    x = _t(_reduced((8, 3), 11).reshape(8, -1).T.copy())  # [99, 8]
    full = G.padd381_xx(x[:, :4], x[:, 4:])
    one = G.padd381_xx(x[:, 1:2], x[:, 5:6])
    assert torch.equal(one[:, 0], full[:, 1])
    with pytest.raises(ValueError):
        G.padd381_xx(x[:, :4], x[:, 4:7])
    with pytest.raises(ValueError):
        G.padd381_xx(x[::2], x[1::2])
    with pytest.raises(TypeError):
        G.padd381_xx(x.long(), x.long())


@pytest.mark.parametrize("m", [1, 2, 8])
def test_tree_sum_xyz381_equals_jax_tree_reduce(m):
    """The tree (plain path on CPU) pairs the lanes as the JAX tree does."""
    ent = _xyz(_rand_points(3, m) + [None] * 5)[np.arange(6 * m) % 8]
    ent = ent.reshape(m, 6, 3, TF.LIMBS)  # [M, flat, 3, 33]
    x = _lm(ent.reshape(m * 6, 3, TF.LIMBS))  # lane = i * flat + f
    got = G.tree_sum_xyz381(x, m)  # [99, flat]
    want = JM.tree_reduce(tuple(ent[..., c, :] for c in range(3)))
    for c in range(3):
        _eq(want[c][0], _coord(got, c))
    with pytest.raises(ValueError):
        G.tree_sum_xyz381(x, 3)


def test_tables_equal_jax():
    p = _xyz(_rand_points(2, 21) + [None])
    want = JM._point_tables(tuple(p[:, c] for c in range(3)))  # [T, 16, 33]
    got = TM._point_tables(_lm(p))  # [16, 99, T]
    for c, w in enumerate(want):
        _eq(w, _coord(got.permute(1, 2, 0), c))


@pytest.mark.parametrize("k", [0, 1, 15, 0xDEADBEEF, jbls.R - 1])
def test_single_point_msm_matches_host(k):
    p = _rand_points(1, k % 97)[0]
    assert TM.msm([k], [p], device="cpu") == jbls.g1_mul(k, p)


# --- MSM -------------------------------------------------------------------


def _msm_inputs(t, seed):
    rng = random.Random(seed)
    scalars = [rng.randrange(jbls.R) for _ in range(t - 2)] + [0, 2**64 + 1]
    points = _rand_points(t - 3, seed) + [jbls.G1_GEN, None, jbls.g1_mul(7)]
    return scalars, points


@pytest.mark.parametrize("t", [4, 8])
def test_msm_kernel_raw_limbs_equal_jax(t):
    """X, Y, Z limbs of the whole MSM (tables, gather, tree, Horner) equal
    JAX ``msm_kernel(impl="jnp")`` on the same padded inputs, with a None
    point and a zero scalar among them."""
    scalars, points = _msm_inputs(t, t)
    arrays = JM.pack_inputs(scalars, points, t)
    for mine, theirs in zip(TM.pack_inputs(scalars, points, t), arrays):
        np.testing.assert_array_equal(mine, theirs)
    want = JM.msm_kernel(*(jnp.asarray(a) for a in arrays), impl="jnp")
    got = TM.msm_kernel(*(_t(a) for a in arrays))
    for w, g in zip(want, got):
        _eq(w, g)
    assert TM.unpack_point(*got) == jbls.g1_msm(scalars, points)


def test_window_sums_and_horner_equal_jax():
    scalars, points = _msm_inputs(4, 40)
    nib, px, py, pz = JM.pack_inputs(scalars, points, 4)
    want_w = JM.window_sums(jnp.asarray(nib), (px, py, pz))  # [64, 33] each
    got_w = TM.window_sums(_t(nib), _lm(np.stack([px, py, pz], axis=1)))  # [99, 64]
    for c, w in enumerate(want_w):
        _eq(w, _coord(got_w, c))
    got_h = TM.horner_combine(got_w)  # [99, 1]
    for c, w in enumerate(JM.horner_combine(want_w)):
        _eq(w, _coord(got_h, c)[0])


@pytest.mark.parametrize("n", [1, 3, 5])
def test_msm_and_sum_points_match_host(n):
    scalars, points = _msm_inputs(max(n, 3), 50 + n)
    scalars, points = scalars[-n:], points[-n:]
    assert TM.msm(scalars, points, device="cpu") == jbls.g1_msm(scalars, points)
    real = [p for p in points if p is not None]
    assert TM.sum_points(points, device="cpu") == jbls.g1_sum(real)


def test_msm_identity_results():
    assert TM.msm([0, 0], _rand_points(2, 60), device="cpu") is None
    p = _rand_points(1, 61)[0]
    assert TM.sum_points([p, jbls.g1_neg(p)], device="cpu") is None


def test_msm_without_card_raises_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.msm([1], [jbls.G1_GEN])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.sum_points([jbls.G1_GEN])
    assert TM.resolve_device("cpu") == torch.device("cpu")


# --- threshold aggregate -----------------------------------------------------


@pytest.fixture(scope="module")
def keys():
    jk = jth.ThresholdKeys.generate(7, 3)
    return jk, th.ThresholdKeys(jk.threshold, jk.group_pk, jk.share_pks, jk.share_sks)


def test_port_keygen_equals_jax(keys):
    jk, _ = keys
    pk = th.ThresholdKeys.generate(7, 3)
    assert (pk.group_pk, pk.share_pks, pk.share_sks) == (jk.group_pk, jk.share_pks, jk.share_sks)


@pytest.mark.parametrize("wave", [1, 2])
def test_aggregate_with_port_msm_byte_identical(keys, wave):
    jk, tk = keys
    shares = {i: th.sign_share(tk.share_sks[i], wave) for i in (6, 0, 4, 2)}
    assert shares == {i: jth.sign_share(jk.share_sks[i], wave) for i in shares}
    want = jth.aggregate(shares, jk.threshold)
    got = th.aggregate(shares, tk.threshold, msm=lambda s, p: TM.msm(s, p, device="cpu"))
    assert got == want == th.aggregate(shares, tk.threshold)
    assert th.verify_group(tk.group_pk, wave, got)
    assert th.leader_from_sigma(got, 7) == jth.leader_from_sigma(want, 7)
