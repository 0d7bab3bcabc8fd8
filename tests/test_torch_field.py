"""Port field layer (dag_rider_tpu_torch.ops.field) vs the JAX field — limb for limb.

The same seeded operands go through both packages as numpy arrays; every
op must return the same int32 limbs (not just the same value mod p), since
the comb tree feeds raw limbs to the finish tail. Exact equality: all of
the arithmetic is integer.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dag_rider_tpu.ops import field as JF
from dag_rider_tpu_torch.ops import cuda_field, cuda_group, field as TF

P = JF.P_INT
EDGE = [0, 1, 2, 19, P - 1, P - 2, P - 19, P, P + 1, 2**252, 2**255 - 20,
        (P + 1) // 2, 2**264 - 1]
# limbs at the reduced invariant's bounds (tests/test_field.py patterns)
PATTERNS = [
    np.full(22, 4095, dtype=np.int32),
    np.full(22, -4095, dtype=np.int32),
    np.array([16383] + [8191] * 21, dtype=np.int32),
    np.array([-16383] + [-8191] * 21, dtype=np.int32),
    np.array([2560] + [4095] * 18 + [-1, 0, 4096], dtype=np.int32),
]


def _operands(seed: int) -> np.ndarray:
    """[N, 22] int32: canonical limbs of random and edge values, random
    signed limbs inside the invariant, and the boundary patterns."""
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(24)]
    canon = np.stack([JF.to_limbs(v) for v in vals + EDGE])
    signed = rng.integers(-8191, 8192, size=(24, 22), dtype=np.int32)
    signed[:, 0] = rng.integers(-16383, 16384, size=24, dtype=np.int32)
    return np.concatenate([canon, signed, np.stack(PATTERNS)]).astype(np.int32)


@pytest.fixture(scope="module")
def ab():
    a = _operands(1)
    b = _operands(2)[::-1].copy()
    return a, b


def _both(name, *args):
    jout = getattr(JF, name)(*(jnp.asarray(x) for x in args))
    tout = getattr(TF, name)(*(torch.from_numpy(x) for x in args))
    return np.asarray(jout), tout.numpy()


@pytest.mark.parametrize("name", ["add", "sub", "mul", "eq"])
def test_binary_ops_limb_identical(ab, name):
    want, got = _both(name, *ab)
    assert want.dtype == got.dtype or name == "eq"
    assert (want == got).all()


@pytest.mark.parametrize(
    "name", ["carry", "neg", "square", "canonical", "is_zero", "parity", "pow22523"]
)
def test_unary_ops_limb_identical(ab, name):
    want, got = _both(name, ab[0])
    assert (want == got).all()


def test_wide_carry_and_mul_small(ab):
    """carry(steps=3) on scaled limbs and mul_small, as curve.padd uses them."""
    x = (ab[0] * 2048).astype(np.int32)
    assert (np.asarray(JF.carry(jnp.asarray(x), steps=3))
            == TF.carry(torch.from_numpy(x), steps=3).numpy()).all()
    assert (np.asarray(JF.mul_small(jnp.asarray(ab[0]), 2))
            == TF.mul_small(torch.from_numpy(ab[0]), 2).numpy()).all()


def test_select_and_values(ab):
    a, b = ab
    cond = np.arange(a.shape[0]) % 3 == 0
    want = np.asarray(JF.select(jnp.asarray(cond), jnp.asarray(a), jnp.asarray(b)))
    got = TF.select(torch.from_numpy(cond), torch.from_numpy(a), torch.from_numpy(b))
    assert (want == got.numpy()).all()
    # and the product is right mod p, not merely equal to JAX
    prod = TF.canonical(TF.mul(torch.from_numpy(a), torch.from_numpy(b))).numpy()
    for i in range(a.shape[0]):
        want_v = TF.from_limbs(a[i]) * TF.from_limbs(b[i]) % P
        assert TF.from_limbs(prod[i]) == want_v


def test_constants_match_jax_and_cuda_source():
    for name in ("ONE", "D", "D2", "SQRT_M1", "BIG_P", "P_LIMBS"):
        assert (getattr(TF, name) == getattr(JF, name)).all(), name
    assert (TF.TOP_FOLD, TF.LIMBS, TF.LIMB_BITS) == (JF.TOP_FOLD, JF.LIMBS, JF.LIMB_BITS)
    src = (Path(TF.__file__).parents[1] / "csrc" / "ed25519_group.cu").read_text()
    for name in ("D", "D2", "SQRT_M1", "BIG_P"):
        m = re.search(rf"#define {name}_LIMBS \{{([^}}]*)\}}", src)
        limbs = [int(v) for v in m.group(1).replace("\\", " ").split(",")]
        assert limbs == [int(v) for v in getattr(TF, name)], name


def test_mul_wrapper_takes_plain_version_on_cpu(ab):
    a, b = (torch.from_numpy(x) for x in ab)
    cuda_field.reset_launches()
    assert torch.equal(cuda_field.mul(a, b), TF.mul(a, b))
    assert cuda_field.LAUNCHES["field_mul"] == 0  # no kernel on a CPU tensor
    with pytest.raises(TypeError):
        cuda_field.mul(a.long(), b.long())
    with pytest.raises(ValueError):
        cuda_group.pow22523(a)  # [N, 22] is not limb-major [22, N]
