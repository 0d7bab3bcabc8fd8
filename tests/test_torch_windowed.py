"""The windowed verify path (``comb=False``) of the port against the JAX package.

``field.invert``, ``curve.scalar_mul_var`` and ``curve.scalar_mul_base``
are step-for-step copies of their JAX twins: limbs exact. ``curve.verify_core``
and ``CUDAVerifier(comb=False, device="cpu")`` give the masks of the JAX
windowed program, of the comb path and of the host oracle on the corrupted
batches of ``tests/test_verifier_tpu.py`` and ``tests/test_comb.py``; the
card program of ``ops/windowed.py`` (the kernel wrappers, here their plain
versions) gives the same masks. Every batch pads to 16 rows, the shape the
JAX package's own windowed tests compile.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

from dag_rider_tpu.core.types import Block, Vertex, VertexID
from dag_rider_tpu.crypto import ed25519 as H
from dag_rider_tpu.ops import curve as JC, field as JF
from dag_rider_tpu.verifier.base import KeyRegistry, VertexSigner
from dag_rider_tpu.verifier.tpu import TPUVerifier, scalar_to_nibbles
from dag_rider_tpu_torch.ops import curve as C, field as F, windowed
from dag_rider_tpu_torch.verifier.cpu import CPUVerifier
from dag_rider_tpu_torch.verifier.cuda import CUDAVerifier
from test_comb import _adversarial
from test_curve import host_affine, to_limb_point
from test_verifier_tpu import corruptions


def _np(x):
    return np.asarray(x)


def _affine(pt, i):
    X, Y, Z = (F.from_limbs(F.canonical(c[i : i + 1])[0].numpy()) for c in pt[:3])
    zi = pow(Z, F.P_INT - 2, F.P_INT)
    return (X * zi % F.P_INT, Y * zi % F.P_INT)


def test_invert_matches_jax_limb_for_limb():
    rng = np.random.default_rng(7)
    z = rng.integers(-4095, 4096, (65, F.LIMBS), dtype=np.int32)
    z[0] = 0  # 0 maps to 0
    want = _np(jax.jit(JF.invert)(jnp.asarray(z)))
    got = F.invert(torch.from_numpy(z)).numpy()
    assert (got == want).all()
    assert F.from_limbs(F.canonical(torch.from_numpy(got[:1]))[0].numpy()) == 0
    x = int(F.from_limbs(z[3])) % F.P_INT
    assert int(F.from_limbs(F.canonical(torch.from_numpy(got[3:4]))[0].numpy())) == pow(
        x, F.P_INT - 2, F.P_INT)


@pytest.fixture(scope="module")
def curve_inputs():
    """The scalars of tests/test_curve.py:77-96, from its seed."""
    rng = random.Random(0xC0DE)
    ks_var = [0, 1, 2, 15, 16, 255, rng.randrange(H.L), H.L - 1, 2**252]
    ks_base = [0, 1, rng.randrange(H.L), H.L - 1]
    return ks_var, ks_base


def test_scalar_mul_var_matches_jax_limb_for_limb(curve_inputs):
    ks, _ = curve_inputs
    base = [np.repeat(_np(c), len(ks), axis=0) for c in to_limb_point(H.B)]
    nib = np.stack([scalar_to_nibbles(k) for k in ks])
    want = jax.jit(JC.scalar_mul_var)(jnp.asarray(nib), tuple(jnp.asarray(c) for c in base))
    got = C.scalar_mul_var(torch.from_numpy(nib), tuple(torch.from_numpy(c) for c in base))
    for w, g in zip(want, got):
        assert (g.numpy() == _np(w)).all()
    for i, k in enumerate(ks):
        assert _affine(got, i) == ((0, 1) if k == 0 else host_affine(H.scalar_mult(k, H.B)))


def test_scalar_mul_base_matches_jax_limb_for_limb(curve_inputs):
    _, ks = curve_inputs
    nib = np.stack([scalar_to_nibbles(k) for k in ks])
    want = jax.jit(JC.scalar_mul_base)(jnp.asarray(nib))
    got = C.scalar_mul_base(torch.from_numpy(nib))
    for w, g in zip(want, got):
        assert (g.numpy() == _np(w)).all()
    for i, k in enumerate(ks):
        assert _affine(got, i) == ((0, 1) if k == 0 else host_affine(H.scalar_mult(k, H.B)))


@pytest.fixture(scope="module")
def keys():
    return KeyRegistry.generate(8)


def _signed(keys, n):
    reg, seeds = keys
    return [
        VertexSigner(seeds[i]).sign_vertex(
            Vertex(
                id=VertexID(2, i),
                block=Block((f"tx-{i}".encode(),)),
                strong_edges=(VertexID(1, 0), VertexID(1, 1), VertexID(1, 2)),
            )
        )
        for i in range(n)
    ]


@pytest.fixture(scope="module")
def batches(keys):
    """Two 16-row batches: 4 signed rows and the 12 corruptions of
    tests/test_verifier_tpu.py; 6 signed rows and the 6 adversarial rows
    of tests/test_comb.py."""
    vs = _signed(keys, 8)
    return {
        "corruptions": vs[:4] + corruptions(vs),
        "adversarial": vs[:6] + _adversarial(vs[:6]),
    }


@pytest.fixture(scope="module")
def jax_masks(keys, batches):
    reg, _ = keys
    return {k: TPUVerifier(reg, comb=False).verify_batch(b) for k, b in batches.items()}


@pytest.fixture(scope="module")
def port(keys):
    return CUDAVerifier(keys[0], comb=False, device="cpu")


@pytest.mark.parametrize("name", ["corruptions", "adversarial"])
def test_verify_core_matches_jax(keys, batches, jax_masks, port, name):
    """curve.verify_core on the windowed prep arrays: the JAX program's
    mask, which the host oracle confirms."""
    batch = batches[name]
    args = [torch.from_numpy(a) for a in port.prepare_batch(batch)]
    assert args[0].shape == (16, 64)
    one = F.const("ONE", torch.device("cpu")).expand_as(args[2])
    got = C.verify_core(args[0], args[1], (args[2], args[3], one, args[4]), *args[5:])
    assert got[: len(batch)].tolist() == jax_masks[name]
    assert jax_masks[name] == CPUVerifier(keys[0]).verify_batch(batch)
    assert not any(got[len(batch):].tolist())  # padding rows


@pytest.mark.parametrize("name", ["corruptions", "adversarial"])
def test_windowed_verifier_equals_cpu_comb_and_jax(keys, batches, jax_masks, port, name):
    batch = batches[name]
    want = CPUVerifier(keys[0]).verify_batch(batch)
    assert port.verify_batch(batch) == want == jax_masks[name]
    comb = CUDAVerifier(keys[0], device="cpu")
    assert comb.verify_batch(batch) == want
    assert want.count(True) in (4, 6) and not all(want)


def test_windowed_prep_arrays_equal_jax(keys, batches, port):
    """The nine-array pack is the JAX ``_prepare(comb=False)``'s, byte for
    byte."""
    batch = batches["corruptions"]
    want = TPUVerifier(keys[0], comb=False)._prepare(batch, 16)
    got = port.prepare_batch(batch)
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


@pytest.mark.parametrize("name", ["corruptions", "adversarial"])
def test_card_program_masks_equal_twin(batches, jax_masks, port, name):
    """ops/windowed.py's card composition (padd_xx additions, the
    pow22523 chain, both walks in one lane set) run through the wrappers'
    plain versions: the twin's mask, row for row."""
    batch = batches[name]
    args = [torch.from_numpy(a) for a in port.prepare_batch(batch)]
    one = F.const("ONE", torch.device("cpu")).expand_as(args[2])
    got = windowed.composed(args[0], args[1], (args[2], args[3], one, args[4]), *args[5:])
    assert got[: len(batch)].tolist() == jax_masks[name]


def test_comb_knob_off_selects_the_windowed_path(keys, batches, monkeypatch):
    monkeypatch.setenv("DAGRIDER_COMB", "0")
    v = CUDAVerifier(keys[0], device="cpu")
    assert not v._comb and v.warmup() == 0.0
    batch = batches["adversarial"]
    assert len(v.prepare_batch(batch)) == 9
    assert v.verify_batch(batch[:2] + batch[6:8]) == [True, True, False, False]
