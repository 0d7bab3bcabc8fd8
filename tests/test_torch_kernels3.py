"""The one-launch Horner chain and comb tree of the port vs the JAX package.

``cuda_group381.horner381`` runs the MSM's whole Horner combination and
``field381.canonical`` of its result in one kernel, and
``cuda_group.tree_sum_xyzt`` the six levels of the comb tree in one
kernel. On CPU tensors each takes its plain version, which is held here
against the JAX functions on the same numpy inputs with tolerance 0
(raw int32 limbs: the MSM and the verify tail consume raw limbs). The
kernels' literal constants are checked against the field layer they copy.
On CPU tensors no kernel launches.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dag_rider_tpu.crypto import bls12381 as jbls
from dag_rider_tpu.ops import bls_msm as JM, comb as JC, field381 as JF
from dag_rider_tpu_torch.ops import (
    bls_msm as TM, comb as TC, cuda_group as CG, cuda_group381 as G, field381 as TF,
)
from test_torch_bls import _coord, _eq, _lm, _msm_inputs, _t

CSRC = Path(G.__file__).resolve().parents[1] / "csrc"


@pytest.fixture(autouse=True)
def _no_launches():
    G.reset_launches()
    CG.reset_launches()
    yield
    assert G.LAUNCHES == {"padd381_xx": 0, "horner381": 0}, "a CPU tensor launched a kernel"
    assert not any(CG.LAUNCHES.values()), "a CPU tensor launched a kernel"


def _jax_window_sums(t, seed):
    """(JAX window sums as 3 x [64, 33], the same as a limb-major [99, 64]
    tensor, and the MSM's scalars and points) for a padded batch of t."""
    scalars, points = _msm_inputs(t, seed)
    nib, px, py, pz = JM.pack_inputs(scalars, points, t)
    want = JM.window_sums(jnp.asarray(nib), (px, py, pz))
    lm = _lm(np.stack([np.asarray(c) for c in want], axis=1))  # [99, 64]
    return want, lm, scalars, points


# --- horner381 -------------------------------------------------------------


@pytest.mark.parametrize("t", [4, 8])
def test_horner381_plain_raw_and_canonical_limbs_equal_jax(t):
    want_w, w, _, _ = _jax_window_sums(t, 70 + t)
    raw, canon = G.horner381(w)
    assert raw.shape == (G.ROWS, 1) and canon.shape == (3, TF.LIMBS)
    want = JM.horner_combine(want_w)
    for c in range(3):
        _eq(want[c], _coord(raw, c)[0])
        _eq(JF.canonical(want[c]), canon[c])


def test_horner381_on_identity_window_sums_gives_identity():
    w = torch.zeros((G.ROWS, G.WINDOWS), dtype=torch.int32)
    w[TF.LIMBS] = 1
    raw, canon = G.horner381(w)
    want = JM.horner_combine(tuple(jnp.asarray(w[c * 33 : (c + 1) * 33].T.numpy())
                                   for c in range(3)))
    for c in range(3):
        _eq(want[c], _coord(raw, c)[0])
    assert not canon[0].any() and not canon[2].any()
    assert TM.unpack_point(*canon) is None


def test_horner381_rejects_bad_operands():
    w = torch.zeros((G.ROWS, G.WINDOWS), dtype=torch.int32)
    with pytest.raises(ValueError):
        G.horner381(w[:, :32])
    with pytest.raises(ValueError):
        G.horner381(w[:98])
    with pytest.raises(TypeError):
        G.horner381(w.long())


@pytest.mark.parametrize("t", [4, 8])
def test_unpack_point_on_canonical_limbs_equals_host_msm(t):
    scalars, points = _msm_inputs(t, 80 + t)
    arrays = TM.pack_inputs(scalars, points, t)
    raw, canon = TM._msm_limbs(*(_t(a) for a in arrays))
    assert torch.equal(canon, TF.canonical(raw[:, 0].reshape(3, TF.LIMBS)))
    assert ((canon >= 0) & (canon < 1 << 12)).all()
    want = jbls.g1_msm(scalars, points)
    assert TM.unpack_point(*canon) == want
    assert TM.unpack_point(*(raw[c * 33 : (c + 1) * 33, 0] for c in range(3))) == want
    assert TM.msm(scalars, points, device="cpu") == want


def test_kernel_canonical_constants_equal_field381():
    """The literal kBigP and kKP (8p, 4p, 2p, p) tables of
    csrc/bls381_group.cu are field381's canonical constants."""
    src = (CSRC / "bls381_group.cu").read_text()

    def table(name):
        body = src[src.index(name):]
        body = body[body.index("{"): body.index("};")]
        return [int(v) for v in re.findall(r"-?\d+", body)]

    np.testing.assert_array_equal(table("kBigP[NL] = "), TF._BIG_P)
    kp = np.array(table("kKP[4][NL] = "), np.int32).reshape(4, TF.LIMBS)
    for row, k in zip(kp, (8, 4, 2, 1)):
        np.testing.assert_array_equal(row, TF._KP[k])


# --- tree_sum_xyzt -----------------------------------------------------------


def _gather_shaped(b, seed):
    """Reduced limbs in the gather's [B, 2, 64, 4, 22] layout."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-8191, 8192, size=(b, 2, 64, 4, 22), dtype=np.int32)
    x[..., 0] = rng.integers(-16383, 16384, size=(b, 2, 64, 4), dtype=np.int32)
    return x


def test_tree_sum_xyzt_plain_equals_jax_tree_on_gather_layout():
    entries = _gather_shaped(8, 90)
    got = CG.tree_sum_xyzt(torch.from_numpy(entries))
    assert got.shape == (8, 2, 4, 22)
    assert torch.equal(got, TC.tree_sum_packed(torch.from_numpy(entries)))
    np.testing.assert_array_equal(np.asarray(JC.tree_sum_packed(jnp.asarray(entries))),
                                  got.numpy())


def test_tree_sum_xyzt_plain_on_real_comb_entries_equals_jax():
    """The gather's own output for B = 8 real signatures over a 4-key
    registry (two of them corrupted), tree-summed, equals the JAX tree and
    keeps the accept mask equal to the host oracle."""
    import dataclasses

    from dag_rider_tpu_torch.core.types import Block, Vertex, VertexID
    from dag_rider_tpu_torch.verifier.base import KeyRegistry, VertexSigner
    from dag_rider_tpu_torch.verifier.cpu import CPUVerifier
    from dag_rider_tpu_torch.verifier.cuda import CUDAVerifier, unpack

    reg, seeds = KeyRegistry.generate(4)
    signers = [VertexSigner(sd) for sd in seeds]
    vs = [signers[i % 4].sign_vertex(Vertex(id=VertexID(2, i % 4), block=Block((bytes([i]),)),
                                            strong_edges=(VertexID(1, 0),)))
          for i in range(8)]
    vs[3] = dataclasses.replace(vs[3], block=Block((b"tampered",)))
    vs[6] = dataclasses.replace(vs[6], signature=vs[5].signature)
    ver = CUDAVerifier(reg, device="cpu")
    x = unpack(*(torch.from_numpy(a[:8]) for a in ver.prepare_batch(vs)))  # no bucket pad
    tables, b_tab = ver.comb_tables()
    entries = TC.gather_entries(x.s_nibbles, x.k_nibbles, x.key_idx, tables, b_tab)
    assert entries.shape == (8, 2, 64, 4, 22)
    acc = CG.tree_sum_xyzt(entries)
    np.testing.assert_array_equal(
        np.asarray(JC.tree_sum_packed(jnp.asarray(entries.numpy()))), acc.numpy())
    mask = CG.finish_check(x.r_y, x.r_sign, acc) & x.a_valid & x.prevalid
    assert mask.tolist() == CPUVerifier(reg).verify_batch(vs)
    assert mask.tolist() == [True] * 3 + [False] + [True] * 2 + [False, True]


def test_tree_sum_xyzt_rejects_bad_shapes():
    x = torch.zeros((2, 2, 64, 4, 22), dtype=torch.int32)
    with pytest.raises(ValueError):
        CG.tree_sum_xyzt(x[:, :, :48])  # 48 entries: no power of two
    with pytest.raises(ValueError):
        CG.tree_sum_xyzt(x[..., :21])
    with pytest.raises(TypeError):
        CG.tree_sum_xyzt(x.long())


def test_kernel_tree_constants_cover_the_comb_walk():
    """The tree kernel's shared memory holds the comb walk's 64 entries a
    group; the wrapper's limit is the kernel's."""
    src = (CSRC / "ed25519_group.cu").read_text()
    assert int(re.search(r"#define TREE_MAX_M (\d+)", src).group(1)) == CG.TREE_MAX_M
    assert CG.TREE_MAX_M == TC.WINDOWS
