"""The Ed25519 finish tail and square-root chain of the port vs the JAX kernels.

``cuda_group.finish_check`` (the finish kernel's wrapper) and
``cuda_group.pow22523`` take their plain torch versions on CPU tensors.
Here they are held against the bodies of the JAX package's
``pallas_group._finish_kernel`` and ``_pow22523_kernel``, run with mock
refs as ``tests/test_pallas_group.py`` runs them, on the same numpy
inputs with tolerance 0: the accept bit exactly, and the raw int32 limbs
of the chain (which the tail consumes raw). The finish inputs are the edge
rows of ``torch_edge_rows`` and real signatures' tree sums, in the
[B, 2, 4, 22] layout the finish kernel reads; the chain's inputs are limbs
at the edges of the reduced invariant. On CPU tensors no kernel launches.
Also here: the threshold coin's MSM defaults to the card.
"""

import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dag_rider_tpu.crypto import threshold as jth
from dag_rider_tpu.ops import field as JF, pallas_group as PG
from dag_rider_tpu_torch.consensus.coin import ThresholdCoin
from dag_rider_tpu_torch.core.types import Block, Vertex, VertexID
from dag_rider_tpu_torch.ops import comb, cuda_group as CG, field as F
from dag_rider_tpu_torch.verifier.base import KeyRegistry, VertexSigner
from dag_rider_tpu_torch.verifier.cpu import CPUVerifier
from dag_rider_tpu_torch.verifier.cert import CertVerifier
from dag_rider_tpu_torch.verifier.cuda import CUDAVerifier, unpack
from test_pallas_group import _Ref
from test_torch_coin import port_keys
from torch_edge_rows import edge_limbs, edge_rows, tiled

CSRC = Path(CG.__file__).resolve().parents[1] / "csrc"


@pytest.fixture(autouse=True)
def _no_launches():
    CG.reset_launches()
    yield
    assert not any(CG.LAUNCHES.values()), "a CPU tensor launched a kernel"


def _jax_finish(r_y, r_sign, acc) -> np.ndarray:
    """pallas_group._finish_kernel's body on the TPU's limb-major layout."""
    m = r_y.shape[0]
    y_t = np.ascontiguousarray(r_y.numpy().T)
    sign_t = r_sign.numpy().reshape(1, m)
    acc_t = np.moveaxis(acc.numpy().reshape(m, 8, 22), 0, -1).reshape(176, m)
    out = _Ref(np.zeros((1, m), np.int32))
    PG._finish_kernel(_Ref(y_t), _Ref(sign_t), _Ref(acc_t), out)
    return out.arr[0].astype(bool)


def _real_rows(count, seed):
    """r_y, r_sign and the tree's acc of ``count`` real signatures over a
    4-key registry, every third block tampered, with the host verdicts."""
    reg, seeds = KeyRegistry.generate(4)
    signers = [VertexSigner(sd) for sd in seeds]
    rng = np.random.default_rng(seed)
    vs = []
    for i in range(count):
        v = signers[i % 4].sign_vertex(
            Vertex(id=VertexID(3, i % 4), block=Block((rng.bytes(8),)),
                   strong_edges=(VertexID(2, 1),)))
        if i % 3 == 2:
            v = dataclasses.replace(v, block=Block((b"tampered",)))
        vs.append(v)
    ver = CUDAVerifier(reg, device="cpu")
    x = unpack(*(torch.from_numpy(a[:count]) for a in ver.prepare_batch(vs)))
    tables, b_tab = ver.comb_tables()
    acc = CG.tree_sum_xyzt(comb.gather_entries(x.s_nibbles, x.k_nibbles, x.key_idx,
                                               tables, b_tab))
    return x.r_y, x.r_sign, acc, CPUVerifier(reg).verify_batch(vs)


# --- finish_check --------------------------------------------------------------


def test_finish_check_plain_equals_jax_kernel_on_edge_and_real_rows():
    names, r_y, r_sign, acc = edge_rows()
    ry2, rs2, acc2, host = _real_rows(6, 41)
    r_y, r_sign, acc = torch.cat([r_y, ry2]), torch.cat([r_sign, rs2]), torch.cat([acc, acc2])
    got = CG.finish_check(r_y, r_sign, acc)
    assert got.dtype == torch.bool and got.shape == (len(names) + 6,)
    np.testing.assert_array_equal(_jax_finish(r_y, r_sign, acc), got.numpy())
    verdict = dict(zip(names, got.tolist()))
    assert verdict == {
        "valid": True, "valid, another key": True, "wrong [s]B": False,
        "non-square y = 2": False, "y = 1, sign 1 (x = 0)": False,
        "y = 1, sign 0 (R the identity)": False, "y >= p (p + 9)": False,
        "8-torsion [k]A": False, "valid + 8-torsion on both sides": True,
        "identity everywhere, R = identity": True, "identity [k]A": False,
    }
    assert got[len(names):].tolist() == host == [True, True, False] * 2


@pytest.mark.parametrize("n", [1, 13])
def test_finish_check_plain_on_tiled_edge_rows_equals_rowwise(n):
    """A ragged batch of tiled rows gives each row its own verdict."""
    _, r_y, r_sign, acc = edge_rows()
    one_by_one = CG.finish_check(r_y, r_sign, acc).tolist()
    got = CG.finish_check(tiled(r_y, n), tiled(r_sign, n), tiled(acc, n))
    assert got.tolist() == (one_by_one * 2)[:n]


def test_finish_check_rejects_bad_operands():
    _, r_y, r_sign, acc = edge_rows()
    with pytest.raises(ValueError):
        CG.finish_check(r_y[:, :21], r_sign, acc)
    with pytest.raises(ValueError):
        CG.finish_check(r_y, r_sign, acc.reshape(-1, 176))  # the TPU's old row layout
    with pytest.raises(TypeError):
        CG.finish_check(r_y, r_sign.long(), acc)


# --- pow22523 ------------------------------------------------------------------


def test_pow22523_plain_equals_jax_kernel_and_field_on_edge_limbs():
    z = edge_limbs()  # [M, 22]
    got = CG.pow22523(z.t().contiguous())  # [22, M]
    out = _Ref(np.zeros((PG.L, z.shape[0]), np.int32))
    PG._pow22523_kernel(_Ref(np.ascontiguousarray(z.numpy().T)), out)
    np.testing.assert_array_equal(out.arr, got.numpy())
    np.testing.assert_array_equal(np.asarray(JF.pow22523(jnp.asarray(z.numpy()))).T,
                                  got.numpy())


def test_pow22523_edge_limbs_are_reduced_and_give_the_right_power():
    z = edge_limbs()
    assert (z[:, 1:].abs() < 1 << 13).all() and (z[:, 0].abs() < 1 << 14).all()
    got = CG.pow22523(z.t().contiguous()).t()
    for row, want_row in zip(got, z):
        want = pow(F.from_limbs(want_row.numpy()) % F.P_INT, 2**252 - 3, F.P_INT)
        assert F.from_limbs(row.numpy()) % F.P_INT == want


# --- the kernel source ---------------------------------------------------------


def test_finish_kernel_constant_rows_are_the_field_constants():
    """kFinishConst, the rows the finish kernel's lanes read D, SQRT_M1
    and 2d from, is made of the source's limb macros (which
    tests/test_torch_field.py holds to ops/field.py), in that order."""
    src = (CSRC / "ed25519_group.cu").read_text()
    m = re.search(r"kFinishConst\[3\]\[NL\] = \{(\w+), (\w+), (\w+)\};", src)
    assert m.groups() == ("D_LIMBS", "SQRT_M1_LIMBS", "D2_LIMBS")
    for name, want in zip(m.groups(), (F.D, F.SQRT_M1, F.D2)):
        body = re.search(rf"#define {name} \{{([^}}]*)\}}", src).group(1)
        np.testing.assert_array_equal([int(v) for v in re.findall(r"-?\d+", body)], want)


def test_c_entry_points_take_the_arguments_the_wrapper_declares():
    """Each ``dr_*`` entry point of the source has as many parameters as
    its ctypes signature in ``cuda_group``."""
    src = (CSRC / "ed25519_group.cu").read_text()
    decls = dict(re.findall(r'extern "C" int (dr_\w+)\(([^)]*)\)', src))
    assert set(decls) == set(CG._SIGNATURES)
    for name, params in decls.items():
        assert len(params.split(",")) == len(CG._SIGNATURES[name]), name


# --- ThresholdCoin's MSM defaults to the card ------------------------------------


def test_coin_device_msm_without_card_raises(monkeypatch):
    keys = port_keys(jth.ThresholdKeys.generate(4, 2, seed=b"coin-default"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ThresholdCoin(keys, 0, 4)  # the device MSM on cuda is the default
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ThresholdCoin(keys, 0, 4, msm="device")
    with pytest.raises(ValueError):
        ThresholdCoin(keys, 0, 4, msm="sharded")
    assert ThresholdCoin(keys, 0, 4, msm="host")._msm is None
    cpu = ThresholdCoin(keys, 0, 4, device="cpu")
    assert cpu._msm.keywords["device"].type == "cpu"


def test_coin_msm_none_raises(monkeypatch):
    """``msm`` takes the spellings ``CertVerifier`` takes: None is not a
    second name for "host". ``CertVerifier``'s None reads DAGRIDER_CERT_MSM
    as the reference's does, and is "device" when the knob is unset: on
    this machine, with no card, that raises too."""
    keys = port_keys(jth.ThresholdKeys.generate(4, 2, seed=b"coin-default"))
    with pytest.raises(ValueError, match="coin MSM"):
        ThresholdCoin(keys, 0, 4, msm=None)
    monkeypatch.delenv("DAGRIDER_CERT_MSM", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CertVerifier(KeyRegistry.generate_with_cert(4)[0], 3, msm=None)


def test_coin_default_msm_on_cpu_device_equals_host_coin():
    keys = port_keys(jth.ThresholdKeys.generate(4, 2, seed=b"coin-default"))
    host, dev = ThresholdCoin(keys, 1, 4, msm="host"), ThresholdCoin(keys, 1, 4, device="cpu")
    for coin in (host, dev):
        for src in (0, 2):
            coin.observe_share(1, src, jth.sign_share(keys.share_sks[src], 1))
    assert dev.ready(1) and host.ready(1)
    assert dev._sigma[1] == host._sigma[1]
    assert dev.choose_leader(1) == host.choose_leader(1)
