"""CUDA kernels vs their plain torch versions, on the card, at full width.

Each wrapper of ``dag_rider_tpu_torch.ops.cuda_group`` / ``cuda_field``
launches its hand-written sm_90a kernel on CUDA tensors; the same inputs
through the plain version must give the same int32 limbs (or accept
bits) exactly. Widths are the verify path's at n = 256 and 16 merged
rounds (4,096 signatures): the first tree level adds 2 * 64 * 4096
entries in pairs; the finish tail, pow22523 and the field multiply run at
4,096 lanes.

These tests need a card and skip without one. They import no JAX, so
they run on a machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda -p no:xdist --noconftest
"""

import dataclasses

import numpy as np
import pytest
import torch

from dag_rider_tpu_torch.core.types import Block, Vertex, VertexID
from dag_rider_tpu_torch.crypto import ed25519
from dag_rider_tpu_torch.ops import comb, cuda_field, cuda_group as CG, field as F
from dag_rider_tpu_torch.verifier.base import KeyRegistry, VertexSigner
from dag_rider_tpu_torch.verifier.cpu import CPUVerifier
from dag_rider_tpu_torch.verifier.cuda import CUDAVerifier, unpack

pytestmark = pytest.mark.cuda

B = 4096  # signatures in one merged dispatch (16 rounds x 256)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m cuda")
    CG.reset_launches()
    cuda_field.reset_launches()
    return torch.device("cuda")


def _reduced(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-8191, 8192, size=(*shape, F.LIMBS), dtype=np.int32)
    x[..., 0] = rng.integers(-16383, 16384, size=shape, dtype=np.int32)
    return torch.from_numpy(x)


def test_field_mul_kernel_equals_plain(dev):
    a, b = _reduced((B,), 1).to(dev), _reduced((B,), 2).to(dev)
    got = cuda_field.mul(a, b)
    torch.cuda.synchronize()
    assert cuda_field.LAUNCHES["field_mul"] == 1
    assert torch.equal(got, cuda_field.mul_plain(a, b))


def test_pow22523_kernel_equals_plain(dev):
    z = _reduced((B,), 3).t().contiguous().to(dev)  # [22, B]
    got = CG.pow22523(z)
    torch.cuda.synchronize()
    assert CG.LAUNCHES["pow22523"] == 1
    assert torch.equal(got, CG.pow22523_plain(z))


def test_padd_xx_kernel_equals_plain_on_first_tree_level(dev):
    x = _reduced((2 * 64 * B, 4), 4).reshape(-1, 4 * F.LIMBS).t().contiguous().to(dev)
    half = x.shape[1] // 2
    p, q = x[:, :half], x[:, half:]  # strided column views, as in the tree
    got = CG.padd_xx(p, q)
    torch.cuda.synchronize()
    assert CG.LAUNCHES["padd_xx"] == 1
    assert torch.equal(got, CG.padd_xx_plain(p, q))


@pytest.mark.parametrize("n", [1, 127, 129, 4097])
def test_padd_xx_kernel_at_ragged_widths_on_column_slices(dev, n):
    """Widths that leave a block part full, operands that are column
    slices of one wider tensor (row stride 2n + 3, not n)."""
    wide = _reduced((2 * n + 3, 4), 20 + n).reshape(-1, 4 * F.LIMBS).t().contiguous().to(dev)
    p, q = wide[:, 1 : n + 1], wide[:, n + 3 :]
    assert p.stride(0) == q.stride(0) == 2 * n + 3
    got = CG.padd_xx(p, q)
    torch.cuda.synchronize()
    assert CG.LAUNCHES["padd_xx"] == 1
    assert got.shape == (4 * F.LIMBS, n) and got.is_contiguous()
    assert torch.equal(got, CG.padd_xx_plain(p, q))


@pytest.mark.parametrize("bits", [4, 8])
def test_key_table_kernels_equal_plain_build(dev, bits):
    """A build at n = 5 on the card launches only the two table kernels
    and gives the plain build's bytes."""
    reg, _ = KeyRegistry.generate(5)
    ver = CUDAVerifier(reg, device="cpu")
    keys = [torch.as_tensor(a) for a in (ver._a_x, ver._a_y, ver._a_t)]
    build, plain, name = {
        4: (comb.build_key_tables, comb.build_key_tables_plain, "key_tables"),
        8: (comb.build_key_tables8, comb.build_key_tables8_plain, "key_tables8"),
    }[bits]
    got = build(*(a.to(dev) for a in keys))
    torch.cuda.synchronize()
    assert CG.TABLE_LAUNCHES[name] == CG.TABLE_KERNELS
    assert not any(CG.LAUNCHES.values()), "the build launched a kernel of the verify path"
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), plain(*keys))


def test_tree_sum_kernel_equals_plain_tree(dev):
    entries = _reduced((B, 2, 64, 4), 5).to(dev)
    got = CG.tree_sum_xyzt(entries)
    torch.cuda.synchronize()
    assert (CG.LAUNCHES["tree_sum_xyzt"], CG.LAUNCHES["padd_xx"]) == (1, 0)
    assert torch.equal(got, comb.tree_sum_packed(entries))


@pytest.mark.parametrize("lead, m", [((3,), 64), ((5, 2), 8), ((2,), 1)])
def test_tree_sum_kernel_on_odd_group_counts_and_short_groups(dev, lead, m):
    """An odd number of groups leaves the last block one group; M < 64."""
    entries = _reduced((*lead, m, 4), 8).to(dev)
    got = CG.tree_sum_xyzt(entries)
    torch.cuda.synchronize()
    assert CG.LAUNCHES["tree_sum_xyzt"] == 1
    assert torch.equal(got, comb.tree_sum_packed(entries))


def _signed(n_keys, count, seed):
    reg, seeds = KeyRegistry.generate(n_keys)
    signers = [VertexSigner(s) for s in seeds]
    rng = np.random.default_rng(seed)
    vs = []
    for j in range(count):
        src = j % n_keys
        edges = tuple(VertexID(0, int(e)) for e in rng.choice(n_keys, 3, replace=False))
        vs.append(
            signers[src].sign_vertex(
                Vertex(id=VertexID(1, src), block=Block((rng.bytes(16),)),
                       strong_edges=edges)
            )
        )
    return reg, vs


def _corrupt(vs):
    s_big = int.to_bytes(int.from_bytes(vs[2].signature[32:], "little") + ed25519.L,
                         32, "little")
    flip = bytearray(vs[4].signature)
    flip[17] ^= 0x40
    return [
        dataclasses.replace(vs[0], signature=b"\x00" * 64),
        dataclasses.replace(vs[1], block=Block((b"tampered",))),
        dataclasses.replace(vs[2], signature=vs[2].signature[:32] + s_big),
        dataclasses.replace(vs[3], signature=int.to_bytes(2**255 - 10, 32, "little")
                            + vs[3].signature[32:]),
        dataclasses.replace(vs[4], signature=bytes(flip)),
        dataclasses.replace(vs[5], id=VertexID(1, 999)),
        dataclasses.replace(vs[6], signature=None),
        dataclasses.replace(vs[7], signature=vs[8].signature),
    ]


def test_finish_kernel_equals_plain_tail(dev):
    """Real signatures' R and accumulators, tiled to 4,096 lanes, with
    every other row's [s]B taken from another signature (a false
    equation)."""
    reg, vs = _signed(8, 64, 6)
    ver = CUDAVerifier(reg, device=dev)
    u8, i32 = ver.prepare_batch(vs)
    u8_t, i32_t = torch.from_numpy(u8).to(dev), torch.from_numpy(i32).to(dev)
    x = unpack(u8_t, i32_t)
    tables, b_tab = ver.comb_tables()
    acc = comb.tree_sum_packed(
        comb.gather_entries(x.s_nibbles, x.k_nibbles, x.key_idx, tables, b_tab)
    )
    reps = B // acc.shape[0]
    acc = acc.repeat(reps, 1, 1, 1)
    acc[1::2, 0] = acc[0::2, 0].roll(1, 0)
    r_y, r_sign = x.r_y.repeat(reps, 1), x.r_sign.repeat(reps)
    got = CG.finish_check(r_y, r_sign, acc)
    torch.cuda.synchronize()
    assert CG.LAUNCHES["finish_check"] == 1
    want = CG.finish_check_plain(r_y, r_sign, acc)
    assert torch.equal(got, want)
    assert want[0::2].all() and not want[1::2].any()


def test_verifier_on_cuda_matches_cpu_oracle_through_kernels(dev):
    reg, vs = _signed(8, 24, 7)
    batch = vs + _corrupt(vs)
    ver = CUDAVerifier(reg)
    assert ver.device.type == "cuda"
    tables_cpu = comb.build_key_tables(
        *(torch.as_tensor(a) for a in (ver._a_x, ver._a_y, ver._a_t))
    )
    assert torch.equal(ver.comb_tables()[0].cpu(), tables_cpu.reshape(-1, 88))
    CG.reset_launches()
    got = ver.verify_rounds([batch[:10], batch[10:]])
    assert CG.LAUNCHES == {"padd_xx": 0, "tree_sum_xyzt": 1, "finish_check": 1, "pow22523": 0}
    want = CPUVerifier(reg).verify_batch(batch)
    assert got[0] + got[1] == want
    assert want[:24] == [True] * 24 and not any(want[24:])


def test_tree_sum_kernel_on_corrupted_signature_entries(dev):
    """The gather's own [B, 2, 64, 4, 22] output for 128 real signatures,
    64 seeded rows of them corrupted eight ways (as the verify path meets
    them), equals comb.tree_sum_packed through one launch, and the accept
    mask built on it equals the host oracle."""
    reg, vs = _signed(16, 128, 9)
    rng = np.random.default_rng(9)
    bad = [int(i) for i in rng.choice(len(vs), 64, replace=False)]
    batch = list(vs)
    for k in range(0, len(bad), 8):
        rows = bad[k : k + 8]
        other = next(v for j, v in enumerate(vs) if j not in rows)  # its signature goes on rows[7]
        for i, v in zip(rows, _corrupt([vs[i] for i in rows] + [other])):
            batch[i] = v
    ver = CUDAVerifier(reg, device=dev)
    u8, i32 = ver.prepare_batch(batch)
    x = unpack(torch.from_numpy(u8).to(dev), torch.from_numpy(i32).to(dev))
    tables, b_tab = ver.comb_tables()
    entries = comb.gather_entries(x.s_nibbles, x.k_nibbles, x.key_idx, tables, b_tab)
    CG.reset_launches()
    acc = CG.tree_sum_xyzt(entries)
    torch.cuda.synchronize()
    assert CG.LAUNCHES["tree_sum_xyzt"] == 1
    assert torch.equal(acc, comb.tree_sum_packed(entries))
    mask = (CG.finish_check(x.r_y, x.r_sign, acc) & x.a_valid & x.prevalid).tolist()
    assert mask == CPUVerifier(reg).verify_batch(batch)
    assert not any(mask[i] for i in bad)


# --- the cooperative finish tail and square-root chain ---------------------------


@pytest.mark.parametrize("n", [1, 33, B, B + 1])
def test_finish_kernel_on_edge_rows_equals_plain(dev, n):
    """The edge rows of torch_edge_rows (valid, wrong [s]B, non-square y,
    x = 0 with sign 1, y >= p, 8-torsion [k]A, the identity) tiled to n
    signatures, through one launch."""
    from torch_edge_rows import edge_rows, tiled

    _, r_y, r_sign, acc = edge_rows()
    r_y, r_sign, acc = (tiled(t, n).to(dev) for t in (r_y, r_sign, acc))
    got = CG.finish_check(r_y, r_sign, acc)
    torch.cuda.synchronize()
    assert CG.LAUNCHES["finish_check"] == 1
    want = CG.finish_check_plain(r_y, r_sign, acc)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n", [1, B, 65537])
def test_pow22523_kernel_on_edge_limbs_equals_plain(dev, n):
    from torch_edge_rows import edge_limbs, tiled

    z = tiled(edge_limbs(), n).t().contiguous().to(dev)  # [22, n]
    got = CG.pow22523(z)
    torch.cuda.synchronize()
    assert CG.LAUNCHES["pow22523"] == 1
    want = CG.pow22523_plain(z)
    assert torch.equal(got, want)
