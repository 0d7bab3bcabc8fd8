"""Fixed-key comb verification (4-bit windows) — the port's device path.

Torch twin of ``dag_rider_tpu/ops/comb.py``. The committee is fixed for a
run, so [k]A becomes a sum of 64 entries of per-key tables
(``TABLE[key, w, d] = d * 16^w * A_key``) built once on the device, and
[s]B a sum of 64 entries of the base-point table. Both sums are one
gather plus a 6-level tree of complete additions; the tail decompresses R
and checks [s]B == R + [k]A projectively. The equation is not rearranged
into [s]B - [k]A, which would differ on keys with 8-torsion components.

Representation: a *packed* point is one int32 tensor [..., 4, 22] with
rows (X, Y, Z, T); a *cached* entry has rows (Y-X, Y+X, 2dT, 2Z).

On CUDA tensors the tree additions and the tail run in the hand-written
kernels of :mod:`dag_rider_tpu_torch.ops.cuda_group`; on CPU tensors the
same wrappers run their plain torch versions. Both give the same limbs.
"""

from __future__ import annotations

import numpy as np
import torch

from dag_rider_tpu_torch.ops import curve, field as F

WINDOWS = 64  # 4-bit windows over 256-bit scalars
ENTRIES = 16


def pack_point(p: curve.Point) -> torch.Tensor:
    """(X, Y, Z, T) tuple of [..., 22] -> packed [..., 4, 22]."""
    return torch.stack(p, dim=-2)


def unpack_point(a: torch.Tensor) -> curve.Point:
    return tuple(a[..., i, :] for i in range(4))


def to_cached(packed: torch.Tensor) -> torch.Tensor:
    """Packed XYZT [..., 4, 22] -> cached (Y-X, Y+X, 2dT, 2Z), row-wise,
    with the same limbs as the padd kernel's in-register transform."""
    x, y, z, t = unpack_point(packed)
    return torch.stack(
        [F.sub(y, x), F.add(y, x), F.mul(t, F.const("D2", t.device)), F.add(z, z)],
        dim=-2,
    )


def padd_cached(p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Packed point + cached entry -> packed point (add-2008-hwcd-3):
    A = (Y1-X1)*c0, B = (Y1+X1)*c1, C = T1*c2, D = Z1*c3;
    E = B-A, F = D-C, G = D+C, H = B+A; (X3, Y3, Z3, T3) = (EF, GH, FG, EH)."""
    x1, y1, z1, t1 = unpack_point(p)
    lhs = torch.stack([F.sub(y1, x1), F.add(y1, x1), t1, z1], dim=-2)
    a, b, cc, d = unpack_point(F.mul(lhs, c))
    e = F.sub(b, a)
    f = F.sub(d, cc)
    g = F.add(d, cc)
    h = F.add(b, a)
    efge = torch.stack([e, g, f, e], dim=-2)
    fhgh = torch.stack([f, h, g, h], dim=-2)
    return F.mul(efge, fhgh)


def pdouble_packed(p: torch.Tensor) -> torch.Tensor:
    """Packed doubling (dbl-2008-hwcd) — 2 packed muls + linear ops."""
    x1, y1, z1, _ = unpack_point(p)
    sq_in = torch.stack([x1, y1, z1, F.add(x1, y1)], dim=-2)
    a, b, c, s = unpack_point(F.mul(sq_in, sq_in))  # X^2, Y^2, Z^2, (X+Y)^2
    c2 = F.add(c, c)
    h = F.add(a, b)
    e = F.sub(h, s)
    g = F.sub(a, b)
    f = F.add(c2, g)
    efge = torch.stack([e, g, f, e], dim=-2)
    fhgh = torch.stack([f, h, g, h], dim=-2)
    return F.mul(efge, fhgh)


def to_limb_major(packed: torch.Tensor) -> torch.Tensor:
    """[N, 4, 22] packed points -> contiguous limb-major [88, N]."""
    return packed.reshape(packed.shape[0], 4 * F.LIMBS).t().contiguous()


def from_limb_major(lm: torch.Tensor) -> torch.Tensor:
    """Limb-major [88, N] -> packed [N, 4, 22]."""
    return lm.t().reshape(lm.shape[1], 4, F.LIMBS)


# ---------------------------------------------------------------------------
# Comb tables
# ---------------------------------------------------------------------------


def build_key_tables(
    a_x: torch.Tensor, a_y: torch.Tensor, a_t: torch.Tensor
) -> torch.Tensor:
    """Packed-XYZT comb tables for every key: [n, 64, 16, 4, 22] int32 on
    the keys' device. TABLE[key, w, d] = d * 16^w * A_key.

    Window w holds the identity and 15 successive additions of the window
    base b = 16^w * A; the next base is four doublings of b. Each entry
    step ``padd_cached(prev, to_cached(b))`` is exactly ``padd_xx(prev,
    b)``, so it runs through the padd kernel on CUDA; the doublings stay
    plain torch, as they are plain jnp in the JAX package.
    """
    from dag_rider_tpu_torch.ops import cuda_group

    n = a_x.shape[0]
    one = F.const("ONE", a_x.device).expand(n, F.LIMBS)
    b = torch.stack([a_x, a_y, one, a_t], dim=-2)  # packed [n, 4, 22]
    ident = pack_point(curve.identity((n,), a_x.device))
    ident_lm = to_limb_major(ident)
    windows = []
    for _ in range(WINDOWS):
        b_lm = to_limb_major(b)
        prev = ident_lm
        entries = [ident_lm]
        for _ in range(ENTRIES - 1):
            prev = cuda_group.padd_xx(prev, b_lm)
            entries.append(prev)
        # [16, 88, n] -> [n, 16, 4, 22]
        windows.append(
            torch.stack(entries).permute(2, 0, 1).reshape(n, ENTRIES, 4, F.LIMBS)
        )
        b = pdouble_packed(pdouble_packed(pdouble_packed(pdouble_packed(b))))
    return torch.stack(windows, dim=1)  # [n, 64, 16, 4, 22]


def base_table_xyzt() -> np.ndarray:
    """Packed-XYZT comb table for the base point B: [64, 16, 4, 22]
    (host-built from curve.b_table()'s affine entries: Z == 1, T = x*y)."""
    xs, ys, ts = curve.b_table()  # [64, 16, 22] each, affine
    ones = np.broadcast_to(F.ONE, xs.shape).copy()
    return np.stack([xs, ys, ones, ts], axis=2)  # [64, 16, 4, 22]


# ---------------------------------------------------------------------------
# The comb verify core
# ---------------------------------------------------------------------------


def tree_sum_packed(entries: torch.Tensor) -> torch.Tensor:
    """Sum a power-of-two axis of packed XYZT points (plain torch).

    entries: [..., M, 4, 22]. Each level adds the first half to the cached
    second half; this pairing order is the one the tree kernel
    (:func:`cuda_group.tree_sum_xyzt`) uses, so the limbs agree."""
    acc = entries
    while acc.shape[-3] > 1:
        m = acc.shape[-3] // 2
        acc = padd_cached(acc[..., :m, :, :], to_cached(acc[..., m:, :, :]))
    return acc[..., 0, :, :]


def gather_entries(
    s_nibbles: torch.Tensor,
    k_nibbles: torch.Tensor,
    key_idx: torch.Tensor,
    key_tables: torch.Tensor,
    b_table: torch.Tensor,
) -> torch.Tensor:
    """The comb walk's table entries: [B, 2, 64, 4, 22] (axis 1 is
    ([s]B, [k]A)). Tables arrive flat: key_tables [n * 64 * 16, 88],
    b_table [64 * 16, 88]; nibbles and key_idx are int64 [B, 64] / [B]."""
    wins = torch.arange(WINDOWS, device=s_nibbles.device)[None, :]
    b_rows = b_table[wins * ENTRIES + s_nibbles]  # [B, 64, 88]
    a_rows = key_tables[(key_idx[:, None] * WINDOWS + wins) * ENTRIES + k_nibbles]
    stacked = torch.stack([b_rows, a_rows], dim=1)  # [B, 2, 64, 88]
    return stacked.reshape(*stacked.shape[:-1], 4, F.LIMBS)


def comb_verify_core(
    s_nibbles: torch.Tensor,
    k_nibbles: torch.Tensor,
    key_idx: torch.Tensor,
    key_tables: torch.Tensor,
    b_table: torch.Tensor,
    a_valid: torch.Tensor,
    r_y: torch.Tensor,
    r_sign: torch.Tensor,
    prevalid: torch.Tensor,
) -> torch.Tensor:
    """Batched [s]B == R + [k]A with both scalar muls as comb sums.

    s_nibbles/k_nibbles: int64 [B, 64] little-endian 4-bit digits;
    key_idx: int64 [B]; tables flat as in :func:`gather_entries`;
    r_y: int32 [B, 22]; r_sign: int32 [B]; a_valid/prevalid: bool [B].
    Returns the bool [B] accept mask.
    """
    from dag_rider_tpu_torch.ops import cuda_group

    entries = gather_entries(s_nibbles, k_nibbles, key_idx, key_tables, b_table)
    acc = cuda_group.tree_sum_xyzt(entries)  # [B, 2, 4, 22]
    ok = cuda_group.finish_check(r_y, r_sign, acc)
    return ok & a_valid & prevalid
