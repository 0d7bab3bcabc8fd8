"""Edwards25519 group arithmetic on the limb field — the port's group layer.

Torch twin of ``dag_rider_tpu/ops/curve.py``: complete addition and
doubling in extended homogeneous coordinates, branch-free RFC 8032
§5.1.3 decompression, projective equality, the host-built fixed-base
table for B, both scalar multiplications and the windowed verify
equation (:func:`verify_core`, the ``comb=False`` oracle path). The
formulas are the host oracle's (:mod:`dag_rider_tpu_torch.crypto.ed25519`),
which is what makes device and host accept masks identical. ``lax.scan``
and ``fori_loop`` become Python loops with the same order of operations,
so every function returns the JAX twin's limbs.

A "point" is a tuple (X, Y, Z, T) of limb tensors [..., 22]; x = X/Z,
y = Y/Z, T = XY/Z.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from dag_rider_tpu_torch.ops import field as F

Point = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

WINDOWS = 64  # 256-bit scalars, 4-bit windows


def identity(shape=(), device: torch.device | str = "cpu") -> Point:
    """The neutral element (0, 1, 1, 0), broadcast to leading `shape`."""
    dev = torch.device(device)
    zero = F.const("ZERO", dev).expand(*shape, F.LIMBS)
    one = F.const("ONE", dev).expand(*shape, F.LIMBS)
    return (zero, one, one, zero)


def padd(p: Point, q: Point) -> Point:
    """Unified addition (add-2008-hwcd-3 for a=-1), the host oracle's
    ``point_add`` formulas."""
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, T2 = q
    a = F.mul(F.sub(Y1, X1), F.sub(Y2, X2))
    b = F.mul(F.add(Y1, X1), F.add(Y2, X2))
    c = F.mul(F.mul(T1, T2), F.const("D2", T1.device))
    d = F.mul_small(F.mul(Z1, Z2), 2)
    e = F.sub(b, a)
    f = F.sub(d, c)
    g = F.add(d, c)
    h = F.add(b, a)
    return (F.mul(e, f), F.mul(g, h), F.mul(f, g), F.mul(e, h))


def pdouble(p: Point) -> Point:
    """Doubling (dbl-2008-hwcd), the host oracle's ``point_double``."""
    X1, Y1, Z1, _ = p
    a = F.square(X1)
    b = F.square(Y1)
    c = F.mul_small(F.square(Z1), 2)
    h = F.add(a, b)
    e = F.sub(h, F.square(F.add(X1, Y1)))
    g = F.sub(a, b)
    f = F.add(c, g)
    return (F.mul(e, f), F.mul(g, h), F.mul(f, g), F.mul(e, h))


def pselect(cond: torch.Tensor, p: Point, q: Point) -> Point:
    """cond ? p : q, element-wise over the batch."""
    return tuple(F.select(cond, a, b) for a, b in zip(p, q))


def pneg(p: Point) -> Point:
    X, Y, Z, T = p
    return (F.neg(X), Y, Z, F.neg(T))


def points_equal(p: Point, q: Point) -> torch.Tensor:
    """Projective equality: X1 Z2 == X2 Z1 and Y1 Z2 == Y2 Z1 (mod p)."""
    X1, Y1, Z1, _ = p
    X2, Y2, Z2, _ = q
    ex = F.is_zero(F.sub(F.mul(X1, Z2), F.mul(X2, Z1)))
    ey = F.is_zero(F.sub(F.mul(Y1, Z2), F.mul(Y2, Z1)))
    return ex & ey


def decompress(
    y: torch.Tensor, sign: torch.Tensor, pow22523=F.pow22523
) -> Tuple[Point, torch.Tensor]:
    """Recover (x, y) from the y limbs + sign bit; returns (point, valid).

    Candidate root of u/v as u v^3 (u v^7)^((p-5)/8), then the host
    ``_recover_x`` decision tree, branch-free: no root -> invalid; x == 0
    with the sign bit set -> invalid; parity(x) != sign -> x := -x. The
    y < p check is the caller's (done on the host from the raw bytes).
    ``pow22523`` is the root exponent's chain on [..., 22] limbs (the card
    path passes the kernel's).
    """
    one = F.const("ONE", y.device).expand_as(y)
    y2 = F.square(y)
    u = F.sub(y2, one)  # y^2 - 1
    v = F.add(F.mul(y2, F.const("D", y.device)), one)  # d y^2 + 1
    v3 = F.mul(F.square(v), v)
    v7 = F.mul(F.square(v3), v)
    cand = F.mul(F.mul(u, v3), pow22523(F.mul(u, v7)))
    vxx = F.mul(v, F.square(cand))
    root1 = F.eq(vxx, u)
    root2 = F.eq(vxx, F.neg(u))
    x = F.select(root1, cand, F.mul(cand, F.const("SQRT_M1", y.device)))
    valid = root1 | root2
    x_zero = F.is_zero(x)
    valid = valid & ~(x_zero & (sign == 1))
    flip = F.parity(x) != sign
    x = F.select(flip, F.neg(x), x)
    return (x, y, one, F.mul(x, y)), valid


# Fixed-base comb table for B: TABLE[i][d] = d * 2^(4i) * B, affine
# (Z == 1), as numpy limb arrays [64, 16, 22] per coordinate (X, Y, T).
_B_TABLE: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None


def _build_b_table() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    from dag_rider_tpu_torch.crypto import ed25519 as host

    xs = np.zeros((WINDOWS, 16, F.LIMBS), dtype=np.int32)
    ys = np.zeros((WINDOWS, 16, F.LIMBS), dtype=np.int32)
    ts = np.zeros((WINDOWS, 16, F.LIMBS), dtype=np.int32)
    base = host.B
    for i in range(WINDOWS):
        acc = host.IDENTITY
        for d in range(16):
            X, Y, Z, _ = acc
            zi = pow(Z, F.P_INT - 2, F.P_INT)
            x = X * zi % F.P_INT
            y = Y * zi % F.P_INT
            xs[i, d] = F.to_limbs(x)
            ys[i, d] = F.to_limbs(y)
            ts[i, d] = F.to_limbs(x * y % F.P_INT)
            acc = host.point_add(acc, base)
        for _ in range(4):
            base = host.point_double(base)
    return xs, ys, ts


def b_table() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Lazy host-side comb-table build (~1.2k host point ops, one-time)."""
    global _B_TABLE
    if _B_TABLE is None:
        _B_TABLE = _build_b_table()
    return _B_TABLE


# ---------------------------------------------------------------------------
# Scalar multiplication
# ---------------------------------------------------------------------------


def _gather_point(table: Tuple[torch.Tensor, ...], idx: torch.Tensor) -> Point:
    """table: per-coord tensors [..., 16, 22]; idx: integer [...] in [0, 16)."""
    index = idx.long()[..., None, None].expand(*idx.shape, 1, F.LIMBS)
    return tuple(torch.gather(coord, -2, index)[..., 0, :] for coord in table)


def scalar_mul_var(nibbles: torch.Tensor, a: Point) -> Point:
    """[k]A for per-element points A — 4-bit fixed windows, MSB first.

    nibbles: integer [..., 64], little-endian (nibbles[..., 0] = k & 0xF).
    252 doublings + 63 adds + 14 table-build adds, all batched."""
    ident = identity(nibbles.shape[:-1], nibbles.device)
    steps = [ident]  # window table T[d] = d * A, per coordinate [..., 16, 22]
    for _ in range(15):
        steps.append(padd(steps[-1], a))
    table = tuple(torch.stack([s[c] for s in steps], dim=-2) for c in range(4))
    acc = ident
    for i in range(WINDOWS):
        acc = pdouble(pdouble(pdouble(pdouble(acc))))
        acc = padd(acc, _gather_point(table, nibbles[..., WINDOWS - 1 - i]))
    return acc


def scalar_mul_base(nibbles: torch.Tensor) -> Point:
    """[s]B via the comb table: 64 adds, zero doublings.

    nibbles: integer [..., 64] little-endian. acc = sum_i TABLE[i][s_i]."""
    dev = nibbles.device
    xs, ys, ts = (torch.as_tensor(t, device=dev) for t in b_table())
    batch_shape = nibbles.shape[:-1]
    one = F.const("ONE", dev).expand(*batch_shape, F.LIMBS)
    acc = identity(batch_shape, dev)
    for i in range(WINDOWS):
        nib = nibbles[..., i].long()
        acc = padd(acc, (xs[i][nib], ys[i][nib], one, ts[i][nib]))
    return acc


# ---------------------------------------------------------------------------
# The verify equation
# ---------------------------------------------------------------------------


def verify_core(
    s_nibbles: torch.Tensor,
    k_nibbles: torch.Tensor,
    a_point: Point,
    a_valid: torch.Tensor,
    r_y: torch.Tensor,
    r_sign: torch.Tensor,
    prevalid: torch.Tensor,
) -> torch.Tensor:
    """Batched non-cofactored Ed25519 check: [s]B == R + [k]A.

    Hashing (k), the s < L check and byte parsing happen on the host.
    Returns the bool accept mask, ANDed with ``a_valid`` (the key
    decompressed), R's decompression validity and ``prevalid`` (the host's
    structural checks)."""
    r_point, r_valid = decompress(r_y, r_sign)
    lhs = scalar_mul_base(s_nibbles)
    ka = scalar_mul_var(k_nibbles, a_point)
    rhs = padd(r_point, ka)
    return points_equal(lhs, rhs) & a_valid & r_valid & prevalid
