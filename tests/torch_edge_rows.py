"""Edge rows of the Ed25519 finish tail, and edge limbs of its square-root
chain, for the port's tests (CPU and card alike; imports no JAX).

A finish row is what ``cuda_group.finish_check`` takes for one signature:
R's y limbs [22], R's sign bit, and the tree's accumulators [2, 4, 22]
(``[s]B``, then ``[k]A``, each packed XYZT). The rows cover every arm of
the tail's decision tree: an accepted signature, a wrong ``[s]B``, a y with
no square root, x = 0 with the sign bit set, a non-canonical y >= p, an
8-torsion ``[k]A``, and the identity.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from dag_rider_tpu_torch.crypto import ed25519 as host
from dag_rider_tpu_torch.ops import field as F

P = F.P_INT
IDENTITY = (0, 1, 1, 0)


def _limbs(x: int) -> np.ndarray:
    return F.to_limbs(x % P)


def _packed(pt) -> np.ndarray:
    """Extended (X, Y, Z, T) ints -> packed XYZT limbs [4, 22]."""
    return np.stack([_limbs(c) for c in pt])


def _order8_point():
    """A point of order exactly 8: the torsion part [L] Q of a curve point
    Q, the first y = 2, 3, ... whose torsion part has order 8."""
    y = 2
    while True:
        x = host._recover_x(y, 0)
        if x is not None:
            t = host.scalar_mult(host.L, (x, y, 1, x * y % P))
            if not host.point_equal(host.scalar_mult(4, t), IDENTITY):
                return t
        y += 1


def _signature(seed: int, msg: bytes):
    """(R's y, R's sign, [s]B, [k]A) of a real signature."""
    sk, pk = host.generate_keypair(bytes([seed]) * 32)
    sig = host.sign(sk, msg)
    r_int = int.from_bytes(sig[:32], "little")
    s = int.from_bytes(sig[32:], "little")
    k = int.from_bytes(hashlib.sha512(sig[:32] + pk + msg).digest(), "little") % host.L
    a_pt = host.point_decompress(pk)
    return (r_int & ((1 << 255) - 1), r_int >> 255, host.scalar_mult(s, host.B),
            host.scalar_mult(k, a_pt))


def edge_rows():
    """(names, r_y int32 [R, 22], r_sign int32 [R], acc int32 [R, 2, 4, 22])."""
    y, sign, lhs, ka = _signature(7, b"finish-edge-rows")
    y2, sign2, lhs2, ka2 = _signature(9, b"another signature")
    t8 = _order8_point()
    rows = [
        ("valid", y, sign, lhs, ka),
        ("valid, another key", y2, sign2, lhs2, ka2),
        ("wrong [s]B", y, sign, host.B, ka),
        ("non-square y = 2", 2, 0, lhs, ka),
        ("y = 1, sign 1 (x = 0)", 1, 1, lhs, ka),
        ("y = 1, sign 0 (R the identity)", 1, 0, lhs, ka),
        ("y >= p (p + 9)", P + 9, 0, lhs, ka),
        ("8-torsion [k]A", y, sign, lhs, t8),
        ("valid + 8-torsion on both sides", y, sign, host.point_add(lhs, t8),
         host.point_add(ka, t8)),
        ("identity everywhere, R = identity", 1, 0, IDENTITY, IDENTITY),
        ("identity [k]A", y, sign, lhs, IDENTITY),
    ]
    names = [r[0] for r in rows]
    r_y = np.stack([F.to_limbs(r[1]) for r in rows])
    r_sign = np.array([r[2] for r in rows], np.int32)
    acc = np.stack([np.stack([_packed(r[3]), _packed(r[4])]) for r in rows])
    return names, torch.from_numpy(r_y), torch.from_numpy(r_sign), torch.from_numpy(acc)


def edge_limbs() -> torch.Tensor:
    """Field elements at the edges of the reduced invariant, int32 [M, 22]:
    every limb at +-4095 or +-8191 (limb 0 at +-16383), mixed signs from a
    seed, and 0, 1 and p - 1."""
    rng = np.random.default_rng(22523)
    rows = []
    for top in (4095, 8191):
        for fill in (1, -1):
            rows.append(np.full(F.LIMBS, fill * top, np.int32))
        rows.append(rng.choice([-top, top], F.LIMBS).astype(np.int32))
    for row in list(rows):
        for z0 in (16383, -16383):
            r = row.copy()
            r[0] = z0
            rows.append(r)
    rows += [F.to_limbs(0), F.to_limbs(1), F.to_limbs(P - 1)]
    return torch.from_numpy(np.stack(rows).astype(np.int32))


def tiled(rows: torch.Tensor, n: int) -> torch.Tensor:
    """The rows repeated along axis 0 to exactly n."""
    reps = -(-n // rows.shape[0])
    return rows.repeat(reps, *([1] * (rows.dim() - 1)))[:n].contiguous()
