"""Ed25519 (RFC 8032) — host reference implementation.

A verbatim copy of ``dag_rider_tpu/crypto/ed25519.py``: the port keeps its
own copy so that it imports nothing of the JAX package.

The reference repository has **no cryptography at all** (SURVEY.md D10: no
signatures, no authentication, ``go.mod`` has no crypto deps). This module
supplies the per-vertex signing scheme the north star requires
(BASELINE.json: "per-vertex reliable-broadcast verify ... vmap'd Ed25519"),
implemented from the RFC 8032 specification in pure Python:

- the *correctness oracle* for the TPU verifier (byte-identical accept
  masks are asserted between this and the JAX/Pallas path), and
- the CPU Verifier backend (configs #1-2 of the benchmark ladder).

Big-int field arithmetic uses Python ints (CPython's native bignums); the
TPU path re-implements the field in int32 limbs (ops/field.py).
"""

from __future__ import annotations

import hashlib
import secrets
from typing import List, Optional, Sequence, Tuple

# --- field / curve parameters (RFC 8032 §5.1) ------------------------------

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493  # group order
D = (-121665 * pow(121666, P - 2, P)) % P  # edwards d
SQRT_M1 = pow(2, (P - 1) // 4, P)  # sqrt(-1)

# Base point: y = 4/5 (mod p), x recovered with even parity.
_BY = (4 * pow(5, P - 2, P)) % P


def _inv(x: int) -> int:
    return pow(x, P - 2, P)


def _recover_x(y: int, sign: int) -> Optional[int]:
    """x from y via x^2 = (y^2 - 1) / (d y^2 + 1)  (RFC 8032 §5.1.3)."""
    if y >= P:
        return None
    x2 = (y * y - 1) * _inv(D * y * y + 1) % P
    if x2 == 0:
        return None if sign else 0
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P != 0:
        x = x * SQRT_M1 % P
    if (x * x - x2) % P != 0:
        return None
    if x & 1 != sign:
        x = P - x
    return x


_BX = _recover_x(_BY, 0)
assert _BX == 15112221349535400772501151409588531511454012693041857206046113283949847762202

# Points are extended homogeneous coordinates (X, Y, Z, T), x=X/Z, y=Y/Z,
# T = XY/Z.
Point = Tuple[int, int, int, int]
B: Point = (_BX, _BY, 1, _BX * _BY % P)
IDENTITY: Point = (0, 1, 1, 0)


def point_add(p1: Point, p2: Point) -> Point:
    """Unified addition (RFC 8032 §5.1.4) — complete on the curve."""
    X1, Y1, Z1, T1 = p1
    X2, Y2, Z2, T2 = p2
    A = (Y1 - X1) * (Y2 - X2) % P
    Bv = (Y1 + X1) * (Y2 + X2) % P
    C = 2 * T1 * T2 * D % P
    Dv = 2 * Z1 * Z2 % P
    E = Bv - A
    F = Dv - C
    G = Dv + C
    H = Bv + A
    return (E * F % P, G * H % P, F * G % P, E * H % P)


def point_double(p1: Point) -> Point:
    X1, Y1, Z1, _ = p1
    A = X1 * X1 % P
    Bv = Y1 * Y1 % P
    C = 2 * Z1 * Z1 % P
    H = A + Bv
    E = H - (X1 + Y1) * (X1 + Y1)
    G = A - Bv
    F = C + G
    return (E * F % P, G * H % P, F * G % P, E * H % P)


def point_neg(p1: Point) -> Point:
    X, Y, Z, T = p1
    return (P - X if X else 0, Y, Z, P - T if T else 0)


def scalar_mult(s: int, p1: Point) -> Point:
    """Double-and-add (host oracle; the TPU path uses fixed windows)."""
    q = IDENTITY
    while s > 0:
        if s & 1:
            q = point_add(q, p1)
        p1 = point_double(p1)
        s >>= 1
    return q


# Fixed-base comb for B — the host-side twin of the TPU verifier's comb
# tables (ops/comb.py): [s]B = sum_w [digit_w(s) * 16^w]B is 63 additions
# with ZERO doublings from a precomputed [64][16] table. Built lazily
# (~25 ms once); signing was ~8.5 ms/op on the 380-op double-and-add
# ladder and every sign/keygen multiplies the FIXED base, so this is the
# hot path of bench batch building and per-proposal signing.
_B_COMB: Optional[List[List[Point]]] = None


def _b_comb() -> List[List[Point]]:
    global _B_COMB
    if _B_COMB is None:
        table: List[List[Point]] = []
        g = B
        for _ in range(64):
            row = [IDENTITY]
            for _ in range(15):
                row.append(point_add(row[-1], g))
            table.append(row)
            for _ in range(4):
                g = point_double(g)
        _B_COMB = table
    return _B_COMB


def scalar_mult_base(s: int) -> Point:
    """[s]B via the fixed-base comb (bit-identical to scalar_mult(s, B):
    the same group element by associativity; tests assert equality).
    The 64-window table covers s < 2^256 — every RFC 8032 scalar (clamped
    secrets and values reduced mod L); larger inputs fall back to the
    ladder rather than walking off the table."""
    if s >= 1 << 256:
        return scalar_mult(s, B)
    table = _b_comb()
    q = IDENTITY
    w = 0
    while s > 0:
        d = s & 0xF
        if d:
            q = point_add(q, table[w][d])
        s >>= 4
        w += 1
    return q


def point_equal(p1: Point, p2: Point) -> bool:
    X1, Y1, Z1, _ = p1
    X2, Y2, Z2, _ = p2
    return (X1 * Z2 - X2 * Z1) % P == 0 and (Y1 * Z2 - Y2 * Z1) % P == 0


def point_compress(p1: Point) -> bytes:
    X, Y, Z, _ = p1
    zi = _inv(Z)
    x = X * zi % P
    y = Y * zi % P
    return int.to_bytes(y | ((x & 1) << 255), 32, "little")


def point_decompress(data: bytes) -> Optional[Point]:
    if len(data) != 32:
        return None
    enc = int.from_bytes(data, "little")
    y = enc & ((1 << 255) - 1)
    sign = enc >> 255
    x = _recover_x(y, sign)
    if x is None:
        return None
    return (x, y, 1, x * y % P)


def on_curve(p1: Point) -> bool:
    X, Y, Z, T = p1
    if Z % P == 0 or (X * Y - Z * T) % P != 0:
        return False
    # -x^2 + y^2 = z^2 + d t^2 (projective twisted Edwards a=-1)
    return (-X * X + Y * Y - Z * Z - D * T * T) % P == 0


# --- keys / sign / verify (RFC 8032 §5.1.5-5.1.7) --------------------------


def _sha512(*parts: bytes) -> bytes:
    h = hashlib.sha512()
    for part in parts:
        h.update(part)
    return h.digest()


def _clamp(h: bytes) -> int:
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a


def generate_keypair(seed: Optional[bytes] = None) -> Tuple[bytes, bytes]:
    """Returns (private_seed32, public_key32)."""
    if seed is None:
        seed = secrets.token_bytes(32)
    if len(seed) != 32:
        raise ValueError("seed must be 32 bytes")
    a = _clamp(_sha512(seed))
    A = scalar_mult_base(a)
    return seed, point_compress(A)


def expand_seed(seed: bytes) -> Tuple[int, bytes, bytes]:
    """One-time key expansion: (scalar a, prefix, A_enc). Callers that sign
    repeatedly (VertexSigner) cache this — re-deriving A costs a full
    scalar multiplication per signature otherwise."""
    h = _sha512(seed)
    a = _clamp(h)
    prefix = h[32:]
    A_enc = point_compress(scalar_mult_base(a))
    return a, prefix, A_enc


def sign_expanded(a: int, prefix: bytes, A_enc: bytes, message: bytes) -> bytes:
    r = int.from_bytes(_sha512(prefix, message), "little") % L
    R_enc = point_compress(scalar_mult_base(r))
    k = int.from_bytes(_sha512(R_enc, A_enc, message), "little") % L
    s = (r + k * a) % L
    return R_enc + int.to_bytes(s, 32, "little")


def sign(seed: bytes, message: bytes) -> bytes:
    return sign_expanded(*expand_seed(seed), message)


def verify(public_key: bytes, message: bytes, signature: bytes) -> bool:
    """Unbatched verification: [S]B == R + [k]A (non-cofactored)."""
    if len(signature) != 64 or len(public_key) != 32:
        return False
    A = point_decompress(public_key)
    R = point_decompress(signature[:32])
    if A is None or R is None:
        return False
    s = int.from_bytes(signature[32:], "little")
    if s >= L:  # malleability check (RFC 8032 §5.1.7)
        return False
    k = int.from_bytes(_sha512(signature[:32], public_key, message), "little") % L
    sB = scalar_mult_base(s)
    kA = scalar_mult(k, A)
    return point_equal(sB, point_add(R, kA))


def verify_batch(
    items: Sequence[Tuple[bytes, bytes, bytes]]
) -> List[bool]:
    """Per-item verification of (public_key, message, signature) triples.

    Intentionally independent per item (no random linear combination): the
    output is the per-vertex accept *mask* consensus consumes, and it must
    be byte-identical to the TPU verifier's mask — an RLC batch check only
    yields a single aggregate bit.
    """
    return [verify(pk, m, sig) for (pk, m, sig) in items]


def verify_precomputed(
    public_key: bytes, k: int, signature: bytes
) -> bool:
    """Verification with the SHA-512 challenge scalar k already computed.

    This is the exact host-side work split the TPU verifier uses: hashing
    (k) and decoding on host, group arithmetic on device. Used by
    differential tests to isolate the group-op path.
    """
    A = point_decompress(public_key)
    R = point_decompress(signature[:32])
    if A is None or R is None:
        return False
    s = int.from_bytes(signature[32:], "little")
    if s >= L:
        return False
    sB = scalar_mult_base(s)
    kA = scalar_mult(k % L, A)
    return point_equal(sB, point_add(R, kA))
