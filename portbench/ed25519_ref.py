"""Plain Ed25519 (RFC 8032, section 5.1): key generation, signing and the
verification that decides a row's verdict.

The benchmark's own code. It imports nothing but the standard library: it
makes the keys and signatures of the inputs, and it is the plain reference
that the program's accept masks are held to.

Verification is cofactorless, as the program states it: a row is accepted
when A and R decode (y < p, x recoverable, no x = 0 with the sign bit set),
s < L, and [s]B == R + [k]A with k = SHA-512(R || A || M) mod L, compared
projectively. The equation is not rearranged into [s]B - [k]A == R.

Points are extended twisted Edwards coordinates (X, Y, Z, T) over Python
integers. [s]B walks a table of 64 x 16 multiples of B, built once a
process; [k]A is a 4-bit fixed-window walk.
"""

from __future__ import annotations

import hashlib
from typing import List, Optional, Tuple

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P
D2 = (2 * D) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)

Point = Tuple[int, int, int, int]
IDENTITY: Point = (0, 1, 1, 0)


def _recover_x(y: int, sign: int) -> Optional[int]:
    """RFC 8032 5.1.3: x from y and the sign bit, or None."""
    if y >= P:
        return None
    x2 = (y * y - 1) * pow(D * y * y + 1, P - 2, P) % P
    if x2 == 0:
        return None if sign else 0
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P:
        x = x * SQRT_M1 % P
    if (x * x - x2) % P:
        return None
    if (x & 1) != sign:
        x = P - x
    return x


_BY = 4 * pow(5, P - 2, P) % P
_BX = _recover_x(_BY, 0)
BASE: Point = (_BX, _BY, 1, _BX * _BY % P)


def add(p: Point, q: Point) -> Point:
    """add-2008-hwcd-3 (a = -1): complete on the whole curve."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = t1 * D2 * t2 % P
    d = 2 * z1 * z2 % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def double(p: Point) -> Point:
    """dbl-2008-hwcd (a = -1)."""
    x1, y1, z1, _ = p
    a = x1 * x1 % P
    b = y1 * y1 % P
    c = 2 * z1 * z1 % P
    h = a + b
    e = h - (x1 + y1) * (x1 + y1) % P
    g = a - b
    f = c + g
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def equal(p: Point, q: Point) -> bool:
    """Projective equality: X1 Z2 == X2 Z1 and Y1 Z2 == Y2 Z1."""
    return (p[0] * q[2] - q[0] * p[2]) % P == 0 and (p[1] * q[2] - q[1] * p[2]) % P == 0


_BASE_TABLE: List[List[Point]] = []


def _base_table() -> List[List[Point]]:
    """TABLE[w][d] = d * 16^w * B, for w < 64 and d < 16 (built once)."""
    if not _BASE_TABLE:
        b = BASE
        for _ in range(64):
            row = [IDENTITY, b]
            for _ in range(14):
                row.append(add(row[-1], b))
            _BASE_TABLE.append(row)
            for _ in range(4):
                b = double(b)
    return _BASE_TABLE


def mul_base(s: int) -> Point:
    """[s]B for 0 <= s < 2^256, one table entry per 4-bit window."""
    table = _base_table()
    acc = IDENTITY
    for w in range(64):
        d = (s >> (4 * w)) & 15
        if d:
            acc = add(acc, table[w][d])
    return acc


def mul(k: int, p: Point) -> Point:
    """[k]p for 0 <= k < 2^256, 4-bit fixed windows from the top."""
    row = [IDENTITY, p]
    for _ in range(14):
        row.append(add(row[-1], p))
    acc = IDENTITY
    for w in range(63, -1, -1):
        acc = double(double(double(double(acc))))
        d = (k >> (4 * w)) & 15
        if d:
            acc = add(acc, row[d])
    return acc


def compress(p: Point) -> bytes:
    x, y, z, _ = p
    zi = pow(z, P - 2, P)
    x, y = x * zi % P, y * zi % P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def decompress(s: bytes) -> Optional[Point]:
    if len(s) != 32:
        return None
    v = int.from_bytes(s, "little")
    y, sign = v & ((1 << 255) - 1), v >> 255
    x = _recover_x(y, sign)
    if x is None:
        return None
    return (x, y, 1, x * y % P)


def _h(*parts: bytes) -> int:
    h = hashlib.sha512()
    for part in parts:
        h.update(part)
    return int.from_bytes(h.digest(), "little")


def expand(seed: bytes) -> Tuple[int, bytes, bytes]:
    """A 32-byte secret seed -> (scalar a, prefix, public key A)."""
    digest = hashlib.sha512(seed).digest()
    a = int.from_bytes(digest[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a, digest[32:], compress(mul_base(a))


def sign(a: int, prefix: bytes, pub: bytes, msg: bytes) -> bytes:
    r = _h(prefix, msg) % L
    r_enc = compress(mul_base(r))
    k = _h(r_enc, pub, msg) % L
    return r_enc + ((r + k * a) % L).to_bytes(32, "little")


def verify(pub: bytes, msg: bytes, sig: bytes, hashed: Optional[int] = None) -> bool:
    """The verdict of one row. ``hashed`` bounds the message bytes that
    enter the challenge (None: all of them); only the control sets it."""
    if len(sig) != 64 or len(pub) != 32:
        return False
    a = decompress(pub)
    r = decompress(sig[:32])
    if a is None or r is None:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= L:
        return False
    k = _h(sig[:32], pub, msg if hashed is None else msg[:hashed]) % L
    return equal(mul_base(s), add(r, mul(k, a)))
