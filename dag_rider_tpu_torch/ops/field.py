"""GF(2^255 - 19) arithmetic in int32 limbs — the port's field layer.

Torch twin of ``dag_rider_tpu/ops/field.py``: the same representation and
the same sequence of carries, masks and folds, so every function returns
the same int32 limbs as its JAX counterpart on the same inputs (not just
the same value mod p — tree sums feed the finish kernel raw).

- Field elements are **22 little-endian signed limbs of 12 bits** in
  int32 (radix 2^12, 264 bits).
- "Reduced" invariant (what every public op accepts and returns):
  ``|limb0| < 2^14`` and ``|limb_i| < 2^13`` for i >= 1. Every schoolbook
  column then stays below 2 * 2^27 + 20 * 2^26 < 2^31: no product
  overflows int32, so no widening multiply is needed.
- Carries are parallel steps (every limb shifts at once); exact
  sequential passes run only inside :func:`canonical`.
- ``>>`` on int32 tensors is an arithmetic shift and ``&`` is two's
  complement, on the CPU and on CUDA alike, so negative limbs carry
  correctly.

Functions take int32 tensors ``[..., 22]`` on any device and return on the
same device. The host helpers (``to_limbs``/``from_limbs``) are numpy.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# --- representation parameters --------------------------------------------

LIMB_BITS = 12
LIMBS = 22  # 22 * 12 = 264 >= 255
LIMB_MASK = (1 << LIMB_BITS) - 1
P_INT = 2**255 - 19

# 2^255 == 19 (mod p). Limb 21 spans bits 252..263, so one unit of the
# virtual "limb 22" (weight 2^264 = 2^255 * 2^9) folds to 19 * 2^9 at limb 0.
TOP_FOLD = 19 << 9  # 9728


def to_limbs(x: int) -> np.ndarray:
    """Host helper: python int in [0, 2^264) -> limb vector (int32[22])."""
    if not 0 <= x < 2**264:
        raise ValueError("out of limb range")
    out = np.zeros(LIMBS, dtype=np.int32)
    for i in range(LIMBS):
        out[i] = x & LIMB_MASK
        x >>= LIMB_BITS
    return out


def from_limbs(limbs) -> int:
    """Host helper: limb vector -> python int (signed limbs allowed)."""
    arr = np.asarray(limbs, dtype=np.int64)
    val = 0
    for i in reversed(range(arr.shape[-1])):
        val = (val << LIMB_BITS) + int(arr[..., i])
    return val


P_LIMBS = to_limbs(P_INT)
# 2^14 * p: added inside canonical() to force any reduced (possibly
# negative) value positive before exact normalization.
BIG_P = (P_LIMBS.astype(np.int64) << 14).astype(np.int32)

D_INT = (-121665 * pow(121666, P_INT - 2, P_INT)) % P_INT
D2_INT = (2 * D_INT) % P_INT
SQRT_M1_INT = pow(2, (P_INT - 1) // 4, P_INT)

ZERO = np.zeros(LIMBS, dtype=np.int32)
ONE = to_limbs(1)
D = to_limbs(D_INT)
D2 = to_limbs(D2_INT)
SQRT_M1 = to_limbs(SQRT_M1_INT)

_CONSTS = {"ZERO": ZERO, "ONE": ONE, "D": D, "D2": D2, "SQRT_M1": SQRT_M1,
           "BIG_P": BIG_P}


@functools.lru_cache(maxsize=None)
def const(name: str, device: torch.device) -> torch.Tensor:
    """A limb constant (``"ONE"``, ``"D"``, ``"D2"``, ...) as an int32[22]
    tensor on ``device``, made once per device. Read-only by contract."""
    return torch.as_tensor(_CONSTS[name], dtype=torch.int32, device=device)


# --- carry propagation -----------------------------------------------------


def _carry_step(x: torch.Tensor) -> torch.Tensor:
    """One parallel carry step with the 2^255 == 19 fold at the top limb."""
    c = x >> LIMB_BITS
    low = x & LIMB_MASK
    shifted = torch.cat([c[..., -1:] * TOP_FOLD, c[..., :-1]], dim=-1)
    return low + shifted


def carry(x: torch.Tensor, steps: int = 2) -> torch.Tensor:
    """Propagate carries back to the reduced invariant (two steps for
    add/sub results, three for scaled values)."""
    for _ in range(steps):
        x = _carry_step(x)
    return x


# --- ring ops --------------------------------------------------------------


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b (mod p), reduced."""
    return carry(a + b, steps=2)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b (mod p), reduced. Signed limbs: no bias needed."""
    return carry(a - b, steps=2)


def neg(a: torch.Tensor) -> torch.Tensor:
    return carry(-a, steps=2)


_NCOLS = 46  # 43 product columns + headroom so no carry is ever dropped


def _columns(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook product columns c[k] = sum_{i+j=k} a_i b_j -> [..., 46]
    (22 shifted multiply-adds into one accumulator, as the JAX twin)."""
    a, b = torch.broadcast_tensors(a, b)
    c = a.new_zeros((*a.shape[:-1], _NCOLS))
    for i in range(LIMBS):
        c[..., i : i + LIMBS] += a[..., i : i + 1] * b
    return c


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b (mod p), reduced. Inputs must be reduced."""
    c = _columns(a, b)  # 46 columns, |col| < 2^31, cols 44+ start at 0
    # Two parallel column-normalize steps before the fold; carries spill
    # into columns 44/45 and none fall off the end.
    for _ in range(2):
        cc = c >> LIMB_BITS
        c = (c & LIMB_MASK) + torch.cat(
            [torch.zeros_like(cc[..., :1]), cc[..., :-1]], dim=-1
        )
    lo = c[..., :LIMBS]
    hi = c[..., LIMBS : LIMBS + LIMBS]  # cols 22..43: weight 19 * 2^(12j+9)
    t = hi * 19
    # t * 2^9 split across two limbs: low 3 bits of t stay at offset 9,
    # the rest moves one limb up.
    lo = lo + ((t & 0x7) << 9)
    up = t >> 3
    lo = lo + torch.cat([torch.zeros_like(up[..., :1]), up[..., :-1]], dim=-1)
    # up[21] lands at limb 22 (weight 2^264 == 19 * 2^9): fold once more.
    # cols 44/45: weights 2^528 and 2^540, both 23104 times a limb weight.
    # (lo is a fresh tensor here, so the in-place updates touch nothing else.)
    t2 = up[..., -1] * 19
    lo[..., 0] += (t2 & 0x7) << 9
    lo[..., 1] += t2 >> 3
    lo[..., 1] += c[..., 44] * 23104
    lo[..., 2] += c[..., 45] * 23104
    return carry(lo, steps=3)


def square(a: torch.Tensor) -> torch.Tensor:
    return mul(a, a)


def nsquare(a: torch.Tensor, n: int) -> torch.Tensor:
    """a^(2^n)."""
    for _ in range(n):
        a = square(a)
    return a


def mul_small(a: torch.Tensor, k: int) -> torch.Tensor:
    """a * k for python int 0 <= k < 2^12."""
    return carry(a * k, steps=3)


def pow22523(z: torch.Tensor) -> torch.Tensor:
    """z^(2^252 - 3) (mod p) — the exponent of RFC 8032 §5.1.3 square-root
    decompression: sqrt candidate x = u v^3 (u v^7)^(2^252 - 3)."""
    t0 = square(z)                     # 2
    t1 = mul(z, nsquare(t0, 2))        # 9
    t0 = mul(t0, t1)                   # 11
    t0 = mul(t1, square(t0))           # 31 = 2^5 - 1
    t0 = mul(nsquare(t0, 5), t0)       # 2^10 - 1
    t1 = mul(nsquare(t0, 10), t0)      # 2^20 - 1
    t2 = mul(nsquare(t1, 20), t1)      # 2^40 - 1
    t1 = mul(nsquare(t2, 10), t0)      # 2^50 - 1
    t2 = mul(nsquare(t1, 50), t1)      # 2^100 - 1
    t3 = mul(nsquare(t2, 100), t2)     # 2^200 - 1
    t1 = mul(nsquare(t3, 50), t1)      # 2^250 - 1
    return mul(nsquare(t1, 2), z)      # 2^252 - 3


def invert(z: torch.Tensor) -> torch.Tensor:
    """z^(p-2) = z^(2^255 - 21) (mod p); maps 0 -> 0."""
    t0 = square(z)                     # 2
    t1 = mul(z, nsquare(t0, 2))        # 9
    t0m = mul(t0, t1)                  # 11
    t1 = mul(t1, square(t0m))          # 31 = 2^5 - 1
    t1 = mul(nsquare(t1, 5), t1)       # 2^10 - 1
    t2 = mul(nsquare(t1, 10), t1)      # 2^20 - 1
    t3 = mul(nsquare(t2, 20), t2)      # 2^40 - 1
    t2 = mul(nsquare(t3, 10), t1)      # 2^50 - 1
    t3 = mul(nsquare(t2, 50), t2)      # 2^100 - 1
    t4 = mul(nsquare(t3, 100), t3)     # 2^200 - 1
    t2 = mul(nsquare(t4, 50), t2)      # 2^250 - 1
    return mul(nsquare(t2, 5), t0m)    # 2^255 - 32 + 11 = 2^255 - 21


# --- canonicalization / predicates ----------------------------------------


def _seq_pass(x: torch.Tensor):
    """Exact sequential carry over the 22 limbs -> (limbs, carry out)."""
    carry_in = torch.zeros_like(x[..., 0])
    limbs = []
    for i in range(LIMBS):
        v = x[..., i] + carry_in
        limbs.append(v & LIMB_MASK)
        carry_in = v >> LIMB_BITS
    return torch.stack(limbs, dim=-1), carry_in


def _seq_carry_fold(x: torch.Tensor) -> torch.Tensor:
    """Exact sequential carry pass + fold of all bits >= 255."""
    out, carry_in = _seq_pass(x)
    out[..., 0] += carry_in * TOP_FOLD
    hi = out[..., LIMBS - 1] >> 3  # bits 255..263, weight 2^255 == 19
    out[..., LIMBS - 1] &= 0x7
    out[..., 0] += hi * 19
    return out


def canonical(x: torch.Tensor) -> torch.Tensor:
    """Unique representative in [0, p), limbs strictly in [0, 2^12).

    BIG_P forces the value positive; three exact passes normalize to a
    value < 2^255; x >= p is then decided by whether x + 19 reaches
    bit 255."""
    x = x + const("BIG_P", x.device)
    for _ in range(3):
        x = _seq_carry_fold(x)
    t = x.clone()
    t[..., 0] += 19
    t, _ = _seq_pass(t)
    ge_p = (t[..., LIMBS - 1] >> 3) > 0  # bit 255 set => x >= p
    t[..., LIMBS - 1] &= 0x7  # == x - p
    return torch.where(ge_p[..., None], t, x)


def is_zero(x: torch.Tensor) -> torch.Tensor:
    """x == 0 (mod p) -> bool[...]. Input must be reduced."""
    return (canonical(x) == 0).all(dim=-1)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return is_zero(sub(a, b))


def parity(x: torch.Tensor) -> torch.Tensor:
    """Low bit of the canonical representative (RFC 8032 sign bit)."""
    return canonical(x)[..., 0] & 1


def select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """cond ? a : b, limb-wise; cond is bool[...] broadcast over limbs."""
    return torch.where(cond[..., None], a, b)
