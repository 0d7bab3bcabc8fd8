"""GF(p) arithmetic for BLS12-381 in int32 limbs — the 381-bit field layer.

Torch twin of ``dag_rider_tpu/ops/field381.py``: the same representation
and the same sequence of carries, masks and folds, so every function
returns the same int32 limbs as its JAX counterpart on the same inputs
(the MSM's tree and Horner chain consume raw limbs, so value equality mod
p is not enough).

- **33 little-endian limbs of 12 bits in int32** (396 bits of headroom
  over the 381-bit p). Limbs are signed; subtraction is limb-wise.
- High product columns fold through a precomputed **fold matrix**: row j
  holds the 32 strict limbs of 2^(12(j+32)) mod p.
- "Reduced" invariant (accepted and produced by every public op): |limb|
  < 2^12 + 2^7 across all 33 limbs. Schoolbook columns then stay below
  33 * (2^12.07)^2 < 2^29.3, inside int32 — but only in this order of
  steps: two column-normalize passes, then the fold, then three carry
  steps.
- Carry propagation is parallel (all limbs at once, constant steps); the
  carry out of limb 32 (weight 2^396) folds via the matrix row for
  2^396 mod p. Exact sequential passes appear only in :func:`canonical`.

Functions take int32 tensors ``[..., 33]`` on any device and return on
the same device. The host helpers (``to_limbs``/``from_limbs``) are numpy.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

LIMB_BITS = 12
LIMBS = 33  # 33 * 12 = 396 >= 381
LIMB_MASK = (1 << LIMB_BITS) - 1
P_INT = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB

_NCOLS = 67  # 65 product columns (0..64) + 2 spill columns for carries


def _strict_limbs(x: int, n: int) -> np.ndarray:
    out = np.zeros(n, dtype=np.int32)
    for i in range(n):
        out[i] = x & LIMB_MASK
        x >>= LIMB_BITS
    if x:
        raise ValueError("value does not fit")
    return out


def to_limbs(x: int) -> np.ndarray:
    """Host helper: python int in [0, 2^396) -> int32[33]."""
    if not 0 <= x < 2**396:
        raise ValueError("out of limb range")
    return _strict_limbs(x, LIMBS)


def to_limbs_bulk(vals) -> np.ndarray:
    """Host helper: sequence of ints in [0, 2^396) -> int32[n, 33], by byte
    unpacking instead of a per-int loop."""
    n = len(vals)
    if n == 0:
        return np.zeros((0, LIMBS), dtype=np.int32)
    raw = np.frombuffer(
        b"".join(int(v).to_bytes(50, "little") for v in vals), dtype=np.uint8
    ).reshape(n, 50)
    bits = np.unpackbits(raw, axis=1, bitorder="little")[:, : LIMBS * LIMB_BITS]
    weights = (1 << np.arange(LIMB_BITS, dtype=np.int32)).astype(np.int32)
    return (
        bits.reshape(n, LIMBS, LIMB_BITS).astype(np.int32) * weights
    ).sum(axis=-1, dtype=np.int32)


def from_limbs(limbs) -> int:
    """Host helper: limb vector -> python int (signed limbs allowed)."""
    arr = np.asarray(limbs, dtype=np.int64)
    val = 0
    for i in reversed(range(arr.shape[-1])):
        val = (val << LIMB_BITS) + int(arr[..., i])
    return val


# Fold matrix: FOLD[j] = strict 32-limb decomposition of 2^(12(j+32)) mod p,
# for j = 0 .. 34. Row 1 (= 2^396 mod p) doubles as the top-limb fold inside
# the parallel carry step.
FOLD = np.stack(
    [
        _strict_limbs(pow(2, LIMB_BITS * (j + 32), P_INT), 32)
        for j in range(_NCOLS - 32)
    ]
).astype(np.int32)
_FOLD_TOP = np.zeros(LIMBS, dtype=np.int32)
_FOLD_TOP[:32] = FOLD[1]

ZERO = np.zeros(LIMBS, dtype=np.int32)
ONE = to_limbs(1)

# p * 2^15 > any reduced-magnitude value, held as 32 strict limbs + a wide
# top limb; added inside canonical() to force the value positive.
_BIG = P_INT << 15
_BIG_P = np.zeros(LIMBS, dtype=np.int32)
for _i in range(32):
    _BIG_P[_i] = (_BIG >> (LIMB_BITS * _i)) & LIMB_MASK
_BIG_P[32] = _BIG >> (LIMB_BITS * 32)  # < 2^13

# k*p in strict limbs for the canonical conditional subtractions
_KP = {k: to_limbs(k * P_INT) for k in (1, 2, 4, 8)}

_CONSTS = {
    "ZERO": ZERO, "ONE": ONE, "FOLD": FOLD, "FOLD_TOP": _FOLD_TOP,
    "FOLD0": FOLD[0], "BIG_P": _BIG_P,
    **{f"KP{k}": v for k, v in _KP.items()},
}


@functools.lru_cache(maxsize=None)
def const(name: str, device: torch.device) -> torch.Tensor:
    """A limb constant (``"ONE"``, ``"FOLD"``, ``"KP8"``, ...) as an int32
    tensor on ``device``, made once per device. Read-only by contract."""
    return torch.as_tensor(_CONSTS[name], dtype=torch.int32, device=device)


# --- carry propagation -----------------------------------------------------


def _shift_up(c: torch.Tensor) -> torch.Tensor:
    """[c_0, c_1, ...] -> [0, c_0, c_1, ...] (the last entry drops off)."""
    return torch.nn.functional.pad(c[..., :-1], (1, 0))


def _carry_step(x: torch.Tensor) -> torch.Tensor:
    """One parallel carry step; the carry out of limb 32 (weight 2^396)
    folds back through 2^396 mod p."""
    c = x >> LIMB_BITS
    low = x & LIMB_MASK
    return low + _shift_up(c) + c[..., -1:] * const("FOLD_TOP", x.device)


def carry(x: torch.Tensor, steps: int = 2) -> torch.Tensor:
    for _ in range(steps):
        x = _carry_step(x)
    return x


# --- ring ops --------------------------------------------------------------


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return carry(a + b, steps=2)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return carry(a - b, steps=2)


def neg(a: torch.Tensor) -> torch.Tensor:
    return carry(-a, steps=2)


def _columns(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook product columns c[k] = sum_{i+j=k} a_i b_j -> [..., 67]
    via the pad/reshape anti-diagonal trick of the JAX twin."""
    a, b = torch.broadcast_tensors(a, b)
    outer = a[..., :, None] * b[..., None, :]  # [..., 33, 33], |.| < 2^24.2
    padded = torch.nn.functional.pad(outer, (0, _NCOLS + 1 - LIMBS))
    flat = padded.reshape(*outer.shape[:-2], LIMBS * (_NCOLS + 1))
    flat = flat[..., : LIMBS * _NCOLS]
    return flat.reshape(*outer.shape[:-2], LIMBS, _NCOLS).sum(dim=-2, dtype=torch.int32)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b (mod p), reduced. Inputs must be reduced."""
    c = _columns(a, b)  # |col| < 33 * 2^24.2 < 2^29.3
    # Normalize columns before folding (fold rows are 12-bit, so columns
    # must be ~12-bit first). Carries spill into columns 65/66, which start
    # at zero; nothing falls off the end.
    for _ in range(2):
        c = (c & LIMB_MASK) + _shift_up(c >> LIMB_BITS)
    lo = c[..., :32]
    hi = c[..., 32:_NCOLS]  # 35 columns, weights 2^(12(j+32))
    # fold: lo += hi @ FOLD, |acc| < 2^12 + 35 * 2^24.2 < 2^29.4
    folded = lo + (hi[..., :, None] * const("FOLD", c.device)).sum(
        dim=-2, dtype=torch.int32
    )
    out = torch.nn.functional.pad(folded, (0, 1))  # limb 32 = 0
    return carry(out, steps=3)


def square(a: torch.Tensor) -> torch.Tensor:
    return mul(a, a)


def mul_small(a: torch.Tensor, k: int) -> torch.Tensor:
    """a * k for python int 0 <= k < 2^12."""
    return carry(a * k, steps=3)


def select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """cond ? a : b, limb-wise; cond is bool[...] broadcast over limbs."""
    return torch.where(cond[..., None], a, b)


# --- canonicalization / predicates ----------------------------------------


def _seq_limbs(x: torch.Tensor):
    """Exact sequential carry over the 33 limbs -> (strict limbs, carry out)."""
    carry_in = torch.zeros_like(x[..., 0])
    limbs = []
    for i in range(LIMBS):
        v = x[..., i] + carry_in
        limbs.append(v & LIMB_MASK)
        carry_in = v >> LIMB_BITS
    return torch.stack(limbs, dim=-1), carry_in


def _seq_pass(x: torch.Tensor) -> torch.Tensor:
    """Exact sequential carry pass; limbs 0..31 end strict in [0, 2^12),
    the top limb absorbs the tail and the 2^396 overflow folds back."""
    out, carry_in = _seq_limbs(x)
    return out + carry_in[..., None] * const("FOLD_TOP", x.device)


def _cond_sub(x: torch.Tensor, k: int) -> torch.Tensor:
    """x - k*p if that is non-negative else x (inputs strict-limbed)."""
    d_strict, carry_in = _seq_limbs(x - const(f"KP{k}", x.device))
    sub_ok = carry_in >= 0  # no net borrow out the top
    return select(sub_ok, d_strict, x)


def canonical(x: torch.Tensor) -> torch.Tensor:
    """Unique representative in [0, p), limbs strictly in [0, 2^12)."""
    x = x + const("BIG_P", x.device)
    for _ in range(3):
        x = _seq_pass(x)
    # Fold the strict top limb (weight 2^384) down repeatedly: each round
    # shrinks the above-2^384 excess by ~2^-3.5, ending below 1.4 * 2^384.
    for _ in range(4):
        top = x[..., 32]
        x = torch.cat(
            [
                x[..., :32] + top[..., None] * const("FOLD0", x.device),
                torch.zeros_like(x[..., 32:]),
            ],
            dim=-1,
        )
        x = _seq_pass(x)
    # now value < 1.4 * 2^384 < 15p: binary conditional subtraction
    for k in (8, 4, 2, 1):
        x = _cond_sub(x, k)
    return x


def is_zero(x: torch.Tensor) -> torch.Tensor:
    return (canonical(x) == 0).all(dim=-1)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return is_zero(sub(a, b))
