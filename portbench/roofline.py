"""The yardstick of the kernels: the card's peaks, the least time a piece
of work can take on it, and the work each comb kernel does a dispatch.

Copied from ``chip_smoke.py`` (``bound``, ``HBM_BYTES_PER_S``,
``PADD_IMADS``, the finish kernel's count), with the int32 rate fixed at
the H100 SXM's published figures instead of read from the card: 64 int32
lanes per SM per clock x 132 SMs x 1,980 MHz. Carries are left out of the
operation counts, so a share is a lower estimate of what the kernel
reaches.

The work depends only on a dispatch's padded rows and the comb's width:
4-bit windows (the program's default, 64 entries a scalar) or 8-bit ones
(32 entries) where the configuration's knobs set ``DAGRIDER_COMB_BITS``.
A change to the algorithm (another tree, another tail) changes these
counts, and recounting them is a change to the benchmark.
"""

from __future__ import annotations

from portbench import devtrace

HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM data sheet
INT32_LANES_PER_SM_CLOCK = 64
SMS = 132
MAX_SM_HZ = 1.98e9
IMAD_PER_S = INT32_LANES_PER_SM_CLOCK * SMS * MAX_SM_HZ  # 16.73e12

P = 2**255 - 19
LIMBS = 22
LIMB_BITS = 12
IMAD_PER_PRODUCT = LIMBS * LIMBS  # one 22-limb schoolbook product

_D = (-121665 * pow(121666, P - 2, P)) % P
_SQRT_M1 = pow(2, (P - 1) // 4, P)


def nonzero_limbs(x: int) -> int:
    """Limbs of a constant in 12-bit radix that are not 0 (a product by
    it skips the zero ones)."""
    return sum(1 for i in range(LIMBS) if (x >> (LIMB_BITS * i)) & ((1 << LIMB_BITS) - 1))


#: one complete addition, point + cached entry: 8 general products and the
#: product by 2d
PADD_IMADS = 8 * IMAD_PER_PRODUCT + LIMBS * nonzero_limbs(2 * _D % P)
#: the tail a row: 285 general products (R's decompression and square-root
#: chain, R + [k]A, the projective equality) and the products by d,
#: sqrt(-1) and 2d
FINISH_IMADS = 285 * IMAD_PER_PRODUCT + LIMBS * (
    nonzero_limbs(_D) + nonzero_limbs(_SQRT_M1) + nonzero_limbs(2 * _D % P))

DEFAULT_COMB_BITS = 4
POINT_BYTES = 4 * LIMBS * 4  # a packed XYZT point of int32 limbs


def comb_bits(cfg: dict) -> int:
    """The comb's window width that the configuration runs: its
    ``DAGRIDER_COMB_BITS`` knob, else the program's default."""
    return int(cfg.get("knobs", {}).get("DAGRIDER_COMB_BITS") or DEFAULT_COMB_BITS)


def tree_work(rows: int, bits: int = DEFAULT_COMB_BITS):
    """(bytes, int32 multiply-adds) of ``tree_sum_xyzt_kernel`` over a
    dispatch of ``rows`` padded rows: two groups a row ([s]B and [k]A) of
    256 / ``bits`` gathered entries, each summed by one addition fewer; the
    entries read once and the two sums written once."""
    groups, entries = 2 * rows, 256 // bits
    bytes_moved = groups * (entries + 1) * POINT_BYTES
    return bytes_moved, groups * (entries - 1) * PADD_IMADS


def finish_work(rows: int, bits: int = DEFAULT_COMB_BITS):
    """(bytes, int32 multiply-adds) of ``finish_kernel``, the same at every
    comb width: R.y (22 limbs)
    and its sign, the two sums (176 limbs) read, the verdict written."""
    return (LIMBS + 1 + 2 * 4 * LIMBS + 1) * 4 * rows, rows * FINISH_IMADS


def bound_s(bytes_moved: float, imads: float) -> float:
    """The least seconds the card can take for this work: the larger of
    the bytes over the memory rate and the operations over the int32
    rate."""
    return max(bytes_moved / HBM_BYTES_PER_S, imads / IMAD_PER_S)


#: kernel name (as the device trace shows it, up to the argument list)
#: -> its work model
KERNELS = {"tree_sum_xyzt_kernel": tree_work, "finish_kernel": finish_work}


def dispatch_rows(fp: dict) -> int:
    """The padded rows of one dispatch, from a run's work fingerprint."""
    return fp["padded_rows_per_request"] // fp["dispatches_per_request"]


def share(ctx, kernel: str):
    """``kernel``'s share of its roofline, in %, over a run's traced
    window: the least time the card could take for the work of every
    launch of it that the trace holds, each over the cell's padded rows a
    dispatch, over the kernel's time in the trace. None when the trace
    holds no launch of it."""
    if ctx.trace is None:
        return None
    launches, seconds = devtrace.kernel_time(ctx.trace, kernel)
    if not launches or seconds <= 0:
        return None
    work = KERNELS[kernel](dispatch_rows(ctx.fingerprint), comb_bits(ctx.config))
    return 100.0 * launches * bound_s(*work) / seconds
