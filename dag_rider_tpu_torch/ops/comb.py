"""Fixed-key comb verification (4-bit and 8-bit windows) — the port's
device path.

Torch twin of ``dag_rider_tpu/ops/comb.py``. The committee is fixed for a
run, so [k]A becomes a sum of 64 entries of per-key tables
(``TABLE[key, w, d] = d * 16^w * A_key``) built once on the device, and
[s]B a sum of 64 entries of the base-point table. Both sums are one
gather plus a 6-level tree of complete additions; the tail decompresses R
and checks [s]B == R + [k]A projectively. The equation is not rearranged
into [s]B - [k]A, which would differ on keys with 8-torsion components.
The 8-bit variant (``DAGRIDER_COMB_BITS=8``) sums 32 entries of 256-entry
windows instead: half the gather rows and a 5-level tree, at 16x the
table memory.

Representation: a *packed* point is one int32 tensor [..., 4, 22] with
rows (X, Y, Z, T); a *cached* entry has rows (Y-X, Y+X, 2dT, 2Z).

On CUDA tensors the table builds, the tree additions and the tail run in
the hand-written kernels of :mod:`dag_rider_tpu_torch.ops.cuda_group`; on
CPU tensors the same wrappers run their plain torch versions. Both give
the same limbs.
"""

from __future__ import annotations

import numpy as np
import torch

from dag_rider_tpu_torch.ops import curve, field as F

WINDOWS = 64  # 4-bit windows over 256-bit scalars
ENTRIES = 16
WINDOWS8 = 32  # 8-bit windows
ENTRIES8 = 256


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


def window_bases(
    a_x: torch.Tensor, a_y: torch.Tensor, a_t: torch.Tensor, windows: int, doublings: int
) -> torch.Tensor:
    """Packed window bases [n, windows, 4, 22]: base w is 2^(doublings * w)
    * A_key, A_key = (x, y, 1, t), each the previous base doubled
    ``doublings`` times (plain torch)."""
    one = F.const("ONE", a_x.device).expand(a_x.shape[0], F.LIMBS)
    b = torch.stack([a_x, a_y, one, a_t], dim=-2)  # packed [n, 4, 22]
    bases = [b]
    for _ in range(windows - 1):
        for _ in range(doublings):
            b = pdouble_packed(b)
        bases.append(b)
    return torch.stack(bases, dim=1)


def build_key_tables_plain(
    a_x: torch.Tensor, a_y: torch.Tensor, a_t: torch.Tensor
) -> torch.Tensor:
    """Plain version of :func:`build_key_tables`: the window bases, then
    every window's identity and 15 successive additions of its base b,
    ``padd_cached(prev, to_cached(b))``, for all windows at once."""
    bases = window_bases(a_x, a_y, a_t, WINDOWS, 4)  # [n, 64, 4, 22]
    cached = to_cached(bases)
    prev = pack_point(curve.identity(bases.shape[:2], a_x.device))
    entries = [prev]
    for _ in range(ENTRIES - 1):
        prev = padd_cached(prev, cached)
        entries.append(prev)
    return torch.stack(entries, dim=2)  # [n, 64, 16, 4, 22]


def build_key_tables(
    a_x: torch.Tensor, a_y: torch.Tensor, a_t: torch.Tensor
) -> torch.Tensor:
    """Packed-XYZT comb tables for every key: [n, 64, 16, 4, 22] int32 on
    the keys' device. TABLE[key, w, d] = d * 16^w * A_key.

    Window w holds the identity and 15 successive additions of the window
    base b = 16^w * A; the next base is four doublings of b. On the card
    the build is two kernel launches (:func:`cuda_group.key_tables`),
    written straight into the gather's flat rows; on the CPU it is
    :func:`build_key_tables_plain`."""
    from dag_rider_tpu_torch.ops import cuda_group

    n = a_x.shape[0]
    return cuda_group.key_tables(a_x, a_y, a_t).view(n, WINDOWS, ENTRIES, 4, F.LIMBS)


def base_table_xyzt() -> np.ndarray:
    """Packed-XYZT comb table for the base point B: [64, 16, 4, 22]
    (host-built from curve.b_table()'s affine entries: Z == 1, T = x*y)."""
    xs, ys, ts = curve.b_table()  # [64, 16, 22] each, affine
    ones = np.broadcast_to(F.ONE, xs.shape).copy()
    return np.stack([xs, ys, ones, ts], axis=2)  # [64, 16, 4, 22]


# Digit -> table-position permutation for the 8-bit tables. The build
# stores each level's entries block-ordered ([all evens; all odds] of the
# previous level's order) instead of digit-ordered, as the JAX package's
# tables are (an interleaving stack inside its scan body miscompiled on the
# TPU). Position order is L_0 = [1], L_{l+1} = [2d for d in L_l] + [2d+1
# for d in L_l].
def _digit_pos8() -> np.ndarray:
    order = [0, 1]
    cur = [1]
    for _ in range(7):
        cur = [2 * d for d in cur] + [2 * d + 1 for d in cur]
        order += cur
    pos = np.zeros(ENTRIES8, dtype=np.int32)
    for p, d in enumerate(order):
        pos[d] = p
    return pos


DIGIT_POS8 = _digit_pos8()


def build_key_tables8_plain(
    a_x: torch.Tensor, a_y: torch.Tensor, a_t: torch.Tensor
) -> torch.Tensor:
    """Plain version of :func:`build_key_tables8`: the window bases, then
    every window's 7 levels for all windows at once: the evens of a level
    double the previous level, the odds are ``padd_cached(evens,
    to_cached(b))``."""
    bases = window_bases(a_x, a_y, a_t, WINDOWS8, 8)  # [n, 32, 4, 22]
    cached = to_cached(bases)[:, :, None]
    prev = bases[:, :, None]  # [n, 32, m, 4, 22]
    levels = [pack_point(curve.identity(bases.shape[:2], a_x.device))[:, :, None], prev]
    for _lvl in range(7):
        evens = pdouble_packed(prev)
        prev = torch.cat([evens, padd_cached(evens, cached)], dim=2)
        levels.append(prev)
    return torch.cat(levels, dim=2)  # [n, 32, 256, 4, 22]


def build_key_tables8(
    a_x: torch.Tensor, a_y: torch.Tensor, a_t: torch.Tensor
) -> torch.Tensor:
    """8-bit-window comb tables: [n, 32, 256, 4, 22] int32 on the keys'
    device. TABLE[key, w, DIGIT_POS8[d]] = d * 256^w * A_key (block
    order, see :data:`DIGIT_POS8`).

    Each window's 256 entries come in 8 levels: the evens of a level are
    doubles of the previous level, the odds add the window base b. On the
    card the build is two kernel launches (:func:`cuda_group.key_tables8`),
    written straight into the gather's flat rows; on the CPU it is
    :func:`build_key_tables8_plain`."""
    from dag_rider_tpu_torch.ops import cuda_group

    n = a_x.shape[0]
    return cuda_group.key_tables8(a_x, a_y, a_t).view(n, WINDOWS8, ENTRIES8, 4, F.LIMBS)


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


def gather_entries8(
    s_bytes: torch.Tensor,
    k_bytes: torch.Tensor,
    key_idx: torch.Tensor,
    key_tables: torch.Tensor,
    b_table: torch.Tensor,
) -> torch.Tensor:
    """The 8-bit comb walk's table entries: [B, 2, 32, 4, 22]. Tables
    arrive flat: key_tables [n * 32 * 256, 88], b_table [32 * 256, 88];
    s_bytes/k_bytes are the raw little-endian scalar bytes, int64 [B, 32]."""
    pos = torch.as_tensor(DIGIT_POS8, device=s_bytes.device).long()
    wins = torch.arange(WINDOWS8, device=s_bytes.device)[None, :]
    b_rows = b_table[wins * ENTRIES8 + pos[s_bytes]]  # [B, 32, 88]
    a_rows = key_tables[(key_idx[:, None] * WINDOWS8 + wins) * ENTRIES8 + pos[k_bytes]]
    stacked = torch.stack([b_rows, a_rows], dim=1)  # [B, 2, 32, 88]
    return stacked.reshape(*stacked.shape[:-1], 4, F.LIMBS)


def comb_verify_core8(
    s_bytes: torch.Tensor,
    k_bytes: torch.Tensor,
    key_idx: torch.Tensor,
    key_tables: torch.Tensor,
    b_table: torch.Tensor,
    a_valid: torch.Tensor,
    r_y: torch.Tensor,
    r_sign: torch.Tensor,
    prevalid: torch.Tensor,
) -> torch.Tensor:
    """8-bit-window twin of :func:`comb_verify_core`: the same accept
    mask, from the byte digits of s and k (int64 [B, 32]) and the tables
    of :func:`build_key_tables8`. The tree runs at 32 entries a group."""
    from dag_rider_tpu_torch.ops import cuda_group

    entries = gather_entries8(s_bytes, k_bytes, key_idx, key_tables, b_table)
    acc = cuda_group.tree_sum_xyzt(entries)  # [B, 2, 4, 22]
    ok = cuda_group.finish_check(r_y, r_sign, acc)
    return ok & a_valid & prevalid
