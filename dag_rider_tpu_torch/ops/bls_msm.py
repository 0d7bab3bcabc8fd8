"""BLS12-381 G1 multi-scalar multiplication on the card.

Torch twin of ``dag_rider_tpu/ops/bls_msm.py``: the device half of
threshold-share aggregation (``crypto.threshold.aggregate(msm=...)``, the
common coin) and of round-certificate aggregation (``CertVerifier`` with
``msm="device"``, an all-ones MSM). The pairing checks stay on the host.

- Field: :mod:`dag_rider_tpu_torch.ops.field381` (signed 12-bit int32
  limbs, fold-matrix reduction).
- Group law: the Renes-Costello-Batina complete addition (eprint
  2015/1060, Algorithm 7, a = 0, b3 = 12) in homogeneous projective
  coordinates: no exceptional cases, no data-dependent control flow
  (``cuda_group381.padd``, re-exported here as :func:`padd`).
- MSM shape: radix-16 tables of 0..15 multiples per point (15 additions
  over T lanes), one gather of every window's digit entry ([T, 64]), a
  pairwise tree over the point axis (log2 T additions over 64 T / 2 lanes
  and down), then the Horner combination of the 64 window sums (4
  doublings + 1 addition per window on one point: 320 additions), and
  the canonical form of the result.

Points are limb-major [99, N] int32 (rows: X, Y, Z x 33 limbs). The
table steps and tree levels of :func:`msm_kernel` go through
``cuda_group381.padd381_xx`` (15 + log2 T launches), and the Horner chain
with ``field381.canonical`` of its result through one
``cuda_group381.horner381``: hand-written kernels for CUDA tensors, their
plain versions (:func:`padd`, ``field381.canonical``) for CPU tensors. The
raw limbs equal the JAX ``msm_kernel``'s. The gather is plain torch, as
it is plain jnp in the JAX package; the host reads the canonical limbs.

Scalars are taken mod r on the host; points arrive as host affine tuples
(from ``bls12381.g1_decompress``) and return as one host affine tuple.
:func:`msm` and :func:`sum_points` run on ``cuda`` unless the caller
passes ``device="cpu"``; without a card they raise.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from dag_rider_tpu_torch.ops import cuda_group381 as G, field381 as F

R_INT = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
P_INT = F.P_INT
WINDOWS = G.WINDOWS  # 256-bit scalar capacity in 4-bit windows (r is 255 bits)
L = F.LIMBS
ROWS = G.ROWS  # 99

Point = G.Point  # homogeneous (X, Y, Z) coordinate tensors [..., 33]
padd = G.padd  # the complete addition; plain version of padd381_xx


def resolve_device(device=None) -> torch.device:
    """The device an MSM runs on: ``cuda`` unless the caller asks for
    another. Raises when CUDA is asked for (or defaulted to) and there is
    no card — there is no silent CPU path."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' for the plain torch path"
        )
    return dev


# ---------------------------------------------------------------------------
# Windowed tree-sum MSM on limb-major [99, N] points
# ---------------------------------------------------------------------------


def _point_tables(x: torch.Tensor) -> torch.Tensor:
    """Radix-16 multiples [0..15]P of packed points [99, T] -> [16, 99, T]
    (15 additions over T lanes, each from the previous entry)."""
    prev = G.identity(x.shape[1], x.device)
    steps = [prev]
    for _ in range(15):
        prev = G.padd381_xx(prev, x)
        steps.append(prev)
    return torch.stack(steps)


def gather_windows(nibbles: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Every window's digit entry: nibbles int32 [T, 64], tables
    [16, 99, T] -> limb-major [99, T * 64] with lane = t * 64 + w (point
    index major, the tree's pairing axis)."""
    t = nibbles.shape[0]
    tab = tables.permute(2, 0, 1)  # [T, 16, 99]
    rows = torch.arange(t, device=tables.device)[:, None]
    ent = tab[rows, nibbles.long()]  # [T, 64, 99]
    return ent.reshape(t * WINDOWS, ROWS).t().contiguous()


def window_sums(nibbles: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-window partial sums S_w = sum_i [d_{i,w}] P_i of packed points
    [99, T] -> [99, 64].

    Radix-16 tables per point, one gather of every window's digit entry
    ([T, 64]), then a pairwise tree over the point axis
    (``cuda_group381.tree_sum_xyz381``). T must be a power of two."""
    lanes = gather_windows(nibbles, _point_tables(x))
    return G.tree_sum_xyz381(lanes, nibbles.shape[0])


def horner_combine(w: torch.Tensor) -> torch.Tensor:
    """sum_w 16^w S_w from packed window sums [99, 64] -> [99, 1]: 4
    doublings + 1 addition per window on a single point, in one
    ``cuda_group381.horner381``."""
    return G.horner381(w)[0]


def _msm_limbs(
    nibbles: torch.Tensor, px: torch.Tensor, py: torch.Tensor, pz: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MSM's raw accumulator [99, 1] and its canonical limbs [3, 33]."""
    pts = torch.cat([px, py, pz], dim=-1).t().contiguous()  # [99, T]
    return G.horner381(window_sums(nibbles, pts))


def msm_kernel(
    nibbles: torch.Tensor, px: torch.Tensor, py: torch.Tensor, pz: torch.Tensor
) -> Point:
    """sum_i [k_i] P_i for a padded batch of T points (T a power of two).

    nibbles: int32[T, 64]; px/py/pz: int32[T, 33], all on one device. Pad
    slots use scalar 0 (maps to the identity). Returns one projective
    point (X, Y, Z) [33] of raw limbs: 15 + log2 T additions, then the
    320-step Horner chain."""
    acc, _ = _msm_limbs(nibbles, px, py, pz)
    return acc[0:L, 0], acc[L : 2 * L, 0], acc[2 * L :, 0]


# ---------------------------------------------------------------------------
# Host seam: threshold.aggregate(msm=...) and CertVerifier._sum_points
# ---------------------------------------------------------------------------


def _nibbles(k: int) -> np.ndarray:
    out = np.zeros(WINDOWS, dtype=np.int32)
    for i in range(WINDOWS):
        out[i] = (k >> (4 * i)) & 0xF
    return out


def _pad(n: int, base: int = 4) -> int:
    """Smallest base * 2^k >= max(n, base) — the padded batch size."""
    t = base
    while t < n:
        t *= 2
    return t


def pack_inputs(
    scalars: Sequence[int], points: Sequence[tuple], t: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Marshal host (scalar, affine point) pairs into padded kernel inputs.

    Pad slots (and None points) become the identity (0 : 1 : 0) with
    scalar 0; scalars are reduced mod r."""
    if len(scalars) != len(points):
        raise ValueError("scalars/points length mismatch")
    nib = np.zeros((t, WINDOWS), dtype=np.int32)
    px = np.zeros((t, F.LIMBS), dtype=np.int32)
    py = np.zeros((t, F.LIMBS), dtype=np.int32)
    pz = np.zeros((t, F.LIMBS), dtype=np.int32)
    py[:] = F.ONE
    for i, (k, pt) in enumerate(zip(scalars, points)):
        if pt is None:
            continue  # identity contributes nothing regardless of scalar
        nib[i] = _nibbles(k % R_INT)
        px[i] = F.to_limbs(pt[0])
        py[i] = F.to_limbs(pt[1])
        pz[i] = F.ONE
    return nib, px, py, pz


def unpack_point(X, Y, Z) -> Optional[tuple]:
    """Projective limb point -> host affine (x, y) tuple (None: identity).

    Takes the canonical limbs that ``cuda_group381.horner381`` writes;
    the host reduces each coordinate mod p, so raw limbs of the same point
    give the same tuple."""
    xi, yi, zi = (F.from_limbs(c) % P_INT for c in torch.stack([X, Y, Z]).cpu().numpy())
    if zi == 0:
        return None
    z_inv = pow(zi, P_INT - 2, P_INT)
    return (xi * z_inv % P_INT, yi * z_inv % P_INT)


def msm(
    scalars: Sequence[int], points: Sequence[tuple], device=None
) -> Optional[tuple]:
    """Device MSM over host affine points; the ``msm=`` backend of
    :func:`dag_rider_tpu_torch.crypto.threshold.aggregate`.

    Args:
        scalars: python ints (reduced mod r here).
        points: affine (x, y) int tuples or None (identity).
        device: ``cuda`` (the default) or ``"cpu"`` for the plain path.

    Returns an affine (x, y) tuple, or None for the identity.
    """
    dev = resolve_device(device)
    t = _pad(len(points))
    arrays = pack_inputs(scalars, points, t)
    _, canon = _msm_limbs(*(torch.from_numpy(a).to(dev) for a in arrays))
    return unpack_point(*canon)


def sum_points(points: Sequence[tuple], device=None) -> Optional[tuple]:
    """Plain G1 point sum as an all-ones MSM — the device half of
    certificate signature aggregation. Same conventions as :func:`msm`."""
    return msm([1] * len(points), points, device=device)
