"""BLS12-381 G1 kernels on the H100 — wrappers and plain versions.

Replaces ``dag_rider_tpu/ops/pallas_group381.py``: ``_padd381_kernel``
(:func:`padd381_xx`, and :func:`tree_sum_xyz381` above it); and runs the
jnp Horner combination and ``field381.canonical`` of
``dag_rider_tpu/ops/bls_msm.py`` as one kernel (:func:`horner381`). The
kernels are CUDA C++ for sm_90a in ``csrc/bls381_group.cu`` over
limb-major [99, N] int32 points (rows: X, Y, Z x 33 limbs). One addition
is 12 general 33x33 products with their fold; on the MSM's path the
additions form dependent chains, so the kernels spread each addition over
a block of six warps (one product per warp and stage, a field element
across a warp's lanes, operands in shared memory); see the source.

The MSM (:mod:`dag_rider_tpu_torch.ops.bls_msm`) runs its 15 table steps
and log2 T tree levels through :func:`padd381_xx`, and its 320-step Horner
chain with the canonical form of the result through one :func:`horner381`.
Each wrapper takes its plain torch version for a CPU tensor and launches
its kernel for a CUDA tensor; there is no other path. The plain versions
are :func:`padd`, the complete addition on coordinate tensors, and the
same chain of :func:`padd` followed by ``field381.canonical``.
``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from dag_rider_tpu_torch.ops import cuda_group, field381 as F
from dag_rider_tpu_torch.utils import build

L = F.LIMBS  # 33
COORDS = 3
ROWS = COORDS * L  # 99
WINDOWS = 64  # window sums per Horner chain (4-bit windows of a 256-bit scalar)
SOURCE = "dag_rider_tpu_torch/csrc/bls381_group.cu"

#: kernel launches since the last :func:`reset_launches`
LAUNCHES = {"padd381_xx": 0, "horner381": 0}

_P, _N = ctypes.c_void_p, ctypes.c_longlong

Point = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # homogeneous (X, Y, Z)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    """The built ``bls381_group`` library with its C signatures declared
    (built and loaded on the first launch)."""
    handle = build.library("bls381_group")
    handle.dr_padd381_xx.argtypes = [_P, _N, _P, _N, _P, _N, _N, _P]
    handle.dr_padd381_xx.restype = ctypes.c_int
    handle.dr_horner381.argtypes = [_P, _N, _P, _P, _P]
    handle.dr_horner381.restype = ctypes.c_int
    return handle


def padd(p: Point, q: Point) -> Point:
    """Complete addition, RCB15 Algorithm 7 (a = 0, b3 = 12): 12M + 2m,
    on coordinate tensors [..., 33]. Plain torch; the kernel's body."""
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    t0 = F.mul(X1, X2)
    t1 = F.mul(Y1, Y2)
    t2 = F.mul(Z1, Z2)
    t3 = F.mul(F.add(X1, Y1), F.add(X2, Y2))
    t3 = F.sub(t3, F.add(t0, t1))
    t4 = F.mul(F.add(Y1, Z1), F.add(Y2, Z2))
    t4 = F.sub(t4, F.add(t1, t2))
    x3 = F.mul(F.add(X1, Z1), F.add(X2, Z2))
    y3 = F.sub(x3, F.add(t0, t2))
    x3 = F.add(F.add(t0, t0), t0)  # 3 X1 X2
    t2 = F.mul_small(t2, 12)  # b3 Z1 Z2
    z3 = F.add(t1, t2)
    t1 = F.sub(t1, t2)
    y3 = F.mul_small(y3, 12)  # b3 (X1 Z2 + X2 Z1)
    X3 = F.sub(F.mul(t3, t1), F.mul(t4, y3))
    Y3 = F.add(F.mul(y3, x3), F.mul(t1, z3))
    Z3 = F.add(F.mul(z3, t4), F.mul(x3, t3))
    return (X3, Y3, Z3)


def padd381_xx_plain(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Plain version: :func:`padd` on limb-major [99, N] operands."""

    def coords(x):
        return tuple(x[c * L : (c + 1) * L].t() for c in range(COORDS))

    out = padd(coords(p), coords(q))
    return torch.cat(out, dim=-1).t().contiguous()


def padd381_xx(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """p + q for packed XYZ int32 [99, N] operands -> [99, N].

    Operands may be column slices of a wider tensor (only the lanes must
    be contiguous); the output is a fresh contiguous tensor."""
    cuda_group.check_operand(p, ROWS, "p")
    cuda_group.check_operand(q, ROWS, "q")
    if p.shape != q.shape or p.device != q.device:
        raise ValueError("p and q must have one shape and one device")
    if p.device.type == "cpu":
        return padd381_xx_plain(p, q)
    n = p.shape[1]
    out = torch.empty((ROWS, n), dtype=torch.int32, device=p.device)
    cuda_group.launch("dr_padd381_xx", p.device, p.data_ptr(), p.stride(0), q.data_ptr(),
                      q.stride(0), out.data_ptr(), out.stride(0), n, handle=lib())
    cuda_group.count(LAUNCHES, "padd381_xx")
    return out


def tree_sum_xyz381(x: torch.Tensor, m: int) -> torch.Tensor:
    """Sum m packed XYZ points per element: limb-major [99, m * flat]
    (lane = i * flat + f) -> [99, flat], halving the lane axis log2(m)
    times with :func:`padd381_xx` (first half of the lanes paired with the
    second, as the JAX tree pairs them). m must be a power of two;
    identity (0:1:0) entries are harmless padding.

    The JAX wrapper takes [..., M, 3, 33] and transposes in and out; here
    the caller hands over the limb-major layout its gather already
    writes."""
    if m < 1 or m & (m - 1) or x.shape[1] % m:
        raise ValueError(f"tree_sum_xyz381: m = {m} over {x.shape[1]} lanes")
    flat = x.shape[1] // m
    while m > 1:
        half = m // 2 * flat
        x = padd381_xx(x[:, :half], x[:, half:])
        m //= 2
    return x


def identity(n: int, device) -> torch.Tensor:
    """n copies of the group identity (0 : 1 : 0), limb-major [99, n]."""
    x = torch.zeros((ROWS, n), dtype=torch.int32, device=device)
    x[L] = 1  # Y limb 0
    return x


def horner381_plain(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`horner381`: the chain of :func:`padd` and
    ``field381.canonical``."""
    acc = identity(1, w.device)
    for i in range(WINDOWS):
        for _ in range(4):
            acc = padd381_xx_plain(acc, acc)
        j = WINDOWS - 1 - i
        acc = padd381_xx_plain(acc, w[:, j : j + 1])
    return acc, F.canonical(acc[:, 0].reshape(COORDS, L))


def horner381(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """sum_j 16^j S_j of packed window sums w [99, 64] -> (raw [99, 1],
    canonical [3, 33]).

    The Horner chain of the MSM: from the identity, for window 63 down to
    0, four doublings padd(acc, acc) and one addition padd(acc, S_j), in
    the operand order of the JAX ``horner_combine``. The raw accumulator
    is what the MSM returns as limbs; the canonical X, Y, Z limbs
    (``field381.canonical``) are what the host reads."""
    cuda_group.check_operand(w, ROWS, "w")
    if w.shape[1] != WINDOWS:
        raise ValueError(f"w: expected [{ROWS}, {WINDOWS}], got {tuple(w.shape)}")
    if w.device.type == "cpu":
        return horner381_plain(w)
    raw = torch.empty((ROWS, 1), dtype=torch.int32, device=w.device)
    canon = torch.empty((COORDS, L), dtype=torch.int32, device=w.device)
    cuda_group.launch("dr_horner381", w.device, w.data_ptr(), w.stride(0), raw.data_ptr(),
                      canon.data_ptr(), handle=lib())
    cuda_group.count(LAUNCHES, "horner381")
    return raw, canon
