"""Edwards group kernels on the H100 — wrappers and their plain versions.

Replaces ``dag_rider_tpu/ops/pallas_group.py``: ``_padd_xx_kernel``
(:func:`padd_xx`, and the six levels of the comb tree in one
:func:`tree_sum_xyzt`), ``_finish_kernel`` (:func:`finish_check`) and
``_pow22523_kernel`` (:func:`pow22523`). The kernels are CUDA C++ for
sm_90a in ``csrc/ed25519_group.cu``. They are bound by integer
multiply-adds (a point addition is 9 schoolbook 22x22 products; the finish
tail ~290). ``padd_xx`` takes one thread per lane over limb-major [rows, N]
int32 operands and keeps every limb in registers, so device memory sees
one read of each operand and one write of the result. The tree kernel sums
each group's 64 entries in shared memory, four threads per addition. The
finish tail and the square-root chain give each signature (each lane of
``pow22523``) a half-warp of 16 lanes: lane l holds limbs 2l and 2l + 1,
and every product, carry and fold is split across the half-warp.

Each wrapper takes its plain torch version for a CPU tensor and launches
its kernel for a CUDA tensor; there is no other path. ``LAUNCHES`` counts
kernel launches per wrapper.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading

import torch

from dag_rider_tpu_torch.ops import comb, curve, field as F
from dag_rider_tpu_torch.utils import build

L = F.LIMBS  # 22
ROWS = 4 * L  # 88
TREE_MAX_M = 64  # entries per group the tree kernel holds in shared memory
SOURCE = "dag_rider_tpu_torch/csrc/ed25519_group.cu"

#: kernel launches per wrapper since the last :func:`reset_launches`
LAUNCHES = {"padd_xx": 0, "tree_sum_xyzt": 0, "finish_check": 0, "pow22523": 0}

_P, _N = ctypes.c_void_p, ctypes.c_longlong
_SIGNATURES = {
    "dr_padd_xx": [_P, _N, _P, _N, _P, _N, _N, _P],
    "dr_tree_sum_xyzt": [_P, _P, _N, ctypes.c_int, _P],
    "dr_finish_check": [_P, _P, _P, _P, _N, _P],
    "dr_pow22523": [_P, _P, _N, _P],
    "dr_field_mul": [_P, _P, _P, _N, _P],
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_launch_lock = threading.Lock()


def count(launches: dict, name: str) -> None:
    """Book one launch of ``name`` in a wrapper module's ``launches``, under
    one lock for all of them: the nodes of one process launch from their
    own pump threads."""
    with _launch_lock:
        launches[name] += 1


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    """The built ``ed25519_group`` library with its C signatures declared
    (built and loaded on the first launch)."""
    handle = build.library("ed25519_group")
    for name, args in _SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return handle


def check_operand(t: torch.Tensor, rows: int, name: str) -> None:
    """Kernel operands: int32 [rows, N] with contiguous lanes (any lane
    stride when N == 1)."""
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32, got {t.dtype}")
    if t.dim() != 2 or t.shape[0] != rows:
        raise ValueError(f"{name}: expected shape [{rows}, N], got {tuple(t.shape)}")
    if t.shape[1] > 1 and t.stride(1) != 1:
        raise ValueError(f"{name}: lanes must be contiguous (stride(1) == 1)")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")


def launch(fn_name: str, device: torch.device, *args, handle=None) -> None:
    """Call a C entry point of ``handle`` (default: this module's library)
    on ``device``'s current stream; raise on a launch error."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(handle or lib(), fn_name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name}: CUDA launch failed with error {rc}")


# ---------------------------------------------------------------------------
# padd_xx / tree_sum_xyzt
# ---------------------------------------------------------------------------


def padd_xx_plain(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Plain version: ``comb.padd_cached(p, comb.to_cached(q))`` on
    limb-major [88, N] operands."""
    out = comb.padd_cached(comb.from_limb_major(p), comb.to_cached(comb.from_limb_major(q)))
    return comb.to_limb_major(out)


def padd_xx(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """p + q for packed XYZT int32 [88, N] operands -> [88, N].

    Operands may be column slices of a wider tensor (only the lanes must
    be contiguous); the output is a fresh contiguous tensor."""
    check_operand(p, ROWS, "p")
    check_operand(q, ROWS, "q")
    if p.shape != q.shape or p.device != q.device:
        raise ValueError("p and q must have one shape and one device")
    if p.device.type == "cpu":
        return padd_xx_plain(p, q)
    n = p.shape[1]
    out = torch.empty((ROWS, n), dtype=torch.int32, device=p.device)
    launch("dr_padd_xx", p.device, p.data_ptr(), p.stride(0), q.data_ptr(),
           q.stride(0), out.data_ptr(), out.stride(0), n)
    count(LAUNCHES, "padd_xx")
    return out


def tree_sum_xyzt(entries: torch.Tensor) -> torch.Tensor:
    """Sum M packed XYZT points per element: [..., M, 4, 22] -> [..., 4, 22].

    One launch for all log2(M) levels: each level adds entry m + M/2^k to
    entry m, the first half to the second, as :func:`comb.tree_sum_packed`
    (its plain version) pairs them. M must be a power of two, at most 64
    on the card. The comb path hands over its gather output
    [B, 2, 64, 4, 22] as it is."""
    *lead, m, four, limbs = entries.shape
    if four != 4 or limbs != L or m < 1 or m & (m - 1):
        raise ValueError(f"expected [..., 2^k, 4, 22], got {tuple(entries.shape)}")
    if entries.dtype != torch.int32:
        raise TypeError(f"entries: expected int32, got {entries.dtype}")
    if entries.device.type == "cpu":
        return comb.tree_sum_packed(entries)
    if m > TREE_MAX_M:
        raise ValueError(f"tree_sum_xyzt: at most {TREE_MAX_M} entries per group, got {m}")
    x = entries.contiguous()
    if x.data_ptr() % 16:  # the kernel reads 16-byte vectors
        x = x.clone()
    groups = math.prod(lead)
    out = torch.empty((*lead, 4, L), dtype=torch.int32, device=x.device)
    launch("dr_tree_sum_xyzt", x.device, x.data_ptr(), out.data_ptr(), groups, m)
    count(LAUNCHES, "tree_sum_xyzt")
    return out


# ---------------------------------------------------------------------------
# finish_check
# ---------------------------------------------------------------------------


def finish_check_plain(
    r_y: torch.Tensor, r_sign: torch.Tensor, acc: torch.Tensor
) -> torch.Tensor:
    """Plain version: ``curve.decompress`` + ``curve.padd`` +
    ``curve.points_equal`` (the jnp tail of ``comb_verify_core``)."""
    lhs = comb.unpack_point(acc[:, 0])  # [s]B
    ka = comb.unpack_point(acc[:, 1])  # [k]A
    r_point, r_valid = curve.decompress(r_y, r_sign)
    return curve.points_equal(lhs, curve.padd(r_point, ka)) & r_valid


def finish_check(
    r_y: torch.Tensor, r_sign: torch.Tensor, acc: torch.Tensor
) -> torch.Tensor:
    """The post-tree tail of comb verification.

    r_y: int32 [B, 22]; r_sign: int32 [B]; acc: int32 [B, 2, 4, 22]
    (axis 1 = ([s]B, [k]A)). Returns bool [B]: R valid and [s]B == R + [k]A.
    """
    b = r_y.shape[0]
    if r_y.shape != (b, L) or r_sign.shape != (b,) or acc.shape != (b, 2, 4, L):
        raise ValueError(
            f"finish_check: shapes {tuple(r_y.shape)}, {tuple(r_sign.shape)}, "
            f"{tuple(acc.shape)}"
        )
    if r_sign.device != r_y.device or acc.device != r_y.device:
        raise ValueError("finish_check: operands on different devices")
    for t, name in ((r_y, "r_y"), (r_sign, "r_sign"), (acc, "acc")):
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: expected int32, got {t.dtype}")
    if r_y.device.type == "cpu":
        return finish_check_plain(r_y, r_sign, acc)
    # the operands as the tree and unpack give them: contiguous rows, no
    # transposed copy
    r_y, r_sign, acc = r_y.contiguous(), r_sign.contiguous(), acc.contiguous()
    out = torch.empty(b, dtype=torch.int32, device=r_y.device)
    launch("dr_finish_check", r_y.device, r_y.data_ptr(), r_sign.data_ptr(),
           acc.data_ptr(), out.data_ptr(), b)
    count(LAUNCHES, "finish_check")
    return out.bool()


# ---------------------------------------------------------------------------
# pow22523
# ---------------------------------------------------------------------------


def pow22523_plain(z: torch.Tensor) -> torch.Tensor:
    """Plain version: ``field.pow22523`` on limb-major [22, N]."""
    return F.pow22523(z.t()).t().contiguous()


def pow22523(z: torch.Tensor) -> torch.Tensor:
    """z^(2^252 - 3) for limb-major int32 [22, N] -> [22, N].

    The verify path runs this chain inside the finish kernel; this entry
    is the chain's unit kernel, on the same cooperative device code."""
    check_operand(z, L, "z")
    if z.device.type == "cpu":
        return pow22523_plain(z)
    z = z.contiguous()
    n = z.shape[1]
    out = torch.empty((L, n), dtype=torch.int32, device=z.device)
    launch("dr_pow22523", z.device, z.data_ptr(), out.data_ptr(), n)
    count(LAUNCHES, "pow22523")
    return out
