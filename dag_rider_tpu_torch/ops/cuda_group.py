"""Edwards group kernels on the H100 — wrappers and their plain versions.

Replaces ``dag_rider_tpu/ops/pallas_group.py``: ``_padd_xx_kernel``
(:func:`padd_xx`, and the six levels of the comb tree in one
:func:`tree_sum_xyzt`), ``_finish_kernel`` (:func:`finish_check`) and
``_pow22523_kernel`` (:func:`pow22523`). The kernels are CUDA C++ for
sm_90a in ``csrc/ed25519_group.cu``. They are bound by integer
multiply-adds (a point addition is 9 schoolbook 22x22 products; the finish
tail ~290). ``padd_xx`` and the tree give each point addition a quad of
four threads, thread r computing row r of the two row-stacked products of
``comb.padd_cached`` with the rows exchanged by shuffles: four times the
threads of one thread a lane, a quarter of its dependent chain, at most
128 registers a thread. ``padd_xx`` stages a lane's limb-major [88, N]
columns through the quad's shared memory, so device memory sees one read
of each operand and one write of the result; the tree sums each group's
64 entries in shared memory. The finish tail and the square-root chain
give each signature (each lane of ``pow22523``) a half-warp of 16 lanes:
lane l holds limbs 2l and 2l + 1, and every product, carry and fold is
split across the half-warp.

:func:`key_tables` and :func:`key_tables8` build the comb key tables in
two launches (the JAX package's ``comb.build_key_tables`` and
``build_key_tables8`` are jnp scans, no ``pallas_call``; the port ran them
as ~130,000 eager torch ops and 960 ``padd_xx`` launches a build): the
window bases, a quad a key down its serial chain of doublings, which
bounds the build; then every entry, a quad a (key, window) chain of
additions or a quad an item of an 8-bit window's levels, written straight
into the gather's flat rows.

Each wrapper takes its plain torch version for a CPU tensor and launches
its kernel for a CUDA tensor; there is no other path. ``LAUNCHES`` counts
kernel launches per wrapper, ``TABLE_LAUNCHES`` those of the table builds.
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
#: kernel launches of the comb table builds (a build launches
#: :data:`TABLE_KERNELS` kernels), kept apart from :data:`LAUNCHES`: a
#: build runs once per verifier, before the dispatches those count
TABLE_LAUNCHES = {"key_tables": 0, "key_tables8": 0}
TABLE_KERNELS = 2  # key_bases_kernel, then the entries kernel

_P, _N = ctypes.c_void_p, ctypes.c_longlong
_SIGNATURES = {
    "dr_padd_xx": [_P, _N, _P, _N, _P, _N, _N, _P],
    "dr_tree_sum_xyzt": [_P, _P, _N, ctypes.c_int, _P],
    "dr_finish_check": [_P, _P, _P, _P, _N, _P],
    "dr_pow22523": [_P, _P, _N, _P],
    "dr_field_mul": [_P, _P, _P, _N, _P],
    "dr_key_tables": [_P, _P, _P, _P, _P, _N, _P],
    "dr_key_tables8": [_P, _P, _P, _P, _P, _N, _P],
}


def reset_launches() -> None:
    for counts in (LAUNCHES, TABLE_LAUNCHES):
        for k in counts:
            counts[k] = 0


_launch_lock = threading.Lock()


def count(launches: dict, name: str, k: int = 1) -> None:
    """Book ``k`` launches of ``name`` in a wrapper module's ``launches``,
    under one lock for all of them: the nodes of one process launch from
    their own pump threads."""
    with _launch_lock:
        launches[name] += k


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


# ---------------------------------------------------------------------------
# comb key tables
# ---------------------------------------------------------------------------


def _check_keys(a_x: torch.Tensor, a_y: torch.Tensor, a_t: torch.Tensor) -> int:
    n = a_x.shape[0] if a_x.dim() == 2 else -1
    for t, name in ((a_x, "a_x"), (a_y, "a_y"), (a_t, "a_t")):
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: expected int32, got {t.dtype}")
        if t.dim() != 2 or t.shape != (n, L) or n < 1:
            raise ValueError(f"{name}: expected shape [n >= 1, {L}] for every key "
                             f"array, got {tuple(t.shape)}")
        if t.device != a_x.device or t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{name}: the key arrays must share one cpu or cuda "
                             f"device, got {t.device}")
    return n


def _key_tables(fn_name: str, name: str, windows: int, entries: int, plain,
                a_x: torch.Tensor, a_y: torch.Tensor, a_t: torch.Tensor) -> torch.Tensor:
    n = _check_keys(a_x, a_y, a_t)
    if a_x.device.type == "cpu":
        return plain(a_x, a_y, a_t).reshape(-1, ROWS)
    a_x, a_y, a_t = a_x.contiguous(), a_y.contiguous(), a_t.contiguous()
    bases = torch.empty((n, windows, ROWS), dtype=torch.int32, device=a_x.device)
    out = torch.empty((n * windows * entries, ROWS), dtype=torch.int32, device=a_x.device)
    launch(fn_name, a_x.device, a_x.data_ptr(), a_y.data_ptr(), a_t.data_ptr(),
           bases.data_ptr(), out.data_ptr(), n)
    count(TABLE_LAUNCHES, name, TABLE_KERNELS)
    return out


def key_tables(a_x: torch.Tensor, a_y: torch.Tensor, a_t: torch.Tensor) -> torch.Tensor:
    """The 4-bit comb tables of n keys (affine x, y, t = xy as int32 [n, 22]
    limbs) as the gather's flat rows [n * 64 * 16, 88]: row (key * 64 + w)
    * 16 + d holds d * 16^w * A_key, packed XYZT.

    On the card: two launches, the 63 x 4 doublings of every key's window
    bases, then the 15 additions of every (key, window). Plain version:
    :func:`comb.build_key_tables_plain`."""
    return _key_tables("dr_key_tables", "key_tables", comb.WINDOWS, comb.ENTRIES,
                       comb.build_key_tables_plain, a_x, a_y, a_t)


def key_tables8(a_x: torch.Tensor, a_y: torch.Tensor, a_t: torch.Tensor) -> torch.Tensor:
    """The 8-bit comb tables as flat rows [n * 32 * 256, 88]: row (key * 32
    + w) * 256 + DIGIT_POS8[d] holds d * 256^w * A_key.

    On the card: two launches, the 31 x 8 doublings of every key's window
    bases, then every window's 7 levels of doublings and additions. Plain
    version: :func:`comb.build_key_tables8_plain`."""
    return _key_tables("dr_key_tables8", "key_tables8", comb.WINDOWS8, comb.ENTRIES8,
                       comb.build_key_tables8_plain, a_x, a_y, a_t)
