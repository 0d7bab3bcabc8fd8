"""The windowed verify (``comb=False``) on the card — the kernels composed.

The JAX package runs its windowed path (``dag_rider_tpu/ops/curve.py``
``verify_core``: R decompression, [s]B from the fixed-base table, [k]A by
4-bit windows) as one jnp program with no Pallas kernel; it is the
verifier's differential oracle. Here, on a CPU tensor, :func:`verify` is
``curve.verify_core`` itself, limb for limb the JAX twin. On a CUDA tensor
it runs the same equation through the repo's kernels, as
``comb.build_key_tables`` does for its table steps:

- every addition is ``cuda_group.padd_xx`` — ``padd_cached(p, to_cached(q))``,
  the same complete add-2008-hwcd-3 group law as ``curve.padd``: the 15
  table steps of [k]A, one addition a window for [k]A and [s]B together
  (both walks in one launch of 2B lanes), and R + [k]A;
- R's square-root chain is the ``pow22523`` kernel;
- the doublings (``comb.pdouble_packed``) and the final projective
  comparison stay plain torch, as they are plain jnp in the JAX package.

The walk is 64 steps of four doublings and one addition. Eagerly that is
~2,000 small torch ops a step, so the host's issue rate sets its pace; by
default one step is captured in a CUDA graph per (device, rows, stream)
and replayed 64 times, as ``bls_g1``'s ladder step is. The limbs differ
from the twin's (``padd_xx`` caches its second operand, the doublings are
packed), the values and so the accept mask do not: the comparison is
``curve.points_equal``, after ``canonical``.

Launch counting: ``cuda_group.LAUNCHES`` counts each kernel launch. The
capture of a step launches nothing, so its count is taken back; each
replay launches the captured ``padd_xx`` once and counts it here. One
dispatch launches ``padd_xx`` 15 + 64 + 1 = 80 times and ``pow22523``
once (plus one ``padd_xx`` for the first step of a new graph, run eagerly
before its capture).
"""

from __future__ import annotations

import functools
import threading
from typing import Dict, Tuple

import torch

from dag_rider_tpu_torch.ops import comb, cuda_group as CG, curve, field as F

WINDOWS = curve.WINDOWS
ROWS = CG.ROWS  # 88 = 4 coordinates x 22 limbs


def _pow22523_kernel(z: torch.Tensor) -> torch.Tensor:
    """``field.pow22523`` on [..., 22] limbs through the kernel (limb-major)."""
    return CG.pow22523(z.reshape(-1, F.LIMBS).t().contiguous()).t().reshape(z.shape)


@functools.lru_cache(maxsize=None)
def _base_rows(device: torch.device) -> torch.Tensor:
    """The fixed-base table for B as gather rows [64 * 16, 88] on ``device``."""
    return torch.as_tensor(comb.base_table_xyzt(), device=device).reshape(-1, ROWS)


def _lm(p: curve.Point) -> torch.Tensor:
    """(X, Y, Z, T) [B, 22] -> limb-major packed [88, B]."""
    return comb.to_limb_major(comb.pack_point(p))


def step(acc: torch.Tensor, operand: torch.Tensor) -> torch.Tensor:
    """One window of both walks over limb-major [88, 2B]: lanes [0, B) hold
    [k]A (four doublings, then the window's table entry), lanes [B, 2B)
    hold [s]B (the window's base-table entry only); one ``padd_xx`` adds
    ``operand`` to both halves."""
    b = acc.shape[1] // 2
    v = comb.from_limb_major(acc[:, :b])
    for _ in range(4):
        v = comb.pdouble_packed(v)
    return CG.padd_xx(torch.cat([comb.to_limb_major(v), acc[:, b:]], dim=1), operand)


class _StepGraph:
    """:func:`step` captured once in a CUDA graph for one width on one
    device and stream; each replay adds ``self.operand`` into ``self.acc``
    in place."""

    def __init__(self, lanes: int, device: torch.device) -> None:
        self.acc = torch.zeros((ROWS, lanes), dtype=torch.int32, device=device)
        self.operand = torch.zeros_like(self.acc)
        cur = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            step(self.acc, self.operand)  # warm the allocator before the capture
        cur.wait_stream(side)
        counted = dict(CG.LAUNCHES)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.acc.copy_(step(self.acc, self.operand))
        CG.LAUNCHES.update(counted)  # the capture launched nothing

    def walk(self, acc0: torch.Tensor, operands: torch.Tensor) -> torch.Tensor:
        self.acc.copy_(acc0)
        for i in range(operands.shape[0]):
            self.operand.copy_(operands[i])
            self.graph.replay()
            CG.count(CG.LAUNCHES, "padd_xx")  # the replayed step's one padd_xx launch
        return self.acc.clone()


_GRAPHS: Dict[Tuple[torch.device, int, int], _StepGraph] = {}
_GRAPHS_LOCK = threading.Lock()


def walk(acc0: torch.Tensor, operands: torch.Tensor, graph: bool = True) -> torch.Tensor:
    """The 64 window steps from ``acc0`` [88, 2B] over ``operands``
    [64, 88, 2B] (step i's entries); on a CUDA device replayed from the
    step graph unless ``graph`` is False."""
    if not graph or acc0.device.type != "cuda":
        acc = acc0
        for i in range(operands.shape[0]):
            acc = step(acc, operands[i])
        return acc
    dev = acc0.device
    key = (dev, acc0.shape[1], torch.cuda.current_stream(dev).stream_id)
    with _GRAPHS_LOCK:  # one caller at a time on a graph's static buffers
        g = _GRAPHS.get(key)
        if g is None:
            g = _GRAPHS[key] = _StepGraph(acc0.shape[1], dev)
        return g.walk(acc0, operands)


def verify(
    s_nibbles: torch.Tensor,
    k_nibbles: torch.Tensor,
    a_point: curve.Point,
    a_valid: torch.Tensor,
    r_y: torch.Tensor,
    r_sign: torch.Tensor,
    prevalid: torch.Tensor,
    graph: bool = True,
) -> torch.Tensor:
    """Batched [s]B == R + [k]A on the windowed path -> bool [B].

    s_nibbles/k_nibbles: integer [B, 64] little-endian digits; a_point:
    (X, Y, Z, T) [B, 22]; r_y [B, 22] and r_sign [B] int32; a_valid and
    prevalid bool [B]. A CPU tensor takes ``curve.verify_core``; a CUDA
    tensor the kernels (``graph``: the walk replayed from its step graph)."""
    if s_nibbles.device.type == "cpu":
        return curve.verify_core(s_nibbles, k_nibbles, a_point, a_valid, r_y, r_sign, prevalid)
    return composed(s_nibbles, k_nibbles, a_point, a_valid, r_y, r_sign, prevalid, graph)


def composed(
    s_nibbles: torch.Tensor,
    k_nibbles: torch.Tensor,
    a_point: curve.Point,
    a_valid: torch.Tensor,
    r_y: torch.Tensor,
    r_sign: torch.Tensor,
    prevalid: torch.Tensor,
    graph: bool = True,
) -> torch.Tensor:
    """The card program of :func:`verify`. On CPU tensors the kernel
    wrappers take their plain versions, so the tests run this composition
    (its gathers, lane halves and walk order) against ``curve.verify_core``."""
    dev = s_nibbles.device
    b = s_nibbles.shape[0]
    r_point, r_valid = curve.decompress(r_y, r_sign, pow22523=_pow22523_kernel)
    # [k]A's window table: T[d] = d * A, 15 additions over B lanes
    ident = _lm(curve.identity((b,), dev))
    a_lm = _lm(a_point).contiguous()
    entries = [ident]
    for _ in range(15):
        entries.append(CG.padd_xx(entries[-1], a_lm))
    table = torch.stack(entries)  # [16, 88, B]
    # step i adds [k]A's window 63 - i and [s]B's window i
    k_idx = k_nibbles.long().flip(-1).t()  # [64, B]
    var = torch.gather(table, 0, k_idx[:, None, :].expand(WINDOWS, ROWS, b))
    wins = torch.arange(WINDOWS, device=dev)
    base = _base_rows(dev)[wins * 16 + s_nibbles.long()].permute(1, 2, 0)  # [64, 88, B]
    operands = torch.cat([var, base], dim=2).contiguous()  # [64, 88, 2B]
    acc = walk(torch.cat([ident, ident], dim=1), operands, graph)
    ka, lhs = acc[:, :b], acc[:, b:]
    rhs = CG.padd_xx(_lm(r_point).contiguous(), ka.contiguous())
    unpack = comb.unpack_point
    ok = curve.points_equal(unpack(comb.from_limb_major(lhs)), unpack(comb.from_limb_major(rhs)))
    return ok & a_valid & r_valid & prevalid
