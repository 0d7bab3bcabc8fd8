"""Device multi-pairing Miller product — the ``pair="device"`` lane of the
certificate verifier.

Torch twin of ``dag_rider_tpu/ops/bls_pairing.py``. The certificate
aggregate check is one product check
``e(agg, -g2) * prod_i e(H(d_i), pk_i) == 1``. The host replays per-key
precomputed line coefficients over the fixed 63-bit Miller schedule
(``crypto/bls12381.multi_pairing_check``); this module runs the replay on
the card as batched Fp12 limb arithmetic over :mod:`field381`, and only
the final exponentiation stays on the host.

Three choices keep the launches few without changing a result:

- **One Fp12 product is one** ``field381.mul`` **call.** Its 72 field
  products (3 Fp6 products of 6 Fp2 products of 4) are independent once
  their operand sums are formed, so they are stacked on one axis; the
  adds and subtractions of each level are stacked the same way and carried
  in one call. Every limb op is elementwise, so each output limb equals
  the JAX twin's (``_fp12_mul_packed``), which the tests check.
- **The cross-pair product is a tree**, ceil(log2 n) batched levels over
  the ``[steps, n, 12, 33]`` line evaluations instead of a chain of n - 1
  products. Every limb op is exact mod p, so the product is the same Fp12
  element under any association and ``canonical`` gives the same limbs:
  compare after ``canonical``, never before.
- **Only the addition steps are evaluated.** The schedule has 5 addition
  steps among 63; the JAX twin evaluates (and multiplies) all 63 and
  ignores 58 of them.

The schedule walk (63 squarings, 63 doubling-line products and the 5
addition-line products) stays serial. On a CUDA device it is captured
once in a CUDA graph, with ``canonical``, and replayed for every check:
the walk's shapes do not depend on the pair count.

The only host route is a vertical line in a precomputed schedule, which an
r-order G2 point never reaches: such a check runs on the host oracle, and
:data:`HOST_ROUTED` counts it.
"""

from __future__ import annotations

import functools
import threading
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from dag_rider_tpu_torch.crypto import bls12381 as bls
from dag_rider_tpu_torch.ops import field381 as f

#: schedule length (63 bits below the leading one of |x|)
_N_STEPS = len(bls._X_BITS)
#: the schedule steps that also take an addition line
ADD_STEPS = tuple(s for s, bit in enumerate(bls._X_BITS) if bit == "1")

P_INT = f.P_INT
L = f.LIMBS

#: fp12 one as packed limbs [12, LIMBS]
_ONE_PACKED = np.zeros((12, L), dtype=np.int32)
_ONE_PACKED[0] = f.ONE


@functools.lru_cache(maxsize=None)
def _one(device: torch.device) -> torch.Tensor:
    """Fp12 one on ``device``, made once per device. Read-only."""
    return torch.as_tensor(_ONE_PACKED, device=device)


#: field products per ``field381.mul`` call: bounds the transient memory
#: of its schoolbook columns (~27 KB a row) to under 1 GB
MUL_ROWS = 1 << 15

#: product checks routed to the host oracle (a vertical schedule slot),
#: since :func:`reset_host_routed`
HOST_ROUTED: Dict[str, int] = {"checks": 0}


def reset_host_routed() -> None:
    HOST_ROUTED["checks"] = 0


def _fp12_flat(x) -> List[int]:
    """Host fp12 tuple -> 12 coefficient ints, (a0 a1 a2 b0 b1 b2) each
    (re, im) — the packed coefficient order used on the device."""
    (a0, a1, a2), (b0, b1, b2) = x
    return [
        a0[0], a0[1], a1[0], a1[1], a2[0], a2[1],
        b0[0], b0[1], b1[0], b1[1], b2[0], b2[1],
    ]


def _fp12_unflat(c: Sequence[int]):
    return (
        ((c[0], c[1]), (c[2], c[3]), (c[4], c[5])),
        ((c[6], c[7]), (c[8], c[9]), (c[10], c[11])),
    )


# --- batched tower arithmetic ----------------------------------------------
# Fp2 is [..., 2, L] (re, im), Fp6 [..., 3, 2, L], Fp12 [..., 2, 3, 2, L];
# a packed Fp12 [..., 12, L] reshapes to the last without a copy.


def mul_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``field381.mul`` over broadcast operands, at most :data:`MUL_ROWS`
    products a call (row-wise, so the limbs are those of one call)."""
    a, b = torch.broadcast_tensors(a, b)
    shape = a.shape
    a, b = a.reshape(-1, L), b.reshape(-1, L)
    if a.shape[0] <= MUL_ROWS:
        return f.mul(a, b).reshape(shape)
    out = torch.cat([f.mul(a[i:i + MUL_ROWS], b[i:i + MUL_ROWS])
                     for i in range(0, a.shape[0], MUL_ROWS)])
    return out.reshape(shape)


def _xi_raw(x: torch.Tensor) -> torch.Tensor:
    """x * (1 + u) before its carry: (a - b) + (a + b) u."""
    a, b = x[..., 0, :], x[..., 1, :]
    return torch.stack([a - b, a + b], dim=-2)


def fp2_mul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(a + b u)(c + d u) = (ac - bd) + (ad + bc) u: four products in one
    ``mul`` call, one carry for both halves."""
    a, b = x[..., 0, :], x[..., 1, :]
    c, d = y[..., 0, :], y[..., 1, :]
    t = mul_rows(torch.stack([a, b, a, b], dim=-2), torch.stack([c, d, d, c], dim=-2))
    raw = torch.stack([t[..., 0, :] - t[..., 1, :], t[..., 2, :] + t[..., 3, :]], dim=-2)
    return f.carry(raw, steps=2)


def fp6_mul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The JAX twin's ``_fp6_mul`` (Karatsuba over Fp2) with its six Fp2
    products in one ``fp2_mul`` and each level of sums in one carry."""
    x0, x1, x2 = x[..., 0, :, :], x[..., 1, :, :], x[..., 2, :, :]
    y0, y1, y2 = y[..., 0, :, :], y[..., 1, :, :], y[..., 2, :, :]
    sums = f.carry(torch.stack([x1 + x2, x0 + x1, x0 + x2,
                                y1 + y2, y0 + y1, y0 + y2], dim=-3), steps=2)
    xs = torch.cat([x, sums[..., :3, :, :]], dim=-3)
    ys = torch.cat([y, sums[..., 3:, :, :]], dim=-3)
    t = fp2_mul(xs, ys)  # t0 t1 t2 m12 m01 m02
    t0, t1, t2 = t[..., 0, :, :], t[..., 1, :, :], t[..., 2, :, :]
    m12, m01, m02 = t[..., 3, :, :], t[..., 4, :, :], t[..., 5, :, :]
    s = f.carry(torch.stack([t1 + t2, t0 + t1, t0 + t2, _xi_raw(t2)], dim=-3), steps=2)
    d = f.carry(torch.stack([m12 - s[..., 0, :, :], m01 - s[..., 1, :, :],
                             m02 - s[..., 2, :, :]], dim=-3), steps=2)
    e = f.carry(torch.stack([_xi_raw(d[..., 0, :, :]),
                             d[..., 1, :, :] + s[..., 3, :, :],
                             d[..., 2, :, :] + t1], dim=-3), steps=2)
    c0 = f.carry(t0 + e[..., 0, :, :], steps=2)
    return torch.stack([c0, e[..., 1, :, :], e[..., 2, :, :]], dim=-3)


def fp12_mul(xa: torch.Tensor, ya: torch.Tensor) -> torch.Tensor:
    """Packed Fp12 product [..., 12, L] x [..., 12, L], limb for limb the
    JAX twin's ``_fp12_mul_packed``: its three Fp6 products (so all 72
    field products) in one ``field381.mul`` call."""
    xa, ya = torch.broadcast_tensors(xa, ya)
    shape = xa.shape
    x = xa.reshape(*shape[:-2], 2, 3, 2, L)
    y = ya.reshape(*shape[:-2], 2, 3, 2, L)
    a0, a1, b0, b1 = x[..., 0, :, :, :], x[..., 1, :, :, :], y[..., 0, :, :, :], y[..., 1, :, :, :]
    sums = f.carry(torch.stack([a0 + a1, b0 + b1], dim=-4), steps=2)
    xs = torch.stack([a0, a1, sums[..., 0, :, :, :]], dim=-4)
    ys = torch.stack([b0, b1, sums[..., 1, :, :, :]], dim=-4)
    t = fp6_mul(xs, ys)
    t0, t1, m = t[..., 0, :, :, :], t[..., 1, :, :, :], t[..., 2, :, :, :]
    # t1 * v = (xi(t1[2]), t1[0], t1[1]) and t0 + t1, one carry
    u = f.carry(torch.cat([_xi_raw(t1[..., 2, :, :])[..., None, :, :], t0 + t1], dim=-3),
                steps=2)
    v_t1 = torch.stack([u[..., 0, :, :], t1[..., 0, :, :], t1[..., 1, :, :]], dim=-3)
    out = f.carry(torch.stack([t0 + v_t1, m - u[..., 1:, :, :]], dim=-4), steps=2)
    return out.reshape(shape)


def eval_lines(lam: torch.Tensor, c: torch.Tensor, xp: torch.Tensor,
               yp: torch.Tensor) -> torch.Tensor:
    """The precomputed lines at (xp, yp): (c - lam*xp) + yp at coefficient
    a0.re — the JAX twin's ``_eval_lines``, for every step and pair at once.
    lam, c: [steps, n, 12, L]; xp, yp: [n, L]."""
    ell = f.sub(c, mul_rows(lam, xp[None, :, None, :]))
    ell0 = f.add(ell[..., 0, :], yp[None])
    return torch.cat([ell0[..., None, :], ell[..., 1:, :]], dim=-2)


def tree_product(evals: torch.Tensor) -> torch.Tensor:
    """Product over axis 1 of [steps, n, 12, L] in ceil(log2 n) batched
    levels -> [steps, 12, L] (an odd element rides up a level unmultiplied)."""
    while evals.shape[1] > 1:
        half = evals.shape[1] // 2
        prod = fp12_mul(evals[:, 0:2 * half:2], evals[:, 1:2 * half:2])
        evals = torch.cat([prod, evals[:, 2 * half:]], dim=1)
    return evals[:, 0]


def walk(dprod: torch.Tensor, aprod: torch.Tensor) -> torch.Tensor:
    """The schedule walk on the [12, L] accumulator, then ``canonical``:
    dprod [63, 12, L] the doubling-line products, aprod [5, 12, L] the
    addition-line products of :data:`ADD_STEPS`."""
    acc = _one(dprod.device)
    k = 0
    for s, bit in enumerate(bls._X_BITS):
        acc = fp12_mul(acc, acc)
        acc = fp12_mul(acc, dprod[s])
        if bit == "1":
            acc = fp12_mul(acc, aprod[k])
            k += 1
    return f.canonical(acc)


class _WalkGraph:
    """:func:`walk` captured once in a CUDA graph on one device, replayed
    with the products copied into its static inputs."""

    def __init__(self, device: torch.device) -> None:
        self.dprod = torch.zeros((_N_STEPS, 12, L), dtype=torch.int32, device=device)
        self.aprod = torch.zeros((len(ADD_STEPS), 12, L), dtype=torch.int32, device=device)
        # the eager run before capture makes every limb constant on the
        # device (a host-to-device copy cannot be captured)
        walk(self.dprod, self.aprod)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            walk(self.dprod, self.aprod)
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = walk(self.dprod, self.aprod)

    def __call__(self, dprod: torch.Tensor, aprod: torch.Tensor) -> torch.Tensor:
        self.dprod.copy_(dprod)
        self.aprod.copy_(aprod)
        self.graph.replay()
        return self.out.clone()


_GRAPHS: Dict[torch.device, _WalkGraph] = {}
_GRAPHS_LOCK = threading.Lock()


def walk_on_device(dprod: torch.Tensor, aprod: torch.Tensor) -> torch.Tensor:
    """:func:`walk`, replayed from a CUDA graph on a CUDA device (the same
    kernels in the same order, so the same limbs), eager elsewhere."""
    if dprod.device.type != "cuda":
        return walk(dprod, aprod)
    with _GRAPHS_LOCK:
        g = _GRAPHS.get(dprod.device)
        if g is None:
            g = _GRAPHS[dprod.device] = _WalkGraph(dprod.device)
        return g(dprod, aprod)


# --- host-side schedule marshalling ----------------------------------------

#: q -> (dbl_lam, dbl_c [63, 12, L], add_lam, add_c [5, 12, L]) numpy limbs
_SLOT_CACHE: dict = {}
_SLOT_CACHE_MAX = 1024


def _slot_limbs(q):
    """Per-step line-coefficient limb arrays for G2 point q: the doubling
    lines at every step, the addition lines at :data:`ADD_STEPS` only.
    A vertical slot (never hit by r-order points) returns None and the
    caller routes the check to the host oracle."""
    hit = _SLOT_CACHE.get(q)
    if hit is not None:
        return hit
    coeffs = bls.g2_precompute(q)
    if any(lam is None for lam, _ in coeffs):
        return None
    dbl_lam, dbl_c, add_lam, add_c = [], [], [], []
    idx = 0
    for bit in bls._X_BITS:
        lam, c = coeffs[idx]
        idx += 1
        dbl_lam.append(_fp12_flat(lam))
        dbl_c.append(_fp12_flat(c))
        if bit == "1":
            lam, c = coeffs[idx]
            idx += 1
            add_lam.append(_fp12_flat(lam))
            add_c.append(_fp12_flat(c))
    out = tuple(
        f.to_limbs_bulk([v for step in arr for v in step]).reshape(len(arr), 12, L)
        for arr in (dbl_lam, dbl_c, add_lam, add_c)
    )
    if len(_SLOT_CACHE) >= _SLOT_CACHE_MAX:
        _SLOT_CACHE.clear()
    _SLOT_CACHE[q] = out
    return out


def marshal(pairs: Sequence[Tuple[object, object]]):
    """The host half of a check: ``(xp, yp, slots)`` numpy limbs, xp/yp
    [n, L] and slots the four stacked coefficient arrays [steps, n, 12, L];
    None when a pair hits a vertical slot; ``(None, None, None)`` when
    every pair holds the identity."""
    evs = []
    for p, q in pairs:
        if p is None or q is None:
            continue  # an identity factor contributes 1
        slots = _slot_limbs(q)
        if slots is None:
            return None
        evs.append((p[0] % P_INT, p[1] % P_INT, slots))
    if not evs:
        return None, None, None
    xp = f.to_limbs_bulk([e[0] for e in evs])
    yp = f.to_limbs_bulk([e[1] for e in evs])
    slots = [np.stack([e[2][k] for e in evs], axis=1) for k in range(4)]
    return xp, yp, slots


def line_products(xp, yp, slots, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Line evaluations for every step and pair, then the cross-pair
    tree: (dprod [63, 12, L], aprod [5, 12, L]) on ``device``."""
    xp_d, yp_d = (torch.from_numpy(a).to(device) for a in (xp, yp))
    dl, dc, al, ac = (torch.from_numpy(a).to(device) for a in slots)
    evals = torch.cat([eval_lines(dl, dc, xp_d, yp_d), eval_lines(al, ac, xp_d, yp_d)])
    prod = tree_product(evals)
    return prod[:_N_STEPS], prod[_N_STEPS:]


def to_host_fp12(limbs: torch.Tensor):
    """Canonical [12, L] limbs -> the host fp12 tuple, conjugated for the
    negative x exactly like the host oracle."""
    out = limbs.cpu().numpy()
    res = _fp12_unflat([f.from_limbs(out[j]) for j in range(12)])
    if bls.X_PARAM < 0:
        res = bls.fp12_conj(res)
    return res


def miller_product(pairs: Sequence[Tuple[object, object]], device):
    """The Miller-loop product of (G1, G2) pairs as a host fp12 tuple
    (conjugated for the negative x, as the host oracle does) — feed to
    ``bls.final_exponentiation``. None-containing pairs contribute 1;
    returns None when a pair hits a vertical schedule slot."""
    host = marshal(pairs)
    if host is None:
        return None
    xp, yp, slots = host
    if xp is None:
        return bls.FP12_ONE
    device = torch.device(device)
    dprod, aprod = line_products(xp, yp, slots, device)
    return to_host_fp12(walk_on_device(dprod, aprod))


def host_miller_product(pairs: Sequence[Tuple[object, object]]):
    """The host oracle's Miller product (the loop of
    ``bls.multi_pairing_check`` stopped before the final exponentiation),
    conjugated like :func:`miller_product`."""
    evs = [(p[0] % P_INT, p[1] % P_INT, bls.g2_precompute(q))
           for p, q in pairs if p is not None and q is not None]
    acc = bls.FP12_ONE
    idx = 0
    for bit in bls._X_BITS:
        acc = bls.fp12_sqr(acc)
        for xp, yp, coeffs in evs:
            lam, c = coeffs[idx]
            acc = bls.fp12_mul(acc, bls._line_eval(lam, c, xp, yp))
        idx += 1
        if bit == "1":
            for xp, yp, coeffs in evs:
                lam, c = coeffs[idx]
                acc = bls.fp12_mul(acc, bls._line_eval(lam, c, xp, yp))
            idx += 1
    if bls.X_PARAM < 0:
        acc = bls.fp12_conj(acc)
    return acc


def multi_pairing_check(pairs: Sequence[Tuple[object, object]], device) -> bool:
    """Device twin of ``bls.multi_pairing_check``: the same verdicts (the
    Miller product is the same element, so is its final exponentiation)."""
    fm = miller_product(pairs, device)
    if fm is None:
        HOST_ROUTED["checks"] += 1
        return bls.multi_pairing_check(pairs)
    return bls.final_exponentiation(fm) == bls.FP12_ONE
