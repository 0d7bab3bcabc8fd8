"""Batched G1 hash-map powers and scalar ladders on field381 limbs — the
``device`` lane of ``crypto.bls12381.sign_many``.

Torch twin of ``dag_rider_tpu/ops/bls_g1.py``. SHA hashing stays per row
on the host (``crypto/bls12381._hash_candidate_x``); the two heavy batch
primitives run on int32 limb tensors:

- :func:`pow_p_batch` — shared-exponent powering (the try-and-increment
  square root y2^((p+1)/4) and the affine-conversion inverse z^(p-2));
- :func:`g1_ladder_batch` — left-to-right Jacobian double-and-add over
  all rows at once, transcribing the host oracle's ``_jac_double`` /
  ``_jac_madd`` formulas limb for limb.

Every limb op is exact mod-p arithmetic, so each result equals the
oracle's. ``lax.scan`` becomes a Python loop over the bit columns; the
independent field products of each formula level go in one
``field381.mul`` call (4 calls a doubling, 5 a mixed addition, against 7
and 11 products). The exponent of a power is known on the host, so a
zero bit costs no product. The mixed addition's H == 0 test (the
accumulator meeting +-base mid-ladder, possible only for tiny-order
non-torsion candidates) needs ``canonical``; it moves out of the loop:
each step's H is kept and one batched test at the end raises the per-row
fallback flag, and the caller re-signs such a row on the host.

On a CUDA device the ladder step is captured once in a CUDA graph per
row count and replayed for every bit column; elsewhere it runs eagerly.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dag_rider_tpu_torch.ops import field381 as f

P = f.P_INT


def _mul(pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]]) -> List[torch.Tensor]:
    """The products of ``pairs`` (same shapes) in one ``field381.mul``."""
    a = torch.stack([x for x, _ in pairs])
    b = torch.stack([y for _, y in pairs])
    return list(f.mul(a, b).unbind(0))


def _jac_double(X, Y, Z):
    """EFD dbl-2009-l, the limb transcription of the oracle's _jac_double.
    All-zero (X, Y, Z) — the identity encoding — is a fixed point."""
    A, B, YZ = _mul([(X, X), (Y, Y), (Y, Z)])
    t = f.add(X, B)
    C, tt = _mul([(B, B), (t, t)])
    D = f.mul_small(f.sub(f.sub(tt, A), C), 2)
    E = f.mul_small(A, 3)
    X3 = f.sub(f.mul(E, E), f.mul_small(D, 2))
    Y3 = f.sub(f.mul(E, f.sub(D, X3)), f.mul_small(C, 8))
    Z3 = f.mul_small(YZ, 2)
    return X3, Y3, Z3


def _jac_madd(X, Y, Z, x2, y2):
    """EFD madd-2007-bl main branch; returns H as well, whose zero test is
    the caller's fallback flag."""
    Z1Z1, y2Z = _mul([(Z, Z), (y2, Z)])
    U2, S2 = _mul([(x2, Z1Z1), (y2Z, Z1Z1)])
    H = f.sub(U2, X)
    r = f.mul_small(f.sub(S2, Y), 2)
    t = f.add(Z, H)
    HH, rr, tt = _mul([(H, H), (r, r), (t, t)])
    I = f.mul_small(HH, 4)
    J, V = _mul([(H, I), (X, I)])
    X3 = f.sub(f.sub(rr, J), f.mul_small(V, 2))
    rV, YJ = _mul([(r, f.sub(V, X3)), (Y, J)])
    Y3 = f.sub(rV, f.mul_small(YJ, 2))
    Z3 = f.sub(f.sub(tt, Z1Z1), HH)
    return X3, Y3, Z3, H


def ladder_step(state: torch.Tensor, inf: torch.Tensor, px: torch.Tensor,
                py: torch.Tensor, one: torch.Tensor, bit: torch.Tensor):
    """One bit column of the ladder. state [3, n, L] (X, Y, Z), inf [n]
    bool; returns (state, inf, H [n, L], live [n]) where ``live`` marks the
    rows whose mixed addition counted (bit set, accumulator not the
    identity), the rows the H == 0 flag applies to."""
    X, Y, Z = _jac_double(state[0], state[1], state[2])
    Xm, Ym, Zm, H = _jac_madd(X, Y, Z, px, py)
    take_init = bit & inf
    take_madd = bit & ~inf
    dbl = torch.stack([X, Y, Z])
    madd = torch.stack([Xm, Ym, Zm])
    init = torch.stack([px, py, one])
    state = torch.where(take_init[None, :, None], init,
                        torch.where(take_madd[None, :, None], madd, dbl))
    return state, inf & ~bit, H, take_madd


class _StepGraph:
    """:func:`ladder_step` captured once in a CUDA graph for one row count
    on one device; each replay reads the static inputs and writes the
    static outputs."""

    def __init__(self, n: int, device: torch.device) -> None:
        z = torch.zeros((n, f.LIMBS), dtype=torch.int32, device=device)
        self.state = torch.zeros((3, n, f.LIMBS), dtype=torch.int32, device=device)
        self.inf = torch.ones(n, dtype=torch.bool, device=device)
        self.px, self.py, self.one = z.clone(), z.clone(), z.clone()
        self.bit = torch.zeros(n, dtype=torch.bool, device=device)
        args = (self.state, self.inf, self.px, self.py, self.one, self.bit)
        ladder_step(*args)  # the limb constants reach the device before capture
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            ladder_step(*args)
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = ladder_step(*args)


_GRAPHS: Dict[Tuple[torch.device, int], _StepGraph] = {}
_GRAPHS_LOCK = threading.Lock()


def _pow_bits(exp: int) -> List[int]:
    """Exponent bits below the top one, most significant first."""
    return [exp >> k & 1 for k in range(exp.bit_length() - 2, -1, -1)]


def pow_limbs(base: torch.Tensor, exp: int) -> torch.Tensor:
    """base^exp over limb rows (exp >= 2), not canonicalized: the JAX
    twin's scan with the zero bits' products left out (its select keeps
    the accumulator there)."""
    acc = base
    for b in _pow_bits(exp):
        acc = f.mul(acc, acc)
        if b:
            acc = f.mul(acc, base)
    return acc


def ladder(px: torch.Tensor, py: torch.Tensor, bits: torch.Tensor, graph: bool = True):
    """[k]P over rows: px, py [n, L] reduced limbs, bits [nbits, n] bool
    (MSB first). Returns canonical affine (x, y) limbs, the identity mask
    and the fallback mask (H == 0 on a counted mixed addition). ``graph``
    replays each step from a CUDA graph on a CUDA device."""
    n, dev = px.shape[0], px.device
    one = f.const("ONE", dev).expand(n, f.LIMBS)
    hs = torch.empty((bits.shape[0], n, f.LIMBS), dtype=torch.int32, device=dev)
    live = torch.empty(bits.shape, dtype=torch.bool, device=dev)
    if graph and dev.type == "cuda":
        with _GRAPHS_LOCK:  # one caller at a time on a graph's static buffers
            g = _GRAPHS.get((dev, n))
            if g is None:
                g = _GRAPHS[(dev, n)] = _StepGraph(n, dev)
            g.px.copy_(px)
            g.py.copy_(py)
            g.one.copy_(one)
            g.state.zero_()
            g.inf.fill_(True)
            for s in range(bits.shape[0]):
                g.bit.copy_(bits[s])
                g.graph.replay()
                g.state.copy_(g.out[0])
                g.inf.copy_(g.out[1])
                hs[s].copy_(g.out[2])
                live[s].copy_(g.out[3])
            state, inf = g.state.clone(), g.inf.clone()
    else:
        state = torch.zeros((3, n, f.LIMBS), dtype=torch.int32, device=dev)
        inf = torch.ones(n, dtype=torch.bool, device=dev)
        for s in range(bits.shape[0]):
            state, inf, hs[s], live[s] = ladder_step(state, inf, px, py, one, bits[s])
    fb = (live & (f.canonical(hs) == 0).all(dim=-1)).any(dim=0)
    X, Y, Z = state[0], state[1], state[2]
    # affine conversion stays on the device: one batched z^(p-2)
    zi = pow_limbs(Z, P - 2)
    zi2 = f.mul(zi, zi)
    xa = f.canonical(f.mul(X, zi2))
    ya = f.canonical(f.mul(Y, f.mul(zi2, zi)))
    return xa, ya, inf, fb


def _bit_columns(scalars: Sequence[int]) -> Tuple[np.ndarray, int]:
    """MSB-first bit columns [nbits, n] over the max scalar width (leading
    zeros keep short rows on the identity — exact, like the oracle)."""
    nbits = max(int(s).bit_length() for s in scalars)
    nbytes = (nbits + 7) // 8
    raw = np.frombuffer(
        b"".join(int(s).to_bytes(nbytes, "big") for s in scalars),
        dtype=np.uint8,
    ).reshape(len(scalars), nbytes)
    bits = np.unpackbits(raw, axis=1)[:, nbytes * 8 - nbits :]
    return np.ascontiguousarray(bits.T).astype(bool), nbits


def pow_p_batch(values: Sequence[int], exp: int, device) -> List[int]:
    """[v^exp mod p for v in values] on the limb ops, on ``device``."""
    if not values:
        return []
    if exp.bit_length() < 2:
        return [pow(v % P, exp, P) for v in values]
    base = torch.from_numpy(f.to_limbs_bulk([v % P for v in values])).to(device)
    out = f.canonical(pow_limbs(base, exp)).cpu().numpy()
    return [f.from_limbs(out[i]) for i in range(out.shape[0])]


def g1_ladder_batch(
    scalars: Sequence[int], points: Sequence[Tuple[int, int]], device
) -> Tuple[List[Optional[Tuple[int, int]]], List[bool]]:
    """Batched [k_i]P_i over E(Fp) on ``device``; (results,
    fallback_mask) with None for identity results and flagged rows for the
    host to re-sign."""
    n = len(scalars)
    if n == 0:
        return [], []
    bits, nbits = _bit_columns(scalars)
    if nbits == 0:
        return [None] * n, [False] * n
    px = torch.from_numpy(f.to_limbs_bulk([p[0] for p in points])).to(device)
    py = torch.from_numpy(f.to_limbs_bulk([p[1] for p in points])).to(device)
    xa, ya, inf, fb = ladder(px, py, torch.from_numpy(bits).to(device))
    xa, ya = xa.cpu().numpy(), ya.cpu().numpy()
    inf, fb = inf.cpu().numpy(), fb.cpu().numpy()
    results: List[Optional[Tuple[int, int]]] = []
    for i in range(n):
        if inf[i] or fb[i]:
            results.append(None)
        else:
            results.append((f.from_limbs(xa[i]), f.from_limbs(ya[i])))
    return results, [bool(x) for x in fb]
