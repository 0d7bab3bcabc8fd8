"""Dense-tensor DAG kernels — torch twins of ``dag_rider_tpu/ops/dag_kernels.py``.

The DAG is encoded as dense tensors indexed by (round, source):

- ``exists[R, n]``: bool — vertex (r, i) is in the DAG;
- ``strong[R, n, n]``: bool — ``strong[r, i, j]`` means vertex (r, i) has a
  strong edge to vertex (r-1, j); row r = 0 is unused (genesis);
- ``weak[R, n, R, n]``: the dense weak-edge form, for small configs and
  tests (production ordering keeps weak edges sparse on the host).

Reachability is a chain of boolean matrix products, and the wave-commit
rule "2f+1 round-(w,4) vertices have a strong path to the leader" is one
3-product chain and a popcount. Every function runs on the device of its
inputs (the card unless the caller hands it CPU tensors). The JAX package
runs these as jnp matmuls on the MXU with no Pallas kernel; here they are
``torch.matmul`` in float32 with the counts compared against 0.

Host consensus calls the numpy twins (``*_np``), as in the reference: a
device dispatch costs more than the whole numpy op at the sizes the pump
sees. ``leader_reach_np`` descends the vector pump's retroactive leader
chain (``consensus.process.Process._leader_path``).
"""

from __future__ import annotations

import numpy as np
import torch


def _bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Boolean matrix product (a @ b) > 0, as float32 counts.

    a: [..., m, k] bool, b: [..., k, p] bool -> [..., m, p] bool. A count
    is at most k, exact in float32 for k < 2^24; the 0/1 operands are exact
    even where a card's matmul runs in TF32, and every product term is 0 or
    1, so no rounding can make a positive count 0."""
    return (a.float() @ b.float()) > 0


def reach_chain(strong_stack: torch.Tensor) -> torch.Tensor:
    """Multi-round strong reachability as a matmul chain.

    strong_stack: bool [k, n, n], top round first (``strong_stack[0]`` maps
    round r_hi -> r_hi - 1, ``strong_stack[k-1]`` maps r_lo + 1 -> r_lo).
    Returns bool [n, n]: (i, j) iff vertex (r_hi, i) has a strong path to
    vertex (r_lo, j)."""
    out = strong_stack[0]
    for s in strong_stack[1:]:
        out = _bmm(out, s)
    return out


def round_complete(exists_row: torch.Tensor, *, quorum: int) -> torch.Tensor:
    """|dag[r]| >= 2f+1, the round-advance condition -> 0-d bool."""
    return exists_row.int().sum() >= quorum


def admission_mask(
    strong_pred: torch.Tensor,
    exists_prev: torch.Tensor,
    weak_pred: torch.Tensor,
    exists: torch.Tensor,
) -> torch.Tensor:
    """Which buffered vertices have all their predecessors in the DAG.

    strong_pred bool [B, n] (strong-edge targets in round r-1), exists_prev
    bool [n], weak_pred bool [B, R, n], exists bool [R, n] -> bool [B]."""
    strong_ok = ~torch.any(strong_pred & ~exists_prev[None, :], dim=-1)
    weak_ok = ~torch.any((weak_pred & ~exists[None, :, :]).flatten(-2), dim=-1)
    return strong_ok & weak_ok


def strong_edge_quorum(strong_pred: torch.Tensor, *, quorum: int) -> torch.Tensor:
    """Admission gate: a vertex carries >= 2f+1 strong edges. bool [B, n]
    -> bool [B]."""
    return strong_pred.int().sum(dim=-1) >= quorum


def wave_commit_votes(
    strong_wave: torch.Tensor,
    exists_r4: torch.Tensor,
    leader,
    *,
    quorum: int,
):
    """The wave-commit quorum check.

    strong_wave: bool [3, n, n], adjacency for rounds (w,4), (w,3), (w,2);
    exists_r4: bool [n]; leader: the leader's source at round (w,1) (an int
    or an integer 0-d tensor). Returns (commit 0-d bool, votes bool [n]):
    votes[i] iff vertex (round(w,4), i) exists and has a strong path to the
    leader; commit iff popcount(votes) >= quorum."""
    votes = reach_chain(strong_wave)[:, leader] & exists_r4
    return votes.int().sum() >= quorum, votes


def leader_reach(strong_wave: torch.Tensor, hi_leader) -> torch.Tensor:
    """One step of the retroactive leader-chain descent: bool [k, n, n]
    from the higher leader's round down to the lower leader's round + 1 ->
    bool [n], the lower round's sources the higher leader reaches."""
    return reach_chain(strong_wave)[hi_leader, :]


def closure_from(seeds: torch.Tensor, strong: torch.Tensor) -> torch.Tensor:
    """Strong-edge causal history of a seed set: reached[r-1] |=
    reached[r] @ strong[r], from the top round down. seeds bool [R, n],
    strong bool [R, n, n] -> bool [R, n] (seeds included)."""
    rows = [None] * seeds.shape[0]
    rows[-1] = seeds[-1]
    for r in range(seeds.shape[0] - 1, 0, -1):
        rows[r - 1] = seeds[r - 1] | _bmm(rows[r][None, :], strong[r])[0]
    return torch.stack(rows)


def closure_from_full(
    seeds: torch.Tensor, strong: torch.Tensor, weak: torch.Tensor
) -> torch.Tensor:
    """Causal history over strong and weak edges (dense weak form
    bool [R, n, R, n]: weak[r, i, r2, j] means (r, i) has a weak edge to
    (r2, j)). Returns bool [R, n] as :func:`closure_from`."""
    rounds, n = seeds.shape
    acc = seeds.clone()
    for r in range(rounds - 1, -1, -1):
        row = acc[r]  # final: nothing above r is left to process
        if r > 0:
            acc[r - 1] |= _bmm(row[None, :], strong[r])[0]
        acc |= ((row.float() @ weak[r].float().reshape(n, rounds * n)) > 0).reshape(rounds, n)
    return acc


def pairwise_reach(strong: torch.Tensor) -> torch.Tensor:
    """Cumulative chain products chain[r] = strong[r] @ ... @ strong[1]:
    chain[r][i, j] iff (r, i) strongly reaches (0, j); chain[0] = I.
    bool [R, n, n] -> bool [R, n, n]."""
    n = strong.shape[1]
    out = [torch.eye(n, dtype=torch.bool, device=strong.device)]
    for s in strong[1:]:
        out.append(_bmm(s, out[-1]))
    return torch.stack(out)


# ---------------------------------------------------------------------------
# Host twins (numpy)
# ---------------------------------------------------------------------------


def reach_chain_np(strong_stack) -> "np.ndarray":
    """Numpy twin of :func:`reach_chain`: bool[k, n, n] top round first ->
    bool[n, n] reachability from round r_hi to round r_lo."""
    out = strong_stack[0]
    for s in strong_stack[1:]:
        out = out @ s
    return np.asarray(out, dtype=bool)


def round_complete_np(exists_row, *, quorum: int) -> bool:
    """Numpy twin of :func:`round_complete`."""
    return bool(np.count_nonzero(exists_row) >= quorum)


def admission_mask_np(strong_pred, exists_prev, weak_pred, exists):
    """Numpy twin of :func:`admission_mask` (same shapes/semantics)."""
    strong_ok = ~np.any(strong_pred & ~exists_prev[None, :], axis=-1)
    weak_ok = ~np.any(weak_pred & ~exists[None, :, :], axis=(-2, -1))
    return strong_ok & weak_ok


def strong_edge_quorum_np(strong_pred, *, quorum: int):
    """Numpy twin of :func:`strong_edge_quorum`: bool[B]."""
    return np.count_nonzero(strong_pred, axis=-1) >= quorum


def leader_reach_np(strong_stack, hi_leader: int) -> "np.ndarray":
    """Numpy twin of ``leader_reach`` — but seeded, so the descent is
    vector @ matrix per round (O(k n^2)) instead of materializing the full
    n x n chain product (O(k n^3))."""
    vec = np.asarray(strong_stack[0][hi_leader], dtype=bool)
    for s in strong_stack[1:]:
        vec = vec @ s
    return np.asarray(vec, dtype=bool)
