"""Device ops: the limb fields, the groups, the comb path, the G1 MSM, the
pairing, the hand-written CUDA kernels' wrappers and the dense DAG kernels.
The package re-exports the dense DAG functions (numpy and torch, no card
needed at import)."""

from dag_rider_tpu_torch.ops.dag_kernels import (
    admission_mask,
    closure_from,
    closure_from_full,
    leader_reach,
    pairwise_reach,
    reach_chain,
    round_complete,
    strong_edge_quorum,
    wave_commit_votes,
)

__all__ = [
    "admission_mask",
    "closure_from",
    "closure_from_full",
    "leader_reach",
    "pairwise_reach",
    "reach_chain",
    "round_complete",
    "strong_edge_quorum",
    "wave_commit_votes",
]
