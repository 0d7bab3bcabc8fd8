"""Dense-tensor DAG queries — the numpy twin host consensus calls.

The port's copy of ``leader_reach_np`` from ``dag_rider_tpu/ops/dag_kernels.py``:
the retroactive leader chain of the vector pump
(``consensus.process.Process._leader_path``) descends the dense strong-edge
mirrors with it. The module's device functions (``reach_chain``,
``leader_reach``, ``closure_from``, ...) are not ported yet (ROADMAP Queue 1
item 7).

The DAG is encoded as dense tensors indexed by (round, source):
``strong[r, i, j]`` means vertex (r, i) has a strong edge to vertex
(r-1, j), and reachability is a chain of boolean matrix products.
"""

from __future__ import annotations

import numpy as np


def leader_reach_np(strong_stack, hi_leader: int) -> "np.ndarray":
    """Numpy twin of ``leader_reach`` — but seeded, so the descent is
    vector @ matrix per round (O(k n^2)) instead of materializing the full
    n x n chain product (O(k n^3))."""
    vec = np.asarray(strong_stack[0][hi_leader], dtype=bool)
    for s in strong_stack[1:]:
        vec = vec @ s
    return np.asarray(vec, dtype=bool)
