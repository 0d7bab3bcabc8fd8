"""The per-round device step: verify a round's batch and vote its wave.

Port of ``dag_rider_tpu/parallel/round_step.py``. One DAG round per
dispatch: the round's vertex-signature batch is verified on the windowed
path (``ops/windowed.py``: the kernels on a card, ``curve.verify_core`` on
the CPU), its rows split over the mesh, and the wave-commit quorum check
(``dag_kernels.wave_commit_votes``, small [n, n] boolean products) runs on
the first entry. The host state machine consumes (accept_mask, commit,
votes) and makes every ordering decision.
"""

from __future__ import annotations

import torch

from dag_rider_tpu_torch.ops import dag_kernels, field, windowed
from dag_rider_tpu_torch.parallel.mesh import Mesh, gather_rows, split_rows


def make_round_step(mesh: Mesh, *, quorum: int):
    """The round step over ``mesh``.

    Inputs (leading dim B split over the mesh; B a multiple of its size):
      s_nibbles[B,64] k_nibbles[B,64] a_x/a_y/a_t[B,22] a_valid[B]
      r_y[B,22] r_sign[B] prevalid[B] — the verify batch, as numpy arrays
      or tensors (the windowed prep arrays);
      strong_wave[3,n,n] exists_r4[n] leader — the wave-commit inputs.

    Returns (accept_mask[B], commit[], votes[n]) on the first entry."""
    first = mesh.devices[0]

    def round_step(s_nibbles, k_nibbles, a_x, a_y, a_t, a_valid, r_y, r_sign, prevalid,
                   strong_wave, exists_r4, leader):
        parts = [
            split_rows(torch.as_tensor(a), mesh.size)
            for a in (s_nibbles, k_nibbles, a_x, a_y, a_t, a_valid, r_y, r_sign, prevalid)
        ]
        masks = []
        for i, dev in enumerate(mesh.devices):
            s, k, x, y, t, valid, ry, rs, pv = (p[i].to(dev) for p in parts)
            one = field.const("ONE", dev).expand_as(x)
            masks.append(windowed.verify(s, k, (x, y, one, t), valid, ry, rs, pv))
        accept = gather_rows(masks, first)
        commit, votes = dag_kernels.wave_commit_votes(
            torch.as_tensor(strong_wave).to(first), torch.as_tensor(exists_r4).to(first),
            int(leader), quorum=quorum,
        )
        return accept, commit, votes

    return round_step
