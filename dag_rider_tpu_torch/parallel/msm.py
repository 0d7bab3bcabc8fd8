"""Mesh-sharded G1 multi-scalar multiplication — the n = 1024 rung.

Port of ``dag_rider_tpu/parallel/msm.py``: the MSM half of BASELINE config
#5 ("1024-node full-wave MSM, multi-host pmap on v5e-16"). The T padded
points split over the mesh; each entry runs ``bls_msm.window_sums`` on its
own device (radix-16 tables, the gather and its window tree through
``cuda_group381.padd381_xx``) down to 64 partial window sums. The D
partials are copied to the first entry (the reference's one
``all_gather``), folded with ``bls_msm.tree_reduce`` (odd counts carry, so
any mesh size folds) and combined by the Horner chain in one
``horner381``. The group law is ``bls_msm``'s; sharding changes the
schedule, not the math, and ``unpack_point`` normalises to affine, so the
result equals the single-device ``bls_msm.msm`` and the host group law,
tuple for tuple.

Launches per MSM over T padded points on D entries: 15 + log2(T/D)
``padd381_xx`` per entry, one per level of the fold, and one
``horner381``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from dag_rider_tpu_torch.ops import bls_msm, cuda_group381 as G
from dag_rider_tpu_torch.parallel.mesh import Mesh, make_mesh, split_rows


def padded_size(n: int, shards: int) -> int:
    """Padded point count for n points over ``shards`` entries: a
    power-of-two slice each. It is the reference's ``bls_msm._pad(n,
    base=max(4, shards))`` wherever that splits evenly over the mesh (all
    but 3 entries, which the reference's padding does not divide)."""
    per = bls_msm._pad(-(-n // shards), base=max(1, 4 // shards))
    return per * shards


class ShardedMSM:
    """Host seam with the signature of :func:`ops.bls_msm.msm`: plugs into
    ``threshold.aggregate(msm=...)``, ``ThresholdCoin`` and
    ``CertVerifier(msm="sharded")``. ``mesh`` defaults to every visible
    card."""

    def __init__(self, mesh: Optional[Mesh] = None):
        self.mesh = mesh if mesh is not None else make_mesh()
        self.n_shards = self.mesh.size

    def window_partials(self, scalars: Sequence[int], points: Sequence[tuple]) -> torch.Tensor:
        """Each entry's 64 window sums, on the first entry: [D, 99, 64]."""
        bls_msm.check_msm_knob()
        t = padded_size(len(points), self.n_shards)
        arrays = bls_msm.pack_inputs(scalars, points, t)
        first = self.mesh.devices[0]
        partials = []
        for dev, nib, px, py, pz in zip(
            self.mesh.devices, *(split_rows(a, self.n_shards) for a in arrays)
        ):
            nib, px, py, pz = (torch.from_numpy(a).to(dev) for a in (nib, px, py, pz))
            pts = torch.cat([px, py, pz], dim=-1).t().contiguous()  # [99, T/D]
            partials.append(bls_msm.window_sums(nib, pts).to(first))
        return torch.stack(partials)

    def __call__(self, scalars: Sequence[int], points: Sequence[tuple]) -> Optional[tuple]:
        folded = bls_msm.tree_reduce(self.window_partials(scalars, points))
        _, canon = G.horner381(folded[0].contiguous())
        return bls_msm.unpack_point(*canon)

    def sum_points(self, points: Sequence[tuple]) -> Optional[tuple]:
        """All-ones MSM: mesh-sharded certificate signature aggregation,
        as :func:`ops.bls_msm.sum_points`."""
        return self([1] * len(points), points)
