"""Epoch reconfiguration: validator-set changes ordered
through consensus itself.

The port's copy of ``dag_rider_tpu/epoch/__init__.py``.

The subsystem closes ROADMAP item 2's "run forever" gap: reconfiguration
requests (join / leave / key-rotation) ride the mempool as magic-prefixed
control transactions (:data:`dag_rider_tpu_torch.core.codec.EPOCH_MAGIC`),
commit through the ordinary total order, and take effect at a
deterministic **epoch boundary** — a wave number every correct process
derives identically from the ordered log — where the threshold-coin keys
rotate (seeded dealer or full joint-Feldman resharing over
:mod:`dag_rider_tpu_torch.crypto.dkg`), stale pre-rotation messages start
bouncing off the receive seam via the epoch id in the wire form, and the
settled epoch's DAG prefix feeds span-certificate-attested snapshots
(:mod:`dag_rider_tpu_torch.utils.checkpoint`) that a joiner verifies with a
handful of pairing checks instead of replaying pruned history.
"""

from dag_rider_tpu_torch.epoch.manager import (
    EpochManager,
    EpochTransition,
    derive_epoch_keys,
    epoch_seed,
)

__all__ = [
    "EpochManager",
    "EpochTransition",
    "derive_epoch_keys",
    "epoch_seed",
]
