"""Epoch manager: deterministic boundary scheduling + key derivation.

The port's copy of ``dag_rider_tpu/epoch/manager.py``.

Everything here is a pure function of the ordered log. A control
transaction committed in (the delivery chunk of) wave ``w`` schedules the
next boundary at the first multiple of ``epoch_waves`` that leaves at
least :data:`MIN_SLACK_WAVES` waves of runway — the slack guarantees
every correct process learns the boundary (by delivering the scheduling
chunk) before any round past the boundary can gather a quorum, because
:meth:`Process._try_advance` holds round advancement at the boundary's
last round until the local epoch has crossed (the barrier; see
``process.py``). Since the total order is identical at every correct
process, so are the boundary, the op batch, the epoch seed, and hence
the rotated keys.

The epoch **seed** chains: ``seed_{e+1} = H(domain | seed_e | e+1 |
boundary | ops...)``, with every committed op's canonical encoding
folded in. An adversary can pick its ops' bytes, but it cannot bias the
seed after commitment any more than it can rewrite the ordered log —
the same argument the committed-transcript coin designs make.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import List, Optional, Set, Tuple

from dag_rider_tpu_torch.core.codec import encode_epoch_op, epoch_op_of
from dag_rider_tpu_torch.core.types import Block, EpochOp

#: minimum waves between a scheduling chunk's wave and the boundary it
#: schedules: the barrier needs every correct process to deliver the
#: scheduling chunk (and so learn the boundary) before the boundary's
#: last round can quorum, and one wave of slack is not enough once wave
#: evaluation pipelines — two keeps a full wave of retroactive-commit
#: runway between "the tx is visible" and "rounds stop".
MIN_SLACK_WAVES = 2

_SEED_DOMAIN = b"dagrider-epoch-seed-v1|"
_GENESIS_SEED = b"dagrider-epoch-genesis-v1"


def epoch_seed(
    prev_seed: bytes,
    epoch: int,
    boundary_wave: int,
    ops: Tuple[Tuple[int, EpochOp], ...],
) -> bytes:
    """The deterministic seed for ``epoch`` (the epoch being entered)."""
    h = hashlib.sha512()
    h.update(_SEED_DOMAIN)
    h.update(prev_seed)
    h.update(epoch.to_bytes(8, "little"))
    h.update(boundary_wave.to_bytes(8, "little"))
    for wave, op in ops:
        h.update(wave.to_bytes(8, "little"))
        h.update(encode_epoch_op(op))
    return h.digest()[:32]


@dataclasses.dataclass(frozen=True)
class EpochTransition:
    """One crossed boundary: the epoch being entered, the last wave of
    the epoch just finished, the chained seed, and the op batch that
    rode into it (in delivery order)."""

    epoch: int
    boundary_wave: int
    seed: bytes
    ops: Tuple[Tuple[int, EpochOp], ...]

    @property
    def first_wave(self) -> int:
        """First wave governed by the new epoch's keys."""
        return self.boundary_wave + 1


def derive_epoch_keys(
    transition: EpochTransition,
    n: int,
    threshold: int,
    mode: str,
    index: int,
):
    """The new :class:`~dag_rider_tpu_torch.crypto.threshold.ThresholdKeys`
    for ``transition``, or None when ``mode`` is "none".

    "seed" runs the deterministic seeded dealer — every process derives
    the identical full key set from the committed transcript, the cheap
    path for in-process clusters and tests. "dkg" runs the full
    joint-Feldman resharing flow (:func:`dag_rider_tpu_torch.crypto.dkg.
    run_resharing`) and returns this participant's dealerless view —
    the group pk and share pks still agree across processes because the
    resharing's inputs all chain from the same committed seed.
    """
    if mode == "none":
        return None
    if mode == "seed":
        from dag_rider_tpu_torch.crypto.threshold import ThresholdKeys

        return ThresholdKeys.generate(n, threshold, seed=transition.seed)
    if mode == "dkg":
        from dag_rider_tpu_torch.crypto.dkg import run_resharing

        results = run_resharing(n, threshold, transition.seed)
        for r in results:
            if r.index == index:
                return r.to_keys()
        raise RuntimeError(
            f"resharing produced no result for participant {index}"
        )
    raise ValueError(f"unknown epoch rotation mode {mode!r}")


class EpochManager:
    """Schedules boundaries and accumulates op batches from delivered
    blocks. One instance per :class:`Process`; all of its state is a
    deterministic function of the delivery stream it is fed, so two
    managers fed the same total order are bit-identical — the property
    every test in tests/test_epoch.py leans on.
    """

    def __init__(self, epoch_waves: int, *, epoch: int = 0,
                 seed: Optional[bytes] = None):
        if epoch_waves < 1:
            raise ValueError(f"epoch_waves must be >= 1, got {epoch_waves}")
        self.epoch_waves = epoch_waves
        #: current (active) epoch id — what outgoing messages are tagged
        #: with and what the stale gate compares against
        self.epoch = epoch
        #: chained seed of the ACTIVE epoch (genesis constant for epoch 0
        #: unless restored from a checkpoint)
        self.seed = seed if seed is not None else _GENESIS_SEED
        #: pending boundary wave (None = nothing scheduled)
        self.boundary_wave: Optional[int] = None
        #: committed ops awaiting the pending boundary, delivery order
        self.pending_ops: List[Tuple[int, EpochOp]] = []
        #: crossed transitions, oldest first (bounded: one per epoch)
        self.history: List[EpochTransition] = []
        #: dedup keys for ops already accepted into the current batch —
        #: client retries commit the same bytes twice; every process
        #: sees the same duplicates in the same order, so dropping
        #: repeats is deterministic
        self._seen: Set[bytes] = set()

    # -- scheduling --------------------------------------------------------

    def _schedule_from(self, wave: int) -> int:
        w = self.epoch_waves
        boundary = ((wave // w) + 1) * w
        while boundary - wave < MIN_SLACK_WAVES:
            boundary += w
        return boundary

    def observe_op(self, op: EpochOp, wave: int) -> bool:
        """Record one committed control op from wave ``wave``'s delivery
        chunk. Returns True when the op entered the batch (False for an
        in-batch duplicate)."""
        key = hashlib.sha256(encode_epoch_op(op)).digest()
        if key in self._seen:
            return False
        self._seen.add(key)
        self.pending_ops.append((wave, op))
        if self.boundary_wave is None:
            self.boundary_wave = self._schedule_from(wave)
        return True

    def note_block(self, block: Block, wave: int) -> int:
        """Scan a delivered block for control transactions; returns how
        many entered the batch. Malformed magic-prefixed transactions
        are payload bytes (codec.epoch_op_of) and every correct process
        skips them identically."""
        accepted = 0
        for tx in block.transactions:
            op = epoch_op_of(tx)
            if op is not None and self.observe_op(op, wave):
                accepted += 1
        return accepted

    # -- crossing ----------------------------------------------------------

    def should_advance(self, delivered_wave: int) -> bool:
        """True once ``delivered_wave`` has reached the pending
        boundary: the chunk for the boundary wave itself is the last
        pre-rotation delivery."""
        return (
            self.boundary_wave is not None
            and delivered_wave >= self.boundary_wave
        )

    def advance(self) -> EpochTransition:
        """Cross the pending boundary: bump the epoch, chain the seed,
        archive the transition, and reset the op batch."""
        if self.boundary_wave is None:
            raise RuntimeError("no boundary pending")
        boundary = self.boundary_wave
        ops = tuple(self.pending_ops)
        nxt = self.epoch + 1
        seed = epoch_seed(self.seed, nxt, boundary, ops)
        transition = EpochTransition(
            epoch=nxt, boundary_wave=boundary, seed=seed, ops=ops
        )
        self.epoch = nxt
        self.seed = seed
        self.boundary_wave = None
        self.pending_ops = []
        self._seen = set()
        self.history.append(transition)
        return transition

    # -- round barrier -----------------------------------------------------

    def hold_round(self, rnd: int, wave_length: int) -> bool:
        """True when creating a vertex in round ``rnd`` must wait for
        the pending boundary to be crossed first: rounds past the
        boundary's last round belong to the next epoch and must carry
        next-epoch coin shares. Rounds at or below the boundary flow
        freely — the boundary wave itself has to complete for the
        crossing to ever happen."""
        if self.boundary_wave is None:
            return False
        return rnd > self.boundary_wave * wave_length
