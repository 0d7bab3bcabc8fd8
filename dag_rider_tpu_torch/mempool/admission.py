"""Watermark-driven admission control: accept → throttle → shed.

The port's copy of ``dag_rider_tpu/mempool/admission.py``.

The backpressure story the ROADMAP's "heavy traffic" north star needs:
the pool's fill fraction drives a three-state ladder, and the current
state is surfaced to callers on every submit (SubmitResult.state) so a
well-behaved client can slow down *before* its traffic is dropped.

- fill < admit_low       — **accept**: everything in, subject only to
  the optional per-source hard rate cap (``source_rate``);
- admit_low <= fill < admit_high — **throttle**: each source is cut to
  ``throttle_rate`` tx/s via a token bucket (fair degradation: a
  firehose source saturates its own bucket, quiet sources still get
  their trickle through);
- fill >= admit_high     — **shed**: everything is refused until the
  batcher drains the pool back below the high watermark.

Deterministic by construction: no wall-clock reads — every decision
takes an explicit ``now``, so simulations and tests drive it on a
virtual clock and replay byte-identically.
"""

from __future__ import annotations

from typing import Dict

from dag_rider_tpu_torch.config import MempoolConfig

ACCEPT = "accept"
THROTTLE = "throttle"
SHED = "shed"


class _TokenBucket:
    """Per-source rate limiter: refills at ``rate`` tx/s up to
    ``burst``; each admitted transaction spends one token."""

    __slots__ = ("tokens", "last")

    def __init__(self, burst: float, now: float) -> None:
        self.tokens = burst
        self.last = now

    def spend(self, rate: float, burst: float, now: float) -> bool:
        if now > self.last:
            self.tokens = min(burst, self.tokens + (now - self.last) * rate)
            self.last = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


class AdmissionController:
    """The accept/throttle/shed ladder over one pool's fill signal."""

    def __init__(self, cfg: MempoolConfig) -> None:
        self.cfg = cfg
        self._buckets: Dict[str, _TokenBucket] = {}
        #: the ladder state of the most recent decision — the
        #: backpressure signal callers read
        self.state = ACCEPT
        # lifetime counters
        self.accepted = 0
        self.shed_watermark = 0
        self.shed_rate = 0

    def _state_of(self, fill: float) -> str:
        if fill >= self.cfg.admit_high:
            return SHED
        if fill >= self.cfg.admit_low:
            return THROTTLE
        return ACCEPT

    def decide(self, client: str, fill: float, now: float) -> bool:
        """One transaction's verdict. Updates ``state`` as a side effect
        (the ladder state is a property of the pool, not of the client)."""
        self.state = state = self._state_of(fill)
        if state == SHED:
            self.shed_watermark += 1
            return False
        if state == THROTTLE:
            rate = self.cfg.throttle_rate
            if self.cfg.source_rate > 0:
                rate = min(rate, self.cfg.source_rate)
        elif self.cfg.source_rate > 0:
            rate = self.cfg.source_rate
        else:
            self.accepted += 1
            return True
        bucket = self._buckets.get(client)
        if bucket is None:
            bucket = self._buckets[client] = _TokenBucket(
                self.cfg.source_burst, now
            )
        if bucket.spend(rate, self.cfg.source_burst, now):
            self.accepted += 1
            return True
        self.shed_rate += 1
        return False

    def forget_idle(self, now: float, idle_s: float = 300.0) -> None:
        """Drop buckets for sources silent longer than ``idle_s`` — the
        per-source map must not grow one entry per client forever (same
        bounded-state rule the DAG GC enforces)."""
        dead = [c for c, b in self._buckets.items() if now - b.last > idle_s]
        for c in dead:
            del self._buckets[c]
