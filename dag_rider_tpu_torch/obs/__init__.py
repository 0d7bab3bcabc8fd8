"""Causal tracing + flight recording on the slog.EventLog seam.

The port's copy of ``dag_rider_tpu/obs/__init__.py``.

Knob-gated (`DAGRIDER_TRACE`): when on, the simulator / node /
scenario runners build one :class:`Tracing` bundle — an ``EventLog``
whose sink tees into a bounded :class:`TraceRecorder` ring and a
:class:`FlightRecorder` trigger watch — and hand its ``log`` to every
component exactly where a caller-provided log would go. All tracing
cost therefore collapses to the ``EventLog.event`` attribute test when
the knob is off, and commit order is unaffected either way (events
observe; they never feed consensus state).

Transaction sampling is a pure function of the payload
(``crc32(tx) / 2**32 < rate``): every process samples the *same*
transactions with no RNG and no clock, keeping the determinism rules
intact and making cross-process joins trivial.
"""

from __future__ import annotations

import time
import zlib
from typing import Callable, List, Optional, Tuple

from dag_rider_tpu_torch.config import env_flag, env_float, env_str
from dag_rider_tpu_torch.obs.flight import TRIGGERS, FlightRecorder
from dag_rider_tpu_torch.obs.recorder import TraceRecorder
from dag_rider_tpu_torch.utils import slog

__all__ = [
    "HIGH_FREQ_EVENTS",
    "TRACE_EVENTS",
    "TRIGGERS",
    "FlightRecorder",
    "TraceRecorder",
    "Tracing",
    "block_key",
    "build_tracing",
    "sample_tx",
    "trace_enabled",
    "tx_key",
]

_SCALE = float(2**32)

#: Per-message / per-round debug chatter excluded from the trace ring:
#: these fire once per delivered message (admit/delivered), per sync-
#: storm message, or n times per round (round_advance — ~2/3 of a traced
#: ring at n=16), so recording them costs a record build + two ring
#: appends on the consensus hot path — the bulk of trace-on overhead —
#: while the causal chains and flight post-mortems join on none of them
#: (wave_decided + phase spans + tx_propose already carry progression).
#: ``capture()`` logs and stdlib bridges still see everything (their
#: EventLog has no name filter).
HIGH_FREQ_EVENTS = frozenset(
    {
        "admit",
        "delivered",
        "behind_horizon",
        "attested_floor",
        "round_advance",
        # one per received lane batch — same per-message cadence as
        # ``admit`` once dissemination lanes are on
        "lane_batch",
    }
)

#: What the tracing bundle records: the full registered schema minus
#: the per-message chatter.
TRACE_EVENTS = frozenset(slog.KNOWN_EVENTS - HIGH_FREQ_EVENTS)


def trace_enabled() -> bool:
    return env_flag("DAGRIDER_TRACE")


def tx_key(tx: bytes) -> int:
    """Deterministic join key for one transaction payload."""
    return zlib.crc32(tx)


def block_key(encoded: bytes) -> int:
    """Deterministic join key for one encoded block."""
    return zlib.crc32(encoded)


def sample_tx(tx: bytes, rate: float) -> bool:
    """Payload-hash sampling: same verdict at every process."""
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    return zlib.crc32(tx) / _SCALE < rate


class Tracing:
    """One wired tracing bundle: the log to install + its recorders."""

    __slots__ = ("log", "recorder", "flight", "sample_rate")

    def __init__(
        self,
        log: slog.EventLog,
        recorder: TraceRecorder,
        flight: FlightRecorder,
        sample_rate: float,
    ):
        self.log = log
        self.recorder = recorder
        self.flight = flight
        self.sample_rate = sample_rate


def build_tracing(
    *,
    base_sink: Optional[slog.Sink] = None,
    clock: Callable[[], float] = time.time,
    ring: int = 0,
    flight_dir: Optional[str] = None,
    flight_events: int = 0,
    sample_rate: Optional[float] = None,
    context: Optional[dict] = None,
) -> Tracing:
    """Build the trace ring + flight recorder + EventLog tee.

    Knob defaults (`DAGRIDER_TRACE_RING`, `DAGRIDER_FLIGHT_DIR`,
    `DAGRIDER_FLIGHT_EVENTS`, `DAGRIDER_TRACE_SAMPLE`) apply wherever
    an argument is left at its zero value; ``base_sink`` preserves a
    pre-existing sink (e.g. the node's stdlib bridge) in the tee.
    """
    recorder = TraceRecorder(ring)
    flight = FlightRecorder(
        flight_dir if flight_dir is not None else env_str("DAGRIDER_FLIGHT_DIR"),
        capacity=flight_events,
        clock=clock,
    )
    rate = (
        env_float("DAGRIDER_TRACE_SAMPLE") if sample_rate is None else sample_rate
    )
    sink = slog.tee(base_sink, recorder, flight.sink)
    log = slog.EventLog(
        sink, clock=clock, names=TRACE_EVENTS, **(context or {})
    )
    return Tracing(log, recorder, flight, rate)


def sampled_keys(
    txs: Tuple[bytes, ...], rate: float
) -> List[int]:
    """Join keys of the sampled transactions in one block/batch."""
    return [tx_key(t) for t in txs if sample_tx(t, rate)]
