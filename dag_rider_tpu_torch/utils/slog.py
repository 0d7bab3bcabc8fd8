"""Structured event logging — the L5 observability layer.

The port's copy of ``dag_rider_tpu/utils/slog.py``.

The reference logs three Debug lines through charon's zap wrapper
(``process/process.go:109,213,220``); SURVEY §5 asks the build to do
better. This is a structured *event* log: named events with key-value
fields and per-logger context (process index, node name), with a
pluggable sink so the same call sites serve tests (capture list), CLI
runs (stdlib logging), and production (anything that accepts one dict).

Zero cost when disabled: the default sink is None and ``event()`` is a
single attribute test — consensus hot loops can log unconditionally.

The timestamp clock is injectable (same convention as the
``transport/net.py`` wall-clock injection): pass ``clock=`` to pin event
stamps to a virtual or frozen clock in tests; the default stays
``time.time`` by reference, never read at import.
"""

from __future__ import annotations

import json
import logging
import time
from typing import Callable, Dict, List, Optional

# A sink receives one flat dict per event.
Sink = Callable[[Dict[str, object]], None]

#: Every event name any module may emit (mirroring
#: ``utils.metrics.KNOWN_COUNTERS``). The driderlint events checker
#: (analysis/events.py) rejects a literal ``log.event("...")`` whose
#: name is not registered here — a typo'd event name silently creates a
#: record no trace report, flight dump, or dashboard will ever join on.
KNOWN_EVENTS = frozenset(
    {
        # consensus/process.py — admission, rounds, waves, sync
        "admit",
        "attested_floor",
        "behind_horizon",
        "delivered",
        "equivocation",
        "pruned",
        "reject_edges",
        "reject_signature",
        "reject_stamp",
        "round_advance",
        "sync_refuse_pruned",
        "sync_request",
        "sync_serve",
        "wave_decided",
        "wave_pending_chain_coin",
        "wave_pending_coin",
        "wave_skip",
        # pipelined waves + eager optimistic delivery
        "eager_deliver",
        "eager_reconciled",
        "eager_mismatch",
        "deadline_adapted",
        # aggregated certificates + cert-of-certs
        "cert_assembled",
        "cert_degraded",
        "cert_reject",
        "cert_timeout",
        "span_assembled",
        "span_reject",
        "span_timeout",
        # node.py lifecycle + checkpointing
        "checkpointed",
        "pump_error",
        "restore_drop_invalid",
        "restored",
        "state_transfer",
        "state_transfer_attempt_failed",
        "state_transfer_failed",
        "state_transferred",
        "stop_drain_error",
        "stop_pump_hung",
        # mempool admission decisions
        "mempool_state",
        "mempool_shed",
        # resilient-verifier ladder transitions
        "verify_retry",
        "verify_fallback",
        "verify_tier_down",
        "verify_tier_recovered",
        "verify_exhausted",
        "verify_window_poisoned",
        "verify_quarantined",
        # dissemination lanes
        "lane_batch",
        "lane_certified",
        "lane_degrade",
        "lane_fetch",
        "lane_restore",
        # transport wire health
        "net_peer_down",
        "net_peer_recovered",
        # cluster harness: crash-recovery lifecycle
        "checkpoint_corrupt",
        "cluster_reinject",
        # obs/ causal tracing: sampled transaction
        # lifecycle stamps + per-cycle phase spans
        "tx_submit",
        "tx_batch",
        "tx_propose",
        "tx_deliver",
        "phase_pump",
        "phase_verify",
        "phase_cert",
        # flight-recorder triggers + bookkeeping
        "invariant_violation",
        "flight_dump",
        # epoch reconfiguration
        "epoch_scheduled",
        "epoch_advanced",
        "epoch_stale",
        "snapshot_attested",
        "snapshot_attest_reject",
    }
)


class EventLog:
    """Named events + bound context, fanned into one sink.

    ``names`` (optional) is an event-name filter: when set, events not
    in the set return after ONE frozenset membership test — no record
    build, no clock read, no sink call. The obs tracing bundle uses it
    to keep per-message debug chatter (``admit``/``delivered`` fire once
    per delivered message) off the hot path while the lifecycle/phase/
    transition events it joins on are recorded; ``names=None`` (the
    default, and what :func:`capture` builds) records everything.
    """

    __slots__ = ("sink", "clock", "context", "names")

    def __init__(
        self,
        sink: Optional[Sink] = None,
        *,
        clock: Callable[[], float] = time.time,
        names: Optional[frozenset] = None,
        **context: object,
    ):
        self.sink = sink
        self.clock = clock
        self.names = names
        self.context = context

    def event(self, name: str, **fields: object) -> None:
        if self.sink is None:
            return
        if self.names is not None and name not in self.names:
            return
        rec: Dict[str, object] = {"event": name, "ts": self.clock()}
        rec.update(self.context)
        rec.update(fields)
        self.sink(rec)

    def child(self, **context: object) -> "EventLog":
        """Same sink, clock, and name filter, extended context (e.g.
        per-process index)."""
        merged = dict(self.context)
        merged.update(context)
        return EventLog(
            self.sink, clock=self.clock, names=self.names, **merged
        )

    @property
    def enabled(self) -> bool:
        return self.sink is not None

    def wants(self, name: str) -> bool:
        """Would an event of this name actually be recorded? Hot loops
        emitting per-message events cache this to skip even the call
        (kwargs packing alone is measurable at consensus pump rates)."""
        return self.sink is not None and (
            self.names is None or name in self.names
        )


#: Shared disabled logger — the default for every component.
NOOP = EventLog()


def capture(clock: Callable[[], float] = time.time) -> tuple:
    """(log, records): an EventLog whose events append to ``records``."""
    records: List[Dict[str, object]] = []
    return EventLog(records.append, clock=clock), records


def tee(*sinks: Optional[Sink]) -> Sink:
    """Fan one event stream into several sinks (None entries skipped) —
    how a trace ring, a flight-recorder trigger watch, and a stdlib
    bridge share the same EventLog."""
    live = [s for s in sinks if s is not None]

    def sink(rec: Dict[str, object]) -> None:
        for s in live:
            s(rec)

    return sink


def stdlib_sink(
    logger: Optional[logging.Logger] = None, level: int = logging.DEBUG
) -> Sink:
    """Bridge into stdlib logging: one JSON line per event."""
    lg = logger if logger is not None else logging.getLogger("dag_rider_tpu_torch")

    def sink(rec: Dict[str, object]) -> None:
        if lg.isEnabledFor(level):  # skip the JSON encode when filtered
            lg.log(level, "%s", json.dumps(rec, default=repr, sort_keys=True))

    return sink
