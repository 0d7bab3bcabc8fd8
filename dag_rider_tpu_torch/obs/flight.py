"""Flight recorder: every red run leaves a post-mortem artifact.

The port's copy of ``dag_rider_tpu/obs/flight.py``.

A last-N event ring rides the same slog sink tee as the trace
recorder; when a trigger event flows past — an invariant violation,
resilient-ladder exhaustion, or a pump error — the ring plus a metrics
snapshot from every registered source is dumped to disk as one JSON
file that `scripts/obs_report.py` can load. The scenario runner and
chaos harness also call :meth:`dump` explicitly when an audit raises
post-hoc (the violation may surface in a checker, not an event).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from dag_rider_tpu_torch.config import env_int, env_str

#: Event names that auto-dump.
TRIGGERS = frozenset({"invariant_violation", "verify_exhausted", "pump_error"})


class FlightRecorder:
    """Last-N ring + trigger watch + metrics-snapshot dump."""

    def __init__(
        self,
        out_dir: Optional[str] = None,
        *,
        capacity: int = 0,
        clock: Callable[[], float] = time.time,
        triggers: frozenset = TRIGGERS,
        max_dumps: int = 8,
    ):
        if out_dir is None:
            out_dir = env_str("DAGRIDER_FLIGHT_DIR")
        if capacity <= 0:
            capacity = env_int("DAGRIDER_FLIGHT_EVENTS")
        self.out_dir = out_dir
        self.capacity = capacity
        self.clock = clock
        self.triggers = triggers
        self.max_dumps = max_dumps  # a crash loop must not fill the disk
        self._ring: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._total = 0
        self._seq = 0
        self._sources: List[Tuple[str, Callable[[], Dict[str, object]]]] = []
        self.dumps: List[str] = []

    def add_metrics_source(
        self, name: str, snapshot: Callable[[], Dict[str, object]]
    ) -> None:
        """Register a snapshot callable (e.g. a process's
        ``metrics.snapshot``) captured at dump time."""
        self._sources.append((name, snapshot))

    def sink(self, rec: Dict[str, object]) -> None:
        """Slog sink: retain the event; dump when it is a trigger."""
        trigger = rec.get("event") in self.triggers
        with self._lock:
            self._ring.append(rec)
            self._total += 1
        if trigger:
            self.dump(str(rec.get("event")), trigger=rec)

    def dump(
        self,
        reason: str,
        trigger: Optional[Dict[str, object]] = None,
    ) -> Optional[str]:
        """Write the post-mortem JSON; returns its path (None when no
        output directory is configured or the dump budget is spent)."""
        if not self.out_dir:
            return None
        with self._lock:
            if self._seq >= self.max_dumps:
                return None
            seq = self._seq
            self._seq += 1
            events = list(self._ring)
            dropped = max(0, self._total - len(events))
        metrics: Dict[str, Dict[str, object]] = {}
        for name, snap in self._sources:
            try:
                metrics[name] = snap()
            except Exception as e:  # a broken source must not kill the dump
                metrics[name] = {"snapshot_error": repr(e)}
        record = {
            "kind": "flight",
            "reason": reason,
            "ts": self.clock(),
            "trigger": trigger,
            "dropped": dropped,
            "events": events,
            "metrics": metrics,
        }
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, f"flight_{seq:03d}_{reason}.json")
        with open(path, "w") as f:
            json.dump(record, f, default=repr)
        self.dumps.append(path)
        return path
