"""Bounded ring-buffer trace recorder.

The port's copy of ``dag_rider_tpu/obs/recorder.py``.

The recorder IS a slog sink: installing tracing means building one
`EventLog` whose sink (possibly tee'd with a flight recorder and a
stdlib bridge) appends here. Capacity follows the metrics module's
bounded-state rule (`SAMPLE_WINDOW`): a long run overwrites its oldest
events instead of growing — `dropped` counts what the window lost.
"""

from __future__ import annotations

import json
import threading
from collections import deque
from typing import Dict, List

from dag_rider_tpu_torch.config import env_int


class TraceRecorder:
    """Thread-safe last-K ring of event records (callable as a Sink)."""

    def __init__(self, capacity: int = 0):
        if capacity <= 0:
            capacity = env_int("DAGRIDER_TRACE_RING")
        self.capacity = capacity
        self._ring: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self.total = 0  # appends ever seen; dropped = total - len(ring)

    def __call__(self, rec: Dict[str, object]) -> None:
        with self._lock:
            self._ring.append(rec)
            self.total += 1

    def events(self) -> List[Dict[str, object]]:
        """Snapshot of the retained window, oldest first."""
        with self._lock:
            return list(self._ring)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    @property
    def dropped(self) -> int:
        with self._lock:
            return max(0, self.total - len(self._ring))

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.total = 0

    def write_json(self, path: str) -> str:
        """Dump the retained window as a JSON list (obs_report input)."""
        with open(path, "w") as f:
            json.dump(self.events(), f, default=repr)
        return path
