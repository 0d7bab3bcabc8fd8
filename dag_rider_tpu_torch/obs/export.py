"""Perfetto / Chrome-trace JSON export.

The port's copy of ``dag_rider_tpu/obs/export.py``.

Converts a list of slog event records into the Trace Event Format
(`chrome://tracing`, https://ui.perfetto.dev): events carrying a
``dur_s`` field become complete ("X") spans, everything else an
instant ("i"). pid groups by the ``index``/``node`` context a process
EventLog binds; ts is microseconds relative to the first event so the
viewer opens at t=0.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

#: record keys that map onto trace-event structure, not args
_STRUCTURAL = ("event", "ts", "dur_s", "index", "node")


def _tid(rec: Dict[str, object]) -> int:
    name = str(rec.get("event", ""))
    if name.startswith("phase_"):
        return 1  # phase spans on their own row per process
    return 0


def chrome_trace(events: List[Dict[str, object]]) -> Dict[str, object]:
    stamped = [e for e in events if isinstance(e.get("ts"), (int, float))]

    def _start(e: Dict[str, object]) -> float:
        # span records stamp their END; the viewer baseline must cover
        # the earliest span START or its ts goes negative
        dur = e.get("dur_s")
        if isinstance(dur, (int, float)):
            return float(e["ts"]) - float(dur)
        return float(e["ts"])

    t0 = min((_start(e) for e in stamped), default=0.0)
    out: List[Dict[str, object]] = []
    for rec in stamped:
        pid = rec.get("index", rec.get("node", 0))
        try:
            pid = int(pid)  # type: ignore[arg-type]
        except (TypeError, ValueError):
            pid = 0
        ev: Dict[str, object] = {
            "name": str(rec.get("event", "?")),
            "ph": "i",
            "s": "t",
            "ts": (float(rec["ts"]) - t0) * 1e6,
            "pid": pid,
            "tid": _tid(rec),
            "args": {k: v for k, v in rec.items() if k not in _STRUCTURAL},
        }
        dur = rec.get("dur_s")
        if isinstance(dur, (int, float)):
            # complete span: ts is the START of the phase
            ev["ph"] = "X"
            ev["dur"] = float(dur) * 1e6
            ev["ts"] = (float(rec["ts"]) - float(dur) - t0) * 1e6
            ev.pop("s")
        out.append(ev)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_chrome_trace(events: List[Dict[str, object]], path: str) -> str:
    with open(path, "w") as f:
        json.dump(chrome_trace(events), f, default=repr)
    return path


def load_events(path: str) -> List[Dict[str, object]]:
    """Load obs JSON back into an event list: accepts a raw trace list
    (TraceRecorder.write_json), a flight dump (events live under
    ``"events"``), or a Chrome trace (args re-flattened)."""
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, list):
        return data
    if isinstance(data, dict) and isinstance(data.get("events"), list):
        return data["events"]
    if isinstance(data, dict) and isinstance(data.get("traceEvents"), list):
        out = []
        for ev in data["traceEvents"]:
            rec: Dict[str, object] = {
                "event": ev.get("name"),
                "ts": float(ev.get("ts", 0.0)) / 1e6,
            }
            if "dur" in ev:
                rec["dur_s"] = float(ev["dur"]) / 1e6
                rec["ts"] = float(rec["ts"]) + float(rec["dur_s"])
            rec.update(ev.get("args") or {})
            if "pid" in ev:
                rec.setdefault("index", ev["pid"])
            out.append(rec)
        return out
    raise ValueError(f"unrecognized obs JSON shape in {path}")


def load_flight(path: str) -> Optional[Dict[str, object]]:
    """The full flight record when ``path`` is a flight dump, else
    None."""
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict) and data.get("kind") == "flight":
        return data
    return None
