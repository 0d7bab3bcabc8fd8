"""The program's own spans over a traced window.

``dag_rider_tpu_torch.obs.spans`` books every span of the verify path
whose work was caused while the profiler recorded into its process-wide
``TRACED`` book, whichever thread ran it (the prep engine's seam thread
too). The harness records only the window, and a run is one process, so
that book holds the window's spans. Where the program has no such book,
as before the spans were added, every reading here is None.
"""

from __future__ import annotations

import sys
from typing import Optional, Tuple

MODULE = "dag_rider_tpu_torch.obs.spans"


def traced(name: str) -> Optional[Tuple[float, int]]:
    """(seconds, count) of span ``name`` booked under the profiler, or None
    when the program has no span book or booked no such span."""
    mod = sys.modules.get(MODULE)
    if mod is None:
        return None
    got = mod.TRACED.totals().get(name)
    return got if got is not None and got[1] > 0 else None


def us_per_sig(ctx, *names: str) -> Optional[float]:
    """Microseconds a prepared signature of the window in spans ``names``."""
    got = [traced(n) for n in names]
    sigs = ctx.delta["prepared_sigs"]
    if any(g is None for g in got) or sigs <= 0:
        return None
    return 1e6 * sum(s for s, _ in got) / sigs


def ms_per_dispatch(ctx, name: str) -> Optional[float]:
    """Milliseconds a dispatch of the window in span ``name``, over the
    count of the program's dispatch span."""
    got, dispatches = traced(name), traced("dagrider.verify.dispatch")
    if got is None or dispatches is None:
        return None
    return 1e3 * got[0] / dispatches[1]
