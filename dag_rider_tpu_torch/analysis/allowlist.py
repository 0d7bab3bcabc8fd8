"""The driderlint allowlist: every entry is a triaged, justified
exception. An entry that stops matching anything FAILS the run (see
core.apply_allowlist) — excuses don't outlive their violations.

It is empty: the port's package and ``chip_smoke.py`` are clean, and
the package itself never takes an entry (a finding there is fixed at the
source, as ``EventLog``'s injected clock fixed slog's event stamp).
"""

from __future__ import annotations

from typing import List

from dag_rider_tpu_torch.analysis.core import Allow

ALLOWS: List[Allow] = []
