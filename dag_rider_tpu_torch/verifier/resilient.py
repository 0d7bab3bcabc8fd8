"""Degradation ladder over an ordered chain of verifier backends.

DAG-Rider's value proposition is progress under asynchrony and faults.
Without a ladder the verify hot path dies on the first transient: a
device or sidecar blip fail-closes a whole batch with no retry and no
fallback, permanently rejecting valid vertices from the DAG.
:class:`ResilientVerifier` makes component failure a first-class input
(the Fides line of work, arXiv:2501.01062). In the port the device tier is
the shared ``CUDAVerifier`` or ``ShardedCUDAVerifier`` and the floor is
``CPUVerifier``:

- **ladder** — an ordered chain of tiers, e.g. card/sharded -> CPU
  reference. Each call starts at the highest
  healthy tier; an attempt that raises is retried with exponential
  backoff + seeded jitter, and when a tier's attempts are exhausted the
  call falls to the next tier.
- **fail-closed per attempt, reject only at exhaustion** — no attempt
  ever admits a vertex it could not check, but a batch
  reads all-False only after the WHOLE ladder failed. A sidecar blip
  therefore costs latency, not valid vertices.
- **health probes + promotion** — a tier marked down is probed in a
  background thread (``ping()`` when the tier has one — RemoteVerifier
  does — else a zero-cost empty verify); the first successful probe
  promotes the tier back, so recovery is automatic and the ladder does
  not stay pinned to its floor forever.
- **quarantine wiring** — tiers exposing a ``quarantine_verifier`` slot
  (VerifierPipeline, CUDAVerifier) get their NEXT tier wired into it, so
  a chunk a poisoned pipeline window quarantines is re-verified once on
  the ladder's next tier instead of serially on the tier that just
  failed.

The mask stays a pure function of (vertex bytes, registry): every tier
computes byte-identical accept bits, so WHICH tier answered is
observable only in the gauges (``verify_fallback_tier`` et al.), never
in the commit order.

Knobs: ``DAGRIDER_VERIFY_RETRY`` (attempts per tier - 1, default 1) and
``DAGRIDER_VERIFY_FALLBACK`` ("cpu" to ladder a node's device/remote
verifiers onto a CPUVerifier floor; default off; read by
:func:`default_verify_fallback`, whose caller is the node builder).
"""

from __future__ import annotations

import random
import threading
import time
from typing import List, Optional, Sequence

from dag_rider_tpu_torch import config
from dag_rider_tpu_torch.core.types import Vertex
from dag_rider_tpu_torch.utils.slog import NOOP, EventLog
from dag_rider_tpu_torch.verifier.base import Verifier


def default_verify_retry() -> int:
    """Bounded retry count per ladder tier: DAGRIDER_VERIFY_RETRY,
    default 1 (one re-attempt before falling a tier)."""
    return config.env_int("DAGRIDER_VERIFY_RETRY")


def default_verify_fallback() -> str:
    """Fallback-tier selector for node.py: DAGRIDER_VERIFY_FALLBACK,
    default "" (no ladder: the single-backend shape).
    "cpu" appends a CPUVerifier floor under the configured verifier."""
    val = config.env_str("DAGRIDER_VERIFY_FALLBACK").lower()
    if val in ("", "0", "off", "none", "false"):
        return ""
    if val != "cpu":
        raise ValueError(
            f"DAGRIDER_VERIFY_FALLBACK must be 'cpu' or off, got {val!r}"
        )
    return val


class ResilientVerifier(Verifier):
    """Ordered verifier chain with retry, fallback, and recovery.

    ``tiers[0]`` is the preferred backend, ``tiers[-1]`` the trusted
    floor. Tiers carrying a ``raise_on_unavailable`` flag
    (RemoteVerifier) have it forced on: the ladder must see transport
    failure as an exception, not as an all-False mask it would apply as
    a verdict.
    """

    def __init__(
        self,
        tiers: Sequence[Verifier],
        *,
        retries: Optional[int] = None,
        backoff_s: float = 0.05,
        backoff_cap_s: float = 1.0,
        jitter: float = 0.5,
        seed: int = 0,
        probe_interval_s: float = 0.5,
        log: EventLog = NOOP,
    ):
        if not tiers:
            raise ValueError("ResilientVerifier needs at least one tier")
        self.tiers = list(tiers)
        #: obs seam: tier transitions that previously only
        #: bumped gauges now emit typed events; verify_exhausted is a
        #: flight-recorder trigger
        self.log = log
        self.retries = (
            default_verify_retry() if retries is None else max(0, int(retries))
        )
        self._backoff_s = float(backoff_s)
        self._backoff_cap_s = float(backoff_cap_s)
        self._jitter = float(jitter)
        self._rng = random.Random(seed)
        self.probe_interval_s = float(probe_interval_s)
        self._lock = threading.Lock()
        self._down = [False] * len(self.tiers)
        self._probing: set = set()
        #: gauges — cumulative over the ladder's lifetime
        self.retries_total = 0
        self.fallbacks_total = 0
        self.exhausted_total = 0  # batches rejected by the WHOLE ladder
        self.last_tier = 0
        #: optional CertVerifier: the aggregated-certificate
        #: check is a rung ABOVE this ladder — a bad certificate degrades
        #: the round back onto the per-vertex tiers below (the Process
        #: owns that transition); wiring the CertVerifier here folds its
        #: accept/reject gauges into the same resilience bundle.
        self.cert_verifier = None
        # a poisoned pipeline window re-verifies its quarantined chunk on
        # the ladder's NEXT tier (see module docstring)
        for i, tier in enumerate(self.tiers):
            if hasattr(tier, "raise_on_unavailable"):
                tier.raise_on_unavailable = True
            if hasattr(tier, "quarantine_verifier") and i + 1 < len(
                self.tiers
            ):
                tier.quarantine_verifier = self.tiers[i + 1]

    # -- health tracking --------------------------------------------------

    def tier_health(self) -> List[bool]:
        with self._lock:
            return [not d for d in self._down]

    def _mark_down(self, idx: int) -> None:
        self.log.event("verify_tier_down", tier=idx)
        with self._lock:
            self._down[idx] = True
            if idx in self._probing:
                return
            self._probing.add(idx)
        t = threading.Thread(
            target=self._probe_loop, args=(idx,), daemon=True,
            name=f"dagrider-verify-probe-{idx}",
        )
        t.start()

    def _probe_once(self, tier) -> bool:
        ping = getattr(tier, "ping", None)
        try:
            if callable(ping):
                return bool(ping())
            return tier.verify_batch([]) == []
        except Exception:  # noqa: BLE001 — a probe failure is the signal
            return False

    def _probe_loop(self, idx: int) -> None:
        """Background recovery watch for one downed tier: probe at a
        fixed cadence, promote back on the first success. RemoteVerifier
        tiers get a reconnect() first so the probe is not answered by a
        subchannel gRPC still holds in connection backoff."""
        tier = self.tiers[idx]
        while True:
            with self._lock:
                if not self._down[idx]:
                    self._probing.discard(idx)
                    return
            time.sleep(self.probe_interval_s)
            if callable(getattr(tier, "reconnect", None)):
                try:
                    tier.reconnect()
                except Exception:  # noqa: BLE001 — retried next cycle
                    continue
            if self._probe_once(tier):
                with self._lock:
                    self._down[idx] = False
                    self._probing.discard(idx)
                self.log.event("verify_tier_recovered", tier=idx)
                return

    # -- ladder mechanics -------------------------------------------------

    def _run(self, call, reject):
        """Walk the ladder: healthy tiers first with bounded retries;
        if every tier is marked down, try them all anyway (a stale down
        mark must not brick the verifier); reject only when the whole
        chain failed this call."""
        order = [
            i for i, healthy in enumerate(self.tier_health()) if healthy
        ] or list(range(len(self.tiers)))
        last_exc: Optional[BaseException] = None
        for pos, idx in enumerate(order):
            tier = self.tiers[idx]
            delay = self._backoff_s
            for attempt in range(self.retries + 1):
                try:
                    out = call(tier)
                except Exception as e:  # noqa: BLE001 — any tier failure
                    # falls through the ladder; validity is never implied
                    last_exc = e
                    if attempt < self.retries:
                        self.retries_total += 1
                        self.log.event(
                            "verify_retry",
                            tier=idx,
                            attempt=attempt + 1,
                            error=repr(e)[:200],
                        )
                        time.sleep(
                            delay
                            * (1.0 + self._jitter * self._rng.random())
                        )
                        delay = min(delay * 2.0, self._backoff_cap_s)
                else:
                    self.last_tier = idx
                    if pos > 0:
                        self.fallbacks_total += 1
                        self.log.event(
                            "verify_fallback", tier=idx, from_tier=order[0]
                        )
                    return out
            self._mark_down(idx)
        # the whole ladder failed: fail closed (attempt semantics were
        # preserved throughout — nothing was admitted along the way)
        self.exhausted_total += 1
        self.last_tier = len(self.tiers)
        self.log.event(
            "verify_exhausted",
            tiers=len(self.tiers),
            error=repr(last_exc)[:200] if last_exc is not None else None,
        )
        del last_exc
        return reject

    # -- Verifier interface ----------------------------------------------

    def verify_batch(self, vertices: Sequence[Vertex]) -> List[bool]:
        if not vertices:
            return []
        vs = list(vertices)
        return self._run(
            lambda t: t.verify_batch(vs), [False] * len(vs)
        )

    def verify_rounds(
        self, rounds: Sequence[Sequence[Vertex]]
    ) -> List[List[bool]]:
        rs = [list(r) for r in rounds]
        return self._run(
            lambda t: t.verify_rounds(rs), [[False] * len(r) for r in rs]
        )

    # -- gauges ----------------------------------------------------------

    def resilience_stats(self) -> dict:
        """The resilience gauge bundle (verify_retries / verify_fallback_tier
        / verify_quarantined / sidecar_health) aggregated across tiers —
        surfaced into pipeline stats, the bench's verifier_breakdown and
        the per-process metrics snapshot."""
        retries = self.retries_total
        quarantined = 0
        poisoned = 0
        rejected = 0
        rpc_failures = 0
        sidecar_health = None
        health = self.tier_health()
        for i, tier in enumerate(self.tiers):
            # a pipeline tier already folds its wrapped verifier in
            sub = getattr(tier, "resilience_stats", None)
            if callable(sub):
                s = sub()
                retries += s.get("retries", 0)
                quarantined += s.get("quarantined", 0)
                poisoned += s.get("poisoned_windows", 0)
                rejected += s.get("quarantine_rejected", 0)
            else:
                retries += getattr(tier, "retries_total", 0)
                quarantined += getattr(tier, "quarantined_chunks", 0)
                poisoned += getattr(tier, "poisoned_windows", 0)
                rejected += getattr(tier, "quarantine_rejected", 0)
            rpc = getattr(tier, "rpc_failures", None)
            if rpc is not None:
                rpc_failures += rpc
                if sidecar_health is None:
                    sidecar_health = 1 if health[i] else 0
        out = {
            "retries": retries,
            "fallback_tier": self.last_tier,
            "fallbacks": self.fallbacks_total,
            "poisoned_windows": poisoned,
            "quarantined": quarantined,
            "quarantine_rejected": rejected,
            "exhausted": self.exhausted_total,
            "sidecar_rpc_failures": rpc_failures,
            "sidecar_health": sidecar_health,
            "tier_health": [1 if h else 0 for h in health],
        }
        if self.cert_verifier is not None:
            cs = self.cert_verifier.stats
            out["cert_checks"] = cs["certs_checked"]
            out["cert_invalid"] = cs["certs_invalid"]
            out["cert_verdict_hits"] = cs["verdict_hits"]
        return out
