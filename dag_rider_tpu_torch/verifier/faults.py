"""Verifier chaos harness — seeded fault injection at every verify seam.

The port's copy of ``dag_rider_tpu/verifier/faults.py``; the
``_prep_block`` shadow takes the port's signature (no ``comb`` flag).

transport/faults.py proves delivery faults (drop/delay/duplicate/
equivocate) against the consensus layer; this module does the same for
the VERIFY stack, so the resilience machinery (containment in
VerifierPipeline/CUDAVerifier, the ResilientVerifier ladder, RemoteVerifier
retry) is tested against the faults it claims to absorb rather than
only on the clean path:

- **prep_raise** — `_prep_block` raises mid-fill: with one worker it
  surfaces from `prep_batch` (pipeline containment); with a pool the
  PrepEngine's serial retry absorbs it first (block-pool boundary).
- **dispatch_raise** — `dispatch_prepped` raises before shipping: the
  failing chunk never enters the window (containment, failed_first off).
- **resolve_raise** — `resolve_batch` raises: the oldest in-flight chunk
  is the poisoned one (containment, failed_first on).
- **rpc_error** — `RemoteVerifier._invoke` raises
  :class:`VerifierUnavailableError`: retry/reconnect, then the ladder.
  (ping() routes through _invoke too, so an armed sidecar also reads as
  unhealthy to the ladder's probe until the budget clears.)

Injection rides the placement hooks: arming shadows the seam
methods as INSTANCE attributes, which win at every internal call site
(`self._prep_block(...)`, `self.resolve_batch(...)`,
`self.verifier.dispatch_prepped(...)`) of a CUDAVerifier; disarm() pops
the shadows and the class path is back, byte-identical. Faults are
seeded (`VerifierFaultPlan.seed`) and optionally budgeted
(`max_faults`): a finite budget is the deterministic way to model "the
fault clears", which the chaos tests use to prove no valid vertex stays
rejected once it does. With a
worker pool, WHICH prep block rolls first depends on thread timing —
deterministic chaos tests pin ``prep_workers=1`` or rely on the budget,
not the roll order.
"""

from __future__ import annotations

import dataclasses
import random
import threading
from typing import Optional

from dag_rider_tpu_torch.verifier.base import VerifierUnavailableError


class VerifierFault(RuntimeError):
    """An injected verify-stack fault (chaos harness, never production)."""


@dataclasses.dataclass
class VerifierFaultPlan:
    """Per-seam fault probabilities in [0, 1], seeded like
    transport/faults.py's FaultPlan. ``max_faults`` bounds the TOTAL
    number of injected faults across all seams (None = unbounded): once
    spent, every seam behaves cleanly — "the fault clears"."""

    prep_raise: float = 0.0
    dispatch_raise: float = 0.0
    resolve_raise: float = 0.0
    rpc_error: float = 0.0
    max_faults: Optional[int] = None
    seed: int = 0


class VerifierFaultInjector:
    """Arms a VerifierFaultPlan onto live verifier objects.

    One injector = one seeded roll sequence + one fault budget, shared
    by every seam it arms (a ladder test arms the same injector on the
    sidecar AND the local tier so the budget spans both). ``stats``
    counts injected faults per seam, mirroring FaultyTransport.stats.
    """

    def __init__(self, plan: VerifierFaultPlan):
        self.plan = plan
        self._rng = random.Random(plan.seed)
        self._lock = threading.Lock()
        self.stats = {
            "prep_raise": 0,
            "dispatch_raise": 0,
            "resolve_raise": 0,
            "rpc_error": 0,
        }
        self.faults_injected = 0
        self._armed: list = []  # (obj, attr) instance shadows to pop

    def exhausted(self) -> bool:
        """True once the fault budget is spent — the plan's seams are
        clean from here on."""
        with self._lock:
            return (
                self.plan.max_faults is not None
                and self.faults_injected >= self.plan.max_faults
            )

    def _fire(self, kind: str, p: float) -> bool:
        """One seeded roll for one seam crossing. Locked: prep blocks
        may roll from pool threads, and the budget must never over-
        spend."""
        if p <= 0.0:
            return False
        with self._lock:
            if (
                self.plan.max_faults is not None
                and self.faults_injected >= self.plan.max_faults
            ):
                return False
            if self._rng.random() >= p:
                return False
            self.faults_injected += 1
            self.stats[kind] += 1
            return True

    # -- arming -----------------------------------------------------------

    def arm(self, verifier) -> None:
        """Shadow the prep/dispatch/resolve seams of a CUDAVerifier (or
        subclass) with fault-rolling wrappers. Idempotent per verifier
        per injector; disarm() restores the class methods."""
        plan = self.plan

        orig_prep = verifier._prep_block

        def prep_block(vertices, lo, hi, dest):
            if self._fire("prep_raise", plan.prep_raise):
                raise VerifierFault(f"injected prep fault at rows {lo}:{hi}")
            return orig_prep(vertices, lo, hi, dest)

        verifier._prep_block = prep_block
        self._armed.append((verifier, "_prep_block"))

        orig_dispatch = verifier.dispatch_prepped

        def dispatch_prepped(prepped):
            if self._fire("dispatch_raise", plan.dispatch_raise):
                raise VerifierFault("injected dispatch fault")
            return orig_dispatch(prepped)

        verifier.dispatch_prepped = dispatch_prepped
        self._armed.append((verifier, "dispatch_prepped"))

        orig_resolve = verifier.resolve_batch

        def resolve_batch(pending):
            if self._fire("resolve_raise", plan.resolve_raise):
                raise VerifierFault("injected resolve fault")
            return orig_resolve(pending)

        verifier.resolve_batch = resolve_batch
        self._armed.append((verifier, "resolve_batch"))

    def arm_remote(self, remote) -> None:
        """Shadow RemoteVerifier._invoke so an attempt fails as a
        transport error (VerifierUnavailableError — exactly what a dead
        or unreachable sidecar produces after gRPC mapping) without
        needing to kill a real server per roll."""
        plan = self.plan
        orig_invoke = remote._invoke

        def invoke(payload):
            if self._fire("rpc_error", plan.rpc_error):
                raise VerifierUnavailableError("injected sidecar RPC fault")
            return orig_invoke(payload)

        remote._invoke = invoke
        self._armed.append((remote, "_invoke"))

    def disarm(self) -> None:
        """Pop every instance shadow this injector installed; the class
        methods are reachable again and the seams are byte-identical to
        never having been armed."""
        for obj, attr in self._armed:
            obj.__dict__.pop(attr, None)
        self._armed.clear()
