"""Reusable DAG-Rider protocol invariants (safety + liveness checkers).

The port's copy of ``dag_rider_tpu/consensus/invariants.py``.

Following "Reusable Formal Verification of DAG-based Consensus Protocols"
(arXiv:2407.02167), the paper's correctness properties are encoded ONCE and
asserted under every scenario — clean runs, chaos runs, and the Byzantine
adversary suite (consensus/adversary.py + consensus/scenarios.py) all go
through the same four checkers:

- **agreement** (:func:`check_agreement`): honest commit logs are
  prefix-consistent — compared at *digest* level, so an admitted
  equivocation cannot masquerade as agreement.
- **total order / no-equivocation-commit**
  (:func:`check_commit_uniqueness`): at most one payload per
  (round, source) slot is ever a_delivered, anywhere, and no honest view
  delivers a slot twice.
- **validity / zero loss** (:func:`transaction_audit` +
  :func:`check_zero_loss`): every accepted client transaction is
  delivered or still retained (queued/staged/in-DAG) — never silently
  dropped.
- **bounded liveness** (:func:`check_liveness`): waves keep committing
  while <= f nodes misbehave.

Each property is usable two ways: as a *post-hoc auditor* over recorded
delivery logs (the functions below; ``Simulation.check_agreement``
delegates here) and as an *online assertion hook*
(:class:`InvariantMonitor`, attached to a live ``Simulation`` via
``Simulation.attach_invariant_monitor``) that raises at the exact
delivery that violates safety instead of after the run.

All violations raise :class:`InvariantViolation`, an ``AssertionError``
subclass — existing tests that ``pytest.raises(AssertionError)`` on the
old one-off checks keep passing unchanged.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from dag_rider_tpu_torch.utils.slog import NOOP, EventLog

#: one delivery record: (round, source, payload digest)
Record = Tuple[int, int, bytes]


class InvariantViolation(AssertionError):
    """A checked protocol property does not hold."""


def delivery_records(deliveries: Iterable) -> List[Record]:
    """Project a_delivered vertices onto comparable (round, source,
    digest) records — identity AND content, so equivocations differ."""
    return [(v.id.round, v.id.source, v.digest()) for v in deliveries]


def check_agreement(logs: Dict[int, Sequence[Record]]) -> None:
    """Agreement: every pair of honest logs is prefix-consistent (one may
    lag the other, but the common prefix must match record-for-record).
    All pairs are compared — a lagging view must not mask divergence
    between two others. ``logs`` maps process index -> delivery records;
    the caller chooses the honest subset."""
    idxs = sorted(logs)
    for ai, i in enumerate(idxs):
        for j in idxs[ai + 1 :]:
            a, b = logs[i], logs[j]
            k = min(len(a), len(b))
            if a[:k] != b[:k]:
                diverge = next(x for x in range(k) if a[x] != b[x])
                raise InvariantViolation(
                    f"order divergence between p{i} and p{j} at "
                    f"position {diverge}: {a[diverge]} vs {b[diverge]}"
                )


def check_commit_uniqueness(logs: Dict[int, Sequence[Record]]) -> None:
    """Total order / no-equivocation-commit: across ALL views, at most
    one digest is ever delivered for a (round, source) slot, and within
    one view no slot is delivered twice. Stronger than prefix agreement
    alone: two views that deliver conflicting payloads for a slot at
    *different* log positions pass the pairwise prefix check until both
    logs grow long enough — this check catches the conflict as soon as
    both deliveries exist."""
    committed: Dict[Tuple[int, int], Tuple[int, bytes]] = {}
    for i in sorted(logs):
        seen_slots: set = set()
        for r, s, d in logs[i]:
            slot = (r, s)
            if slot in seen_slots:
                raise InvariantViolation(
                    f"p{i} delivered slot (round={r}, source={s}) twice"
                )
            seen_slots.add(slot)
            prev = committed.get(slot)
            if prev is None:
                committed[slot] = (i, d)
            elif prev[1] != d:
                raise InvariantViolation(
                    f"equivocation committed: slot (round={r}, source={s}) "
                    f"delivered as {prev[1]!r} at p{prev[0]} but {d!r} at p{i}"
                )


def check_rejoin_embedding(
    canonical: Sequence[Record],
    log: Sequence[Record],
    *,
    view: Optional[int] = None,
) -> None:
    """Commit-order agreement for a crash-recovered view.

    A node that died (kill -9), restored from checkpoint, and rejoined
    via snapshot sync does NOT re-deliver: its on-disk log is the
    pre-crash prefix followed by the post-rejoin segment, with a
    legitimate gap covering what the cluster committed while it was dead
    plus what the snapshot import skipped. Prefix comparison is the
    wrong invariant there; the right one is an **order-preserving
    embedding**: every slot the rejoiner delivered that a survivor also
    delivered must carry the same digest AND appear in the same relative
    order. (Slots beyond the canonical view's tail — shutdown skew — are
    exempt here; :func:`check_commit_uniqueness` still cross-checks
    their digests.)"""
    pos: Dict[Tuple[int, int], Tuple[int, bytes]] = {
        (r, s): (k, d) for k, (r, s, d) in enumerate(canonical)
    }
    who = "view" if view is None else f"p{view}"
    last = -1
    for k, (r, s, d) in enumerate(log):
        hit = pos.get((r, s))
        if hit is None:
            continue
        cpos, cd = hit
        if cd != d:
            raise InvariantViolation(
                f"rejoin divergence: {who} delivered slot (round={r}, "
                f"source={s}) as {d!r}, canonical has {cd!r}"
            )
        if cpos <= last:
            raise InvariantViolation(
                f"rejoin order violation: {who} log position {k} maps to "
                f"canonical position {cpos}, not after {last} — the "
                f"recovered segment reorders committed slots"
            )
        last = cpos


def transaction_audit(
    accepted: Iterable[bytes],
    delivered_by_view: Iterable[Iterable[bytes]],
    retained: Iterable[bytes] = (),
) -> dict:
    """Validity / zero-loss books: every accepted transaction must be
    delivered in some honest view or still retained (pending in a pool,
    queued for proposal, or sitting in a DAG vertex) — ``lost`` > 0 is
    a safety bug. ``duplicates`` is the max per-view count of
    transactions delivered more than once (total-order dedup failure).
    Pure accounting — :func:`check_zero_loss` raises on the result."""
    accepted_set = set(accepted)
    delivered: set = set()
    dup_max = 0
    for view in delivered_by_view:
        seen: Dict[bytes, int] = {}
        for tx in view:
            if tx in accepted_set:
                seen[tx] = seen.get(tx, 0) + 1
        delivered.update(seen)
        dup_max = max(dup_max, sum(1 for c in seen.values() if c > 1))
    retained_set = set(retained) & accepted_set
    lost = accepted_set - delivered - retained_set
    return {
        "accepted": len(accepted_set),
        "delivered": len(delivered),
        "in_flight": len(retained_set - delivered),
        "lost": len(lost),
        "duplicates": dup_max,
    }


def check_zero_loss(audit: dict) -> None:
    """Raise unless the :func:`transaction_audit` books balance."""
    if audit.get("lost", 0) > 0:
        raise InvariantViolation(f"accepted transactions lost: {audit}")
    if audit.get("duplicates", 0) > 0:
        raise InvariantViolation(f"duplicate deliveries: {audit}")


def check_liveness(
    decided_waves: Dict[int, int],
    *,
    min_max: int = 1,
    min_each: int = 0,
) -> None:
    """Bounded liveness with <= f misbehaving nodes: the honest cluster
    kept committing waves (``min_max`` for the most advanced honest
    view) and — after partitions heal and held traffic drains — no
    honest view is stuck before ``min_each``."""
    if not decided_waves:
        raise InvariantViolation("liveness check over zero honest views")
    top = max(decided_waves.values())
    if top < min_max:
        raise InvariantViolation(
            f"liveness: max honest decided wave {top} < required {min_max} "
            f"({decided_waves})"
        )
    for i, w in sorted(decided_waves.items()):
        if w < min_each:
            raise InvariantViolation(
                f"liveness: p{i} decided wave {w} < required {min_each} "
                f"({decided_waves})"
            )


class InvariantMonitor:
    """Online safety assertions over a live cluster's a_deliver stream.

    Wrap each honest process's delivery callback (``Simulation.
    attach_invariant_monitor`` does the plumbing) and every delivery is
    checked *as it happens* against:

    - prefix agreement with the canonical log (the union order built
      from the first view to deliver each position),
    - slot uniqueness within the view (no double delivery),
    - no-equivocation-commit across views (one digest per slot, ever).

    Violations raise :class:`InvariantViolation` from inside the
    delivery callback — the pump surfaces it at the exact message that
    broke safety, with the offending vertex in hand, instead of a
    post-mortem diff over full logs."""

    def __init__(
        self,
        n: int,
        exclude: Iterable[int] = (),
        log: EventLog = NOOP,
    ) -> None:
        self.n = n
        self.exclude = frozenset(exclude)
        #: obs seam: an "invariant_violation" event fires just before
        #: each raise — the flight recorder's trigger watch sees it and
        #: dumps the post-mortem even though the exception unwinds past
        #: any in-band handler
        self.log = log
        #: canonical record sequence: position k holds the first record
        #: any honest view delivered at log position k
        self._canon: List[Record] = []
        #: per-view next log position
        self._cursor: Dict[int, int] = {}
        #: slot -> (first view, digest)
        self._committed: Dict[Tuple[int, int], Tuple[int, bytes]] = {}
        self._seen_slots: Dict[int, set] = {}
        self.observed = 0

    def observe(self, view: int, vertex) -> None:
        """One a_delivery at ``view``. Raises on any safety violation."""
        if view in self.exclude:
            return
        rec: Record = (vertex.id.round, vertex.id.source, vertex.digest())
        slot = rec[:2]
        slots = self._seen_slots.setdefault(view, set())
        if slot in slots:
            raise self._violation(
                view,
                "double_delivery",
                f"p{view} delivered slot (round={rec[0]}, "
                f"source={rec[1]}) twice",
            )
        slots.add(slot)
        prev = self._committed.get(slot)
        if prev is None:
            self._committed[slot] = (view, rec[2])
        elif prev[1] != rec[2]:
            raise self._violation(
                view,
                "equivocation_commit",
                f"equivocation committed: slot (round={rec[0]}, "
                f"source={rec[1]}) delivered as {prev[1]!r} at "
                f"p{prev[0]} but {rec[2]!r} at p{view}",
            )
        pos = self._cursor.get(view, 0)
        if pos < len(self._canon):
            if self._canon[pos] != rec:
                raise self._violation(
                    view,
                    "order_divergence",
                    f"order divergence at p{view} position {pos}: "
                    f"{self._canon[pos]} vs {rec}",
                )
        else:
            self._canon.append(rec)
        self._cursor[view] = pos + 1
        self.observed += 1

    def _violation(
        self, view: int, kind: str, detail: str
    ) -> "InvariantViolation":
        self.log.event(
            "invariant_violation", view=view, kind=kind, detail=detail
        )
        return InvariantViolation(detail)

    def wrap(self, view: int, callback: Optional[callable]):
        """Compose the monitor in front of an existing a_deliver
        callback for ``view``."""

        def _deliver(v, _cb=callback, _i=view):
            self.observe(_i, v)
            if _cb is not None:
                _cb(v)

        return _deliver

    def stats(self) -> dict:
        return {
            "observed": self.observed,
            "canonical_len": len(self._canon),
            "slots_committed": len(self._committed),
        }
