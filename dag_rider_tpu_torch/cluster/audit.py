"""Post-hoc cluster audit: the paper's invariants over per-node logs.

The in-process suite asserts invariants against live Python objects; a
multi-process run only leaves files behind. This module reconstructs the
same evidence from the on-disk logs — per-node ``delivery.jsonl`` commit
records, the client's ``accepted.jsonl`` ledger, and each node's
``final.json`` retained-state report — and feeds it to the exact same
checkers in :mod:`dag_rider_tpu_torch.consensus.invariants`:

- **agreement** + **commit uniqueness** over (round, source, digest)
  records parsed from every node's delivery log (kill -9 victims
  included: their log is a valid, possibly torn, prefix);
- **zero loss**: accepted ⊆ delivered ∪ retained, where retained is the
  union of clean-shutdown ``final.json`` retained sets;
- **bounded liveness** over the final decided waves;
- **wire latency**: submit→first-delivery percentiles joined on the
  transaction bytes (the client stamps submits, every deliverer stamps
  commits, and the payload itself is the join key — the same
  content-derived identity the trace ids use).

All checks are collected, not fail-fast: one report lists every broken
property, because a torn log that breaks agreement usually breaks
zero-loss too and the overlap is the diagnostic signal.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Optional, Tuple

from dag_rider_tpu_torch.cluster.client import read_accepted
from dag_rider_tpu_torch.cluster.directory import ClusterSpec
from dag_rider_tpu_torch.consensus import invariants
from dag_rider_tpu_torch.utils.metrics import Histogram


def read_delivery_log(path: str) -> List[dict]:
    """Per-node commit records (JSONL; torn final line skipped)."""
    out: List[dict] = []
    try:
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                    if "d" in rec and "r" in rec and "s" in rec:
                        out.append(rec)
                except ValueError:
                    continue  # torn tail
    except OSError:
        pass
    return out


def read_final(path: str) -> Optional[dict]:
    try:
        with open(path) as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None


def _sync_jumped(nf) -> bool:
    """True when the node's event log shows it rebuilt state mid-run —
    a checkpoint restore or a snapshot state transfer. Either skips
    already-committed (or pruned-past) history without replaying the
    on_deliver stream, leaving the same legitimate recovery gap in the
    delivery log as a supervised kill -9 + rejoin; a node that lagged
    hard enough to state-transfer in an otherwise clean run must be
    audited by embedding, not strict prefix agreement."""
    try:
        with open(nf.events_log) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # torn tail
                if rec.get("event") in ("restored", "state_transferred"):
                    return True
    except OSError:
        pass
    return False


def _records(log: List[dict]) -> List[invariants.Record]:
    return [
        (int(rec["r"]), int(rec["s"]), bytes.fromhex(rec["d"]))
        for rec in log
    ]


def flight_dumps(spec: ClusterSpec) -> Dict[int, List[str]]:
    """Flight-recorder dump files per node (non-empty = something
    tripped a trigger watch on that node)."""
    out: Dict[int, List[str]] = {}
    for i, nf in enumerate(spec.nodes):
        try:
            out[i] = sorted(os.listdir(nf.flight_dir))
        except OSError:
            out[i] = []
    return out


def audit_cluster(
    spec: ClusterSpec,
    *,
    restarted: Iterable[int] = (),
    byzantine: Iterable[int] = (),
    min_decided_wave: int = 1,
    require_finals: bool = True,
) -> dict:
    """Full post-hoc audit of a finished (or crashed) cluster run.

    ``restarted`` names the views that were killed and rejoined: their
    logs carry a legitimate recovery gap, so they are checked with
    :func:`~dag_rider_tpu_torch.consensus.invariants.check_rejoin_embedding`
    against the canonical survivor order instead of strict prefix
    agreement. ``byzantine`` views are excluded from honest-order and
    liveness checks entirely (their logs still feed commit-uniqueness —
    an adversary must not get a conflicting digest committed anywhere).

    Returns a report dict; ``report["ok"]`` is True iff every property
    held. ``report["violations"]`` lists each failure as
    ``{"check": name, "detail": str}``.
    """
    restarted = set(restarted)
    byzantine = set(byzantine)
    # Auto-detect rejoiners the caller did not name: any node whose own
    # event log records a checkpoint restore or snapshot state transfer
    # carries a recovery gap, supervised restart or not.
    for i, nf in enumerate(spec.nodes):
        if i not in restarted and _sync_jumped(nf):
            restarted.add(i)
    violations: List[dict] = []

    def _run(name: str, fn, *a, **kw):
        try:
            fn(*a, **kw)
        except invariants.InvariantViolation as e:
            violations.append({"check": name, "detail": str(e)})

    # -- per-node commit logs -----------------------------------------
    dlogs = [read_delivery_log(nf.delivery_log) for nf in spec.nodes]
    logs = {i: _records(log) for i, log in enumerate(dlogs)}
    honest = [i for i in logs if i not in byzantine]
    steady = [i for i in honest if i not in restarted]
    _run(
        "agreement",
        invariants.check_agreement,
        {i: logs[i] for i in steady},
    )
    # canonical order = the most advanced steady honest log (fall back
    # to the longest honest log if every honest node was restarted)
    canon_pool = steady or honest
    canonical = max(
        (logs[i] for i in canon_pool), key=len, default=[]
    )
    for i in sorted(restarted & set(honest)):
        _run(
            f"rejoin_embedding_p{i}",
            invariants.check_rejoin_embedding,
            canonical,
            logs[i],
            view=i,
        )
    _run("commit_uniqueness", invariants.check_commit_uniqueness, logs)

    # -- zero loss of accepted transactions ---------------------------
    # Zero loss is a promise an HONEST node's ack makes; an ack from a
    # Byzantine node guarantees nothing (it may never propose the
    # transaction at all), so the ledger is filtered by accepting node.
    accepted_recs = [
        rec
        for rec in read_accepted(spec.accepted_log)
        if rec.get("node") not in byzantine
    ]
    accepted = [bytes.fromhex(rec["tx"]) for rec in accepted_recs]
    delivered_by_view = [
        [
            bytes.fromhex(hx)
            for rec in dlogs[i]
            for hx in rec.get("tx", ())
        ]
        for i in honest
    ]
    finals = [read_final(nf.final_report) for nf in spec.nodes]
    missing_finals = [i for i, f in enumerate(finals) if f is None]
    if require_finals and missing_finals:
        violations.append(
            {
                "check": "final_reports",
                "detail": f"missing final.json for nodes {missing_finals} "
                "(crashed during shutdown?)",
            }
        )
    retained: set = set()
    for i in honest:
        f = finals[i]
        if f:
            retained.update(bytes.fromhex(hx) for hx in f.get("retained", ()))
    tx_audit = invariants.transaction_audit(
        accepted, delivered_by_view, retained
    )
    _run("zero_loss", invariants.check_zero_loss, tx_audit)

    # -- liveness ------------------------------------------------------
    decided = {
        i: int(f.get("decided_wave", 0) or 0)
        for i, f in enumerate(finals)
        if f is not None and i not in byzantine
    }
    if decided:
        _run(
            "liveness",
            invariants.check_liveness,
            decided,
            min_max=min_decided_wave,
        )
    else:
        violations.append(
            {"check": "liveness", "detail": "no final reports at all"}
        )

    # -- flight recorder (distributed black box) ----------------------
    dumps = flight_dumps(spec)
    dirty = {
        i: fs for i, fs in dumps.items() if fs and i not in byzantine
    }
    if dirty:
        violations.append(
            {
                "check": "flight_dumps",
                "detail": f"flight recorder dumped on nodes {sorted(dirty)}: "
                f"{dirty}",
            }
        )

    # -- wire latency: submit stamp -> first delivery stamp -----------
    first_seen: Dict[bytes, float] = {}
    for log in dlogs:
        for rec in log:
            ts = rec.get("ts")
            if ts is None:
                continue
            for hx in rec.get("tx", ()):
                tx = bytes.fromhex(hx)
                if tx not in first_seen or ts < first_seen[tx]:
                    first_seen[tx] = ts
    lat = Histogram()
    for rec in accepted_recs:
        tx = bytes.fromhex(rec["tx"])
        seen = first_seen.get(tx)
        if seen is not None and seen >= rec["ts"]:
            lat.observe(seen - rec["ts"])

    report = {
        "ok": not violations,
        "violations": violations,
        "nodes": spec.n,
        "rejoined": sorted(restarted),
        "accepted_tx": tx_audit["accepted"],
        "delivered_tx": tx_audit["delivered"],
        "in_flight_tx": tx_audit["in_flight"],
        "lost_tx": tx_audit["lost"],
        "duplicate_tx": tx_audit["duplicates"],
        "decided_waves": decided,
        "log_lengths": {i: len(r) for i, r in logs.items()},
        "missing_finals": missing_finals,
        "flight_dump_files": sum(len(v) for v in dumps.values()),
    }
    if len(lat):
        report["submit_deliver_p50_ms"] = round(1e3 * lat.percentile(50), 3)
        report["submit_deliver_p99_ms"] = round(1e3 * lat.percentile(99), 3)
        report["latency_samples"] = len(lat)
    return report


def commit_prefix_digest(spec: ClusterSpec) -> Dict[int, Tuple[int, str]]:
    """Per-node (length, sha256 hex) of its full commit record sequence —
    the byte-identical-prefix evidence quoted in bench reports."""
    import hashlib

    out: Dict[int, Tuple[int, str]] = {}
    for i, nf in enumerate(spec.nodes):
        h = hashlib.sha256()
        recs = _records(read_delivery_log(nf.delivery_log))
        for r, s, d in recs:
            h.update(f"{r}:{s}:".encode() + d)
        out[i] = (len(recs), h.hexdigest())
    return out
