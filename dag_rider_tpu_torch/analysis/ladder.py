"""Degradation-ladder totality over the interprocedural flow graph.

Every knob-gated fast path in the repo is paired with a byte-identical
oracle fallback — that pairing is the safety argument for shipping the
fast path at all (vector pump → scalar drain, aggregated certificate →
per-vertex verifies, span → per-round certificates, device MSM/pairing
→ host bigint). The pairing is also invisible to per-function lint: it
lives in the call graph, as an edge from the seam function to the
oracle. A future refactor can strand a fast path — delete the fallback
branch, rename the oracle, orphan the seam — and every test still
passes, because tests pin one knob value at a time.

This checker makes the ladder structure itself a gated invariant.
:data:`LADDERS` declares each rung as (knob, entry seam, fast path,
oracle); the checker proves, on the package flow graph:

* the knob is still a registered config knob (a deleted knob with a
  live ladder entry is a stale declaration — also flagged);
* entry, fast, and oracle functions all still exist;
* BOTH the fast path and the oracle are reachable from the entry seam
  (the degradation edge is intact, not just the fast edge);
* the fast path has at least one caller — a stranded fast path is dead
  weight that silently stops being exercised.

The declarations are deliberately explicit qnames, not discovered: the
point is that a PR deleting a rung must *edit this table* (or fail
tier1-analysis), turning a silent strand into a reviewed decision.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from dag_rider_tpu_torch.analysis import flow
from dag_rider_tpu_torch.analysis.core import Finding, SourceFile

CHECKER = "ladder"

_P = "dag_rider_tpu_torch.consensus.process.Process."
_C = "dag_rider_tpu_torch.verifier.cert.CertVerifier."


@dataclasses.dataclass(frozen=True)
class Ladder:
    """One degradation rung: entry branches on knob between fast and
    oracle (the oracle may BE the entry's own body — pass entry)."""

    knob: str
    entry: str
    fast: str
    oracle: str


#: the shipped ladder table — edit alongside any seam refactor
LADDERS: Tuple[Ladder, ...] = (
    # vector pump: one jnp round-batch drain vs the scalar Python walk
    Ladder(
        "DAGRIDER_PUMP",
        _P + "_drain_buffer",
        _P + "_drain_buffer_vector",
        _P + "_drain_buffer",
    ),
    # aggregated round certificate vs per-vertex verifies (reject path
    # degrades the whole round back to the per-vertex oracle)
    Ladder(
        "DAGRIDER_CERT",
        _P + "_cert_step",
        _P + "_apply_certificate",
        _P + "_degrade_cert_round",
    ),
    # cert-of-certs span vs per-round certificates
    Ladder(
        "DAGRIDER_CERT_SPAN",
        _P + "_cert_step",
        _P + "_apply_span",
        _P + "_apply_certificate",
    ),
    # device MSM vs host bigint sum
    Ladder(
        "DAGRIDER_CERT_MSM",
        _C + "_sum_points",
        "dag_rider_tpu_torch.ops.bls_msm.sum_points",
        "dag_rider_tpu_torch.crypto.bls12381.g1_sum",
    ),
    # sharded (mesh) MSM vs host bigint sum
    Ladder(
        "DAGRIDER_CERT_MSM",
        _C + "_sum_points",
        "dag_rider_tpu_torch.parallel.msm.ShardedMSM.sum_points",
        "dag_rider_tpu_torch.crypto.bls12381.g1_sum",
    ),
    # device pairing product vs host pairing
    Ladder(
        "DAGRIDER_CERT_PAIR",
        _C + "_pairing_check",
        "dag_rider_tpu_torch.ops.bls_pairing.multi_pairing_check",
        "dag_rider_tpu_torch.crypto.bls12381.multi_pairing_check",
    ),
    # pipelined per-round wave attempts vs the 4-round boundary sweep
    Ladder(
        "DAGRIDER_WAVE_PIPELINE",
        _P + "step",
        _P + "_try_waves_pipelined",
        _P + "_try_advance",
    ),
    # eager speculative surface vs the coin-ordered canonical walk (the
    # walk is also the reconciliation oracle for what eager surfaced)
    Ladder(
        "DAGRIDER_EAGER_DELIVER",
        _P + "_try_wave",
        _P + "_eager_surface",
        _P + "_order_vertices",
    ),
    # sharded dissemination lanes vs inline payloads (sub-threshold,
    # magic-aliasing and under-quorum blocks all fall back to inline)
    Ladder(
        "DAGRIDER_LANES",
        _P + "submit",
        _P + "_submit_via_lanes",
        _P + "_submit_inline",
    ),
    # epoch reconfiguration: delivery-time boundary scan vs the static-
    # membership no-op seam (epoch off = fixed validator set forever)
    Ladder(
        "DAGRIDER_EPOCH",
        _P + "_epoch_note_delivery",
        _P + "_epoch_scan_chunk",
        _P + "_epoch_static",
    ),
)


def _short(qn: str) -> str:
    return qn.rsplit(".", 1)[-1]


def check_ladders(
    graph: flow.FlowGraph, ladders: Sequence[Ladder]
) -> List[Finding]:
    from dag_rider_tpu_torch.config import KNOBS

    out: List[Finding] = []

    def fnd(rel: str, line: int, msg: str) -> None:
        out.append(Finding(CHECKER, rel, line, msg))

    for lad in ladders:
        entry = graph.functions.get(lad.entry)
        where = (entry.rel, entry.lineno) if entry else (
            "dag_rider_tpu_torch/analysis/ladder.py",
            0,
        )
        if lad.knob not in KNOBS:
            fnd(
                *where,
                f"ladder {lad.knob}: knob is not registered in "
                "config.KNOBS (stale ladder declaration or deleted knob)",
            )
        missing = [
            q
            for q in (lad.entry, lad.fast, lad.oracle)
            if q not in graph.functions
        ]
        if missing:
            fnd(
                *where,
                f"ladder {lad.knob}: missing function(s) "
                + ", ".join(missing)
                + " — seam renamed or deleted without editing LADDERS",
            )
            continue
        reach = graph.reachable(lad.entry)
        if lad.fast not in reach:
            fnd(
                *where,
                f"ladder {lad.knob}: fast path {_short(lad.fast)} not "
                f"reachable from entry {_short(lad.entry)} — fast edge "
                "severed",
            )
        if lad.oracle not in reach:
            fnd(
                *where,
                f"ladder {lad.knob}: oracle {_short(lad.oracle)} not "
                f"reachable from entry {_short(lad.entry)} — degradation "
                "edge severed; the fast path has no fallback",
            )
        if lad.fast != lad.entry and not graph.callers_of(lad.fast):
            fnd(
                *where,
                f"ladder {lad.knob}: fast path {_short(lad.fast)} has "
                "no callers — stranded fast path",
            )
    return out


def run(
    files: Sequence[SourceFile],
    repo_root: str,
    graph: Optional[flow.FlowGraph] = None,
    ladders: Sequence[Ladder] = LADDERS,
) -> List[Finding]:
    if graph is None:
        graph = flow.build(files)
    return check_ladders(graph, ladders)
