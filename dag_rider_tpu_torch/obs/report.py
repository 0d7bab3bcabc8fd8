"""Latency attribution: decompose submit→deliver into phases.

The port's copy of ``dag_rider_tpu/obs/report.py``.

The sampled lifecycle stamps chain through two join keys:

    tx_submit  {tx}                 client payload enters the mempool
    tx_batch   {tx, block}          payload packed into a built block
    tx_propose {block, round, source}   block rides a proposed vertex
    tx_deliver {round, source}      that vertex reaches the total order

``tx`` is the payload crc32, ``block`` the encoded-block crc32, and
``(round, source)`` uniquely names a vertex in the DAG — so a complete
chain decomposes a transaction's submit→deliver latency into three
stages that sum EXACTLY (every stamp shares one EventLog clock):

    mempool_queue  = batch.ts   - submit.ts    (admission + batcher hold)
    propose_stage  = propose.ts - batch.ts     (blocks_to_propose wait)
    wave_commit    = deliver.ts - propose.ts   (RBC + DAG + wave lag)

The wave_commit window is then *attributed* across the host phase
spans (phase_pump / phase_verify / phase_cert occupancy over the run's
wall span); the unattributed remainder is transport/wait — wave
structure itself, not host work.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

PERCENTILES = (50.0, 90.0, 99.0)


def _percentile_index(count: int, q: float) -> int:
    """Nearest-rank index into a sorted sequence of ``count`` items."""
    if count <= 0:
        raise ValueError("no samples")
    rank = max(1, int(round(q / 100.0 * count + 0.5)))
    return min(rank, count) - 1


def chains(events: Sequence[Dict[str, object]]) -> List[Dict[str, float]]:
    """Join lifecycle stamps into complete per-transaction chains."""
    submit: Dict[object, float] = {}
    batch: Dict[object, tuple] = {}  # tx -> (block, ts)
    propose: Dict[object, tuple] = {}  # block -> ((round, source), ts)
    deliver: Dict[tuple, float] = {}  # (round, source) -> ts
    for e in events:
        name, ts = e.get("event"), e.get("ts")
        if not isinstance(ts, (int, float)):
            continue
        if name == "tx_submit":
            submit[e.get("tx")] = float(ts)
        elif name == "tx_batch":
            batch[e.get("tx")] = (e.get("block"), float(ts))
        elif name == "tx_propose":
            propose[e.get("block")] = (
                (e.get("round"), e.get("source")),
                float(ts),
            )
        elif name == "tx_deliver":
            deliver[(e.get("round"), e.get("source"))] = float(ts)
    out: List[Dict[str, float]] = []
    for tx, t_submit in submit.items():
        if tx not in batch:
            continue
        blk, t_batch = batch[tx]
        if blk not in propose:
            continue
        vertex, t_propose = propose[blk]
        if vertex not in deliver:
            continue
        t_deliver = deliver[vertex]
        out.append(
            {
                "total_s": t_deliver - t_submit,
                "mempool_queue_s": t_batch - t_submit,
                "propose_stage_s": t_propose - t_batch,
                "wave_commit_s": t_deliver - t_propose,
            }
        )
    return out


def phase_occupancy(events: Sequence[Dict[str, object]]) -> Dict[str, float]:
    """Total busy seconds per host phase + the run's wall span."""
    sums = {"phase_pump": 0.0, "phase_verify": 0.0, "phase_cert": 0.0}
    lo: Optional[float] = None
    hi: Optional[float] = None
    for e in events:
        ts = e.get("ts")
        if not isinstance(ts, (int, float)):
            continue
        lo = float(ts) if lo is None else min(lo, float(ts))
        hi = float(ts) if hi is None else max(hi, float(ts))
        name = e.get("event")
        dur = e.get("dur_s")
        if name in sums and isinstance(dur, (int, float)):
            sums[name] += float(dur)
    return {
        "pump_s": sums["phase_pump"],
        "verify_s": sums["phase_verify"],
        "cert_s": sums["phase_cert"],
        "wall_s": (hi - lo) if lo is not None and hi is not None else 0.0,
    }


def decompose(events: Sequence[Dict[str, object]]) -> Dict[str, object]:
    """The full latency-attribution report over one event stream."""
    chain = chains(events)
    occ = phase_occupancy(events)
    report: Dict[str, object] = {
        "txs": len(chain),
        "phase_occupancy": occ,
        "percentiles": {},
    }
    if not chain:
        return report
    chain.sort(key=lambda c: c["total_s"])
    wall = occ["wall_s"]
    # host-phase share of any wall-clock interval (capped at 1: phases
    # are per-process, the wall span is global)
    shares = {
        k: min(1.0, occ[f"{k}_s"] / wall) if wall > 0 else 0.0
        for k in ("pump", "verify", "cert")
    }
    host_share = min(1.0, sum(shares.values()))
    pcts: Dict[str, object] = {}
    for q in PERCENTILES:
        c = chain[_percentile_index(len(chain), q)]
        wave = c["wave_commit_s"]
        row = dict(c)
        row["wave_host_pump_s"] = wave * shares["pump"]
        row["wave_verify_s"] = wave * shares["verify"]
        row["wave_cert_s"] = wave * shares["cert"]
        row["wave_transport_wait_s"] = wave * (1.0 - host_share)
        pcts[f"p{int(q)}"] = row
    report["percentiles"] = pcts
    return report


def format_report(report: Dict[str, object]) -> str:
    """Human table for the CLI."""
    lines: List[str] = []
    occ = report.get("phase_occupancy") or {}
    lines.append(
        "phase occupancy: pump {pump_s:.3f}s  verify {verify_s:.3f}s  "
        "cert {cert_s:.3f}s  over {wall_s:.3f}s wall".format(
            **{k: float(occ.get(k, 0.0)) for k in
               ("pump_s", "verify_s", "cert_s", "wall_s")}
        )
    )
    lines.append(f"complete submit→deliver chains: {report.get('txs', 0)}")
    pcts = report.get("percentiles") or {}
    if pcts:
        cols = (
            "total_s",
            "mempool_queue_s",
            "propose_stage_s",
            "wave_commit_s",
            "wave_host_pump_s",
            "wave_verify_s",
            "wave_cert_s",
            "wave_transport_wait_s",
        )
        header = "pct     " + "".join(f"{c[:-2]:>21}" for c in cols)
        lines.append(header)
        for name in sorted(pcts, key=lambda p: float(p[1:])):
            row = pcts[name]
            lines.append(
                f"{name:<8}"
                + "".join(f"{float(row.get(c, 0.0)):>21.4f}" for c in cols)
            )
    return "\n".join(lines)
