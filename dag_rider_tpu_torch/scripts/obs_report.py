"""Latency-attribution CLI over trace rings and flight dumps.

Four modes, all joining on the obs event schema:

    python -m dag_rider_tpu_torch.scripts.obs_report report trace.json
        Per-percentile submit->deliver decomposition (mempool queue /
        propose stage / wave commit, with the wave split into host-pump
        / verify / cert / transport-wait by phase-span occupancy).

    python -m dag_rider_tpu_torch.scripts.obs_report chrome trace.json out.json
        Chrome Trace Event Format (chrome://tracing, Perfetto).

    python -m dag_rider_tpu_torch.scripts.obs_report flight dump.json
        Summarize one flight-recorder dump: trigger, metrics snapshot
        keys, event mix of the last-N ring.

    python -m dag_rider_tpu_torch.scripts.obs_report capture \
        --out t.json
        Run a small traced mempool-fronted simulation and report on the
        captured ring (the CI smoke: proves the whole capture ->
        export -> decompose path end to end).

Accepts raw event lists, flight dumps, and chrome traces produced by
this package interchangeably (``obs.export.load_events`` sniffs the
container shape). A copy of the repository's ``scripts/obs_report.py``
over the port's package.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional


def _cmd_report(args: argparse.Namespace) -> int:
    from dag_rider_tpu_torch.obs import export, report

    events = export.load_events(args.path)
    rep = report.decompose(events)
    print(report.format_report(rep))
    if args.json:
        print(json.dumps(rep, indent=2, default=repr))
    return 0


def _cmd_chrome(args: argparse.Namespace) -> int:
    from dag_rider_tpu_torch.obs import export

    events = export.load_events(args.path)
    export.write_chrome_trace(events, args.out)
    print(f"{len(events)} events -> {args.out}")
    return 0


def _cmd_flight(args: argparse.Namespace) -> int:
    from dag_rider_tpu_torch.obs import export

    dump = export.load_flight(args.path)
    if dump is None:
        print(f"{args.path}: not a flight dump", file=sys.stderr)
        return 1
    events = dump.get("events", [])
    mix: dict = {}
    for rec in events:
        name = rec.get("event", "?")
        mix[name] = mix.get(name, 0) + 1
    print(f"reason:  {dump.get('reason')}")
    print(f"trigger: {dump.get('trigger')}")
    print(f"events:  {len(events)} retained, {dump.get('dropped')} dropped")
    for name in sorted(mix, key=mix.get, reverse=True):
        print(f"  {name:24s} {mix[name]}")
    metrics = dump.get("metrics", {})
    for src in sorted(metrics):
        counters = metrics[src].get("counters", metrics[src])
        nonzero = sum(1 for v in counters.values() if v)
        print(f"metrics[{src}]: {nonzero} nonzero counters")
    return 0


def _cmd_capture(args: argparse.Namespace) -> int:
    # force the knob on for this process: the whole point of the smoke
    # is exercising the knob-gated auto-wiring inside Simulation
    from dag_rider_tpu_torch.config import env_set

    env_set("DAGRIDER_TRACE", "1")
    from dag_rider_tpu_torch.config import Config, MempoolConfig
    from dag_rider_tpu_torch.consensus.simulator import Simulation
    from dag_rider_tpu_torch.mempool.loadgen import ClusterLoadDriver, LoadGenerator
    from dag_rider_tpu_torch.obs import report

    sim = Simulation(
        Config(
            n=args.n,
            propose_empty=True,
            sync_request_cooldown_s=0.0,
            sync_serve_cooldown_s=0.0,
        )
    )
    assert sim.recorder is not None, "DAGRIDER_TRACE wiring failed"
    gen = LoadGenerator(
        clients=4, rate=args.rate, tx_bytes=32, seed=args.seed
    )
    drv = ClusterLoadDriver(
        sim,
        gen,
        mcfg=MempoolConfig(cap=4096, batch_bytes=1024),
        wall=True,
    )
    entry = drv.run(args.seconds, drain_s=max(10.0, args.seconds))
    events = sim.recorder.events()
    if args.out:
        sim.recorder.write_json(args.out)
        print(f"{len(events)} events -> {args.out}")
    rep = report.decompose(events)
    print(report.format_report(rep))
    print(
        f"committed {entry['committed_tx']}/{entry['offered_tx']} tx, "
        f"ring dropped {sim.recorder.dropped}"
    )
    if not rep["txs"]:
        print("capture produced no complete chains", file=sys.stderr)
        return 1
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="trace ring / flight dump latency attribution"
    )
    sub = ap.add_subparsers(dest="mode", required=True)

    p = sub.add_parser("report", help="latency-attribution table")
    p.add_argument("path")
    p.add_argument("--json", action="store_true", help="also dump JSON")
    p.set_defaults(fn=_cmd_report)

    p = sub.add_parser("chrome", help="export Chrome Trace Event JSON")
    p.add_argument("path")
    p.add_argument("out")
    p.set_defaults(fn=_cmd_chrome)

    p = sub.add_parser("flight", help="summarize a flight dump")
    p.add_argument("path")
    p.set_defaults(fn=_cmd_flight)

    p = sub.add_parser("capture", help="run a small traced sim + report")
    p.add_argument("--n", type=int, default=4)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--rate", type=float, default=400.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="")
    p.set_defaults(fn=_cmd_capture)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
