"""Cluster launcher: N OS processes, real sockets, real kill -9.

One command boots a full DAG-Rider committee as separate processes over
gRPC (UDS by default, TCP with --transport tcp), drives seeded open-loop
load through the wire-level Submit door, injects process-level faults on
a wall-clock plan, stops everything cleanly, and audits the logs:
commit-order agreement, zero lost accepted transactions, liveness, and
an empty distributed flight recorder. Exit code 0 iff the audit is
clean.

A copy of the repository's ``scripts/cluster.py`` over the port's package
(run it from the repository root, or with the package on ``PYTHONPATH``:
the runners are ``python -m dag_rider_tpu_torch.cluster.runner``
processes).

    python -m dag_rider_tpu_torch.scripts.cluster --n 4 --seconds 6 \
        --rate 300 --kill auto            # one seeded kill -9 + rejoin

    python -m dag_rider_tpu_torch.scripts.cluster --n 4 --plan plan.json \
        --adversary equivocate@3          # Byzantine node over sockets

Fault plans are JSON lists of {"t": seconds-from-load-start, "action":
"kill" | "restart" | "term", "node": i}. --kill auto generates a seeded
kill-and-rejoin plan (one victim, never node 0). Env defaults:
DAGRIDER_CLUSTER_TRANSPORT, DAGRIDER_CLUSTER_BOOT_S,
DAGRIDER_CLUSTER_KEEP, DAGRIDER_CLUSTER_OUT (see README knob table).
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import threading

from dag_rider_tpu_torch import config as _cfg
from dag_rider_tpu_torch.cluster import audit as audit_mod
from dag_rider_tpu_torch.cluster import client as client_mod
from dag_rider_tpu_torch.cluster.directory import build_cluster
from dag_rider_tpu_torch.cluster.supervisor import ClusterSupervisor, seeded_kill_plan


def run_cluster(args) -> dict:
    root = args.root or tempfile.mkdtemp(prefix="dagrider-cluster-")
    adversaries = {}
    for spec_str in args.adversary or ():
        kind, _, node = spec_str.partition("@")
        adversaries[int(node)] = {"kind": kind, "seed": args.seed}
    overrides = json.loads(args.node_overrides) if args.node_overrides else None
    wan = json.loads(args.wan) if args.wan else None

    spec = build_cluster(
        root,
        args.n,
        transport=args.transport,
        seed=args.seed,
        cert=args.cert,
        adversaries=adversaries or None,
        wan=wan,
        node_overrides=overrides,
    )

    plan = []
    if args.plan:
        with open(args.plan) as fh:
            plan = json.load(fh)
    elif args.kill == "auto":
        plan = seeded_kill_plan(
            args.seed,
            args.n,
            kill_at_s=args.kill_at,
            restart_after_s=args.restart_after,
        )
    elif args.kill:
        plan = [
            {"t": args.kill_at, "action": "kill", "node": int(args.kill)},
            {
                "t": args.kill_at + args.restart_after,
                "action": "restart",
                "node": int(args.kill),
            },
        ]

    sup = ClusterSupervisor(spec)
    sup.start_all()
    not_ready = sup.wait_ready(args.boot_timeout)
    if not_ready:
        sup.stop_all()
        return {
            "ok": False,
            "violations": [
                {
                    "check": "boot",
                    "detail": f"nodes {not_ready} not ready within "
                    f"{args.boot_timeout}s (see stderr.log)",
                }
            ],
            "root": root,
        }

    load_result: dict = {}

    def _load():
        load_result.update(
            client_mod.drive_load(
                spec,
                duration_s=args.seconds,
                rate=args.rate,
                clients=args.clients,
                seed=args.seed,
                profile=args.profile,
            )
        )

    loader = threading.Thread(target=_load, daemon=True)
    loader.start()
    executed = sup.run_plan(plan)
    loader.join(timeout=args.seconds + 30)

    # rejoiners need to be back before the audit asks for their final
    # report — give any restarted node its boot window
    if any(ev["action"] == "restart" for ev in executed):
        sup.wait_ready(args.boot_timeout)
    if args.settle > 0:
        threading.Event().wait(args.settle)

    forced = sup.stop_all()
    report = audit_mod.audit_cluster(
        spec,
        restarted=sup.restart_counts.keys(),
        byzantine=adversaries.keys(),
    )
    report["root"] = root
    report["load"] = load_result
    report["fault_plan"] = executed
    report["forced_stops"] = forced
    report["kills"] = dict(sup.kill_counts)
    report["restarts"] = dict(sup.restart_counts)
    report["exit_codes"] = {
        str(i): c for i, c in sup.exit_codes().items()
    }
    report["commit_prefixes"] = {
        str(i): {"len": ln, "sha256": hx}
        for i, (ln, hx) in audit_mod.commit_prefix_digest(spec).items()
    }

    keep = args.keep or not report["ok"]
    if not keep and not args.root:
        shutil.rmtree(root, ignore_errors=True)
        report["root"] = "(removed — pass --keep to retain)"
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dag_rider_tpu_torch.scripts.cluster",
        description="multi-process DAG-Rider cluster with fault injection",
    )
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument(
        "--transport",
        choices=("uds", "tcp"),
        default=_cfg.env_choice("DAGRIDER_CLUSTER_TRANSPORT"),
    )
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--rate", type=float, default=300.0)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--profile", default="poisson")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--cert", default="off", choices=("off", "agg"))
    ap.add_argument(
        "--kill",
        default=None,
        help="node index to kill -9 mid-load, or 'auto' for a seeded pick",
    )
    ap.add_argument("--kill-at", type=float, default=2.0)
    ap.add_argument("--restart-after", type=float, default=1.5)
    ap.add_argument("--plan", default=None, help="fault-plan JSON file")
    ap.add_argument(
        "--adversary",
        action="append",
        help="kind@node, e.g. equivocate@3 (repeatable)",
    )
    ap.add_argument("--wan", default=None, help="WanFault config JSON")
    ap.add_argument(
        "--node-overrides", default=None, help="extra node-config JSON"
    )
    ap.add_argument(
        "--settle",
        type=float,
        default=1.5,
        help="post-load quiesce window before shutdown",
    )
    ap.add_argument(
        "--boot-timeout",
        type=float,
        default=_cfg.env_float("DAGRIDER_CLUSTER_BOOT_S"),
    )
    ap.add_argument("--root", default=None, help="workspace dir (kept)")
    ap.add_argument(
        "--keep",
        action="store_true",
        default=_cfg.env_flag("DAGRIDER_CLUSTER_KEEP"),
    )
    ap.add_argument("--out", default=None, help="write report JSON here")
    args = ap.parse_args(argv)

    report = run_cluster(args)
    print(json.dumps(report, indent=1, default=repr))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(report, fh, indent=1, default=repr)
    if not report["ok"]:
        print(
            f"AUDIT FAILED: {[v['check'] for v in report['violations']]}",
            file=sys.stderr,
        )
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
