"""Count the duplicate commits of the kill -9 rejoin, seed by seed.

Runs the recipe of ``scripts/cluster.py --n 4 --seconds 6 --rate 300
--kill auto`` once a seed: 4 runner processes over UDS, seeded load
through the Submit door, one seeded kill -9 and a rejoin from
checkpoint, then the audit. It runs either the JAX package's harness or
the port's, and prints one JSON line a run and a summary line last, so
the two harnesses can be held side by side on one machine:

    python tests/torch_kill9_loop.py --package dag_rider_tpu --seeds 0-11
    python tests/torch_kill9_loop.py --package dag_rider_tpu_torch --seeds 0-11

Both run on the CPU (``verifier: "cpu"``, as ``build_cluster`` writes the
nodes). The process exits 0 whatever the audits say: it counts, it does
not gate.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import shutil
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one_run(pkg: str, seed: int, n: int, seconds: float, rate: float) -> dict:
    audit = importlib.import_module(f"{pkg}.cluster.audit")
    client = importlib.import_module(f"{pkg}.cluster.client")
    directory = importlib.import_module(f"{pkg}.cluster.directory")
    supervisor = importlib.import_module(f"{pkg}.cluster.supervisor")
    root = tempfile.mkdtemp(prefix="k9-")
    spec = directory.build_cluster(root, n, transport="uds", seed=seed)
    path = os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH")) if p)
    sup = supervisor.ClusterSupervisor(spec, env={"PYTHONPATH": path, "JAX_PLATFORMS": "cpu"})
    load: dict = {}
    t0 = time.perf_counter()
    try:
        sup.start_all()
        if sup.wait_ready(60.0):
            return {"seed": seed, "boot_failed": True}
        loader = threading.Thread(target=lambda: load.update(client.drive_load(
            spec, duration_s=seconds, rate=rate, seed=seed)), daemon=True)
        loader.start()
        executed = sup.run_plan(supervisor.seeded_kill_plan(
            seed, n, kill_at_s=2.0, restart_after_s=1.5))
        loader.join(timeout=seconds + 30.0)
        if any(ev["action"] == "restart" for ev in executed):
            sup.wait_ready(60.0)
        time.sleep(1.5)
    finally:
        sup.stop_all()
    report = audit.audit_cluster(spec, restarted=sup.restart_counts.keys())
    shutil.rmtree(root, ignore_errors=True)
    return {"seed": seed, "ok": report["ok"], "duplicate_tx": report["duplicate_tx"],
            "lost_tx": report["lost_tx"], "accepted": load.get("accepted"),
            "delivered_tx": report["delivered_tx"], "wall_s": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("dag_rider_tpu", "dag_rider_tpu_torch"),
                    required=True)
    ap.add_argument("--seeds", default="0-11", help="first-last, inclusive")
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--rate", type=float, default=300.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    first, _, last = args.seeds.partition("-")
    runs = []
    for seed in range(int(first), int(last or first) + 1):
        runs.append(one_run(args.package, seed, args.n, args.seconds, args.rate))
        print(json.dumps(runs[-1]), flush=True)
    print(json.dumps({"package": args.package, "runs": len(runs),
                      "with_duplicates": sum(bool(r.get("duplicate_tx")) for r in runs),
                      "not_ok": sum(not r.get("ok") for r in runs)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
