"""Full-stack soak: the whole framework running as deployed, for minutes.

4-node localhost committee over MAC'd gRPC with Bracha RBC, the
threshold-BLS coin, GC pruning, periodic checkpoints, one node verifying
through a gRPC sidecar, a mid-run crash + checkpoint-restart, and
end-of-run assertions: prefix-consistent delivery, bounded live state,
zero auth rejects / pump errors, bounded RSS high-water growth.

Not a pytest (runtime is minutes); run manually or from CI's slow lane:
    python -m dag_rider_tpu_torch.scripts.soak [seconds]

A copy of the repository's ``scripts/soak.py`` over the port's package:
the sidecar and the nodes verify on the CPU, as there.
"""

from __future__ import annotations

import json
import os
import resource
import sys
import tempfile
import time

from dag_rider_tpu_torch import node as node_mod
from dag_rider_tpu_torch.core.types import Block
from dag_rider_tpu_torch.verifier.cpu import CPUVerifier
from dag_rider_tpu_torch.verifier.sidecar import VerifierSidecarServer


def rss_mb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def main(box_s: float) -> int:
    tmp = tempfile.mkdtemp(prefix="dagrider-soak-")
    keys_path = os.path.join(tmp, "keys.json")
    node_mod.main(
        ["keygen", "--n", "4", "--threshold", "2", "--out", keys_path]
    )
    reg, _, _ = node_mod.load_keys(json.load(open(keys_path)))
    sidecar = VerifierSidecarServer(CPUVerifier(reg), "127.0.0.1:0")

    listen_addrs: dict = {}

    def mk(i):
        cfg = {
            "index": i,
            "n": 4,
            # stable addresses, like a real deployment: a restarted node
            # reappears on the same port and peers' channels reconnect
            "listen": listen_addrs.get(i, "127.0.0.1:0"),
            "peers": {},
            "keys": keys_path,
            "rbc": True,
            "coin": "threshold_bls",
            "propose_empty": True,
            "gc_depth": 16,
            "auth_master": "50" * 32,
            "checkpoint_dir": os.path.join(tmp, f"ckpt{i}"),
            "checkpoint_every_s": 10,
            "submit_interval_s": 0.5,
            # node 3 exercises the sidecar deployment shape; the rest
            # verify in-process
            "verifier": "remote" if i == 3 else "cpu",
            "verifier_address": f"127.0.0.1:{sidecar.bound_port}",
        }
        return node_mod.Node(cfg)

    nodes = {i: mk(i) for i in range(4)}
    addrs = {i: f"127.0.0.1:{nd.net.bound_port}" for i, nd in nodes.items()}
    listen_addrs.update(addrs)
    for i, nd in nodes.items():
        nd.net._peers.update({j: a for j, a in addrs.items() if j != i})
    for nd in nodes.values():
        nd.start()
    for nd in nodes.values():
        nd.submit(Block((b"soak-seed",)))

    t0 = time.monotonic()
    rss0 = rss_mb()
    crashed_at = None
    restarted = False
    report_at = 30.0
    while time.monotonic() - t0 < box_s:
        time.sleep(1.0)
        el = time.monotonic() - t0
        # crash node 2 a third of the way in; restart it from its
        # checkpoint at the halfway mark (elastic recovery, live)
        if crashed_at is None and el > box_s / 3:
            nodes[2].stop()
            crashed_at = el
            print(f"[soak +{el:5.0f}s] node 2 stopped (checkpointed)")
        if crashed_at is not None and not restarted and el > box_s / 2:
            # same stable address: surviving peers' channels reconnect by
            # themselves, and the new node takes its peer table via the
            # supported config path
            nodes[2] = mk(2)
            nodes[2].net._peers.update(
                {j: a for j, a in addrs.items() if j != 2}
            )
            nodes[2].start()
            restarted = True
            print(
                f"[soak +{el:5.0f}s] node 2 restarted from checkpoint "
                f"at round {nodes[2].process.round}"
            )
        if el >= report_at:
            report_at += 30.0
            p0 = nodes[0].process
            print(
                f"[soak +{el:5.0f}s] round={p0.round} base={p0.dag.base_round} "
                f"live={len(p0.dag.vertices)} delivered={len(nodes[0].delivered)} "
                f"rss={rss_mb():.0f}MB"
            )
    for nd in nodes.values():
        nd.stop()
    sidecar.stop()

    # ---- assertions -----------------------------------------------------
    failures = []
    logs = {
        i: [(v.id.round, v.id.source, v.digest()) for v in nd.delivered]
        for i, nd in nodes.items()
    }
    # prefix consistency among the always-up nodes
    up = [logs[i] for i in (0, 1, 3)]
    k = min(len(l) for l in up)
    if not all(l[:k] == up[0][:k] for l in up):
        failures.append("divergent delivery among up nodes")
    # the restarted node's log is order-consistent with node 0's
    pos = {e: i for i, e in enumerate(logs[0])}
    got = [pos[e] for e in logs[2] if e in pos]
    if got != sorted(got):
        failures.append("restarted node delivery order diverged")
    for i, nd in nodes.items():
        snap = nd.process.metrics.snapshot()
        if snap.get("net_auth_rejects"):
            failures.append(f"node {i}: auth rejects {snap['net_auth_rejects']}")
        if snap.get("pump_errors"):
            failures.append(f"node {i}: pump errors {snap['pump_errors']}")
        window = nd.process.dag.max_round - nd.process.dag.base_round + 1
        if len(nd.process.dag.vertices) > 4 * (window + 1):
            failures.append(f"node {i}: live vertices exceed the window")
        if nd.process.dag.base_round == 0 and nd.process.round > 40:
            failures.append(f"node {i}: never pruned")
    # the restarted node actually rejoined the live frontier (its
    # checkpoint was far below the cluster's GC horizon, so this
    # exercised nack-quorum -> snapshot state transfer -> catch-up)
    if nodes[2].process.round < nodes[0].process.round - 60:
        failures.append("restarted node failed to catch up")
    if not nodes[2].process.metrics.counters.get("state_transfers"):
        failures.append("restarted node never state-transferred")
    growth = rss_mb() - rss0
    if growth > 300.0:
        failures.append(f"RSS high-water grew {growth:.0f}MB")
    p0 = nodes[0].process
    print(
        f"[soak] done: round={p0.round} base={p0.dag.base_round} "
        f"delivered={len(nodes[0].delivered)} restarted_round="
        f"{nodes[2].process.round} rss_growth={growth:.0f}MB"
    )
    if failures:
        print("[soak] FAILURES:", failures)
        return 1
    print("[soak] OK: agreement, bounded window, clean metrics, restart recovered")
    return 0


if __name__ == "__main__":
    sys.exit(main(float(sys.argv[1]) if len(sys.argv) > 1 else 480.0))
