"""Cluster workspace layout + peer directory.

One workspace directory per cluster run:

    <root>/
      cluster.json          — the ClusterSpec (addresses, file map)
      keys.json             — dealer committee key material (seeded)
      sock/node<i>.sock     — UDS endpoints (transport="uds")
      node<i>/
        config.json         — runner config (node cfg + harness files)
        ckpt/               — periodic checkpoints
        flight/             — flight-recorder dumps (distributed black box)
        submits.wal         — acknowledged-transaction WAL (hex lines)
        delivery.jsonl      — committed-vertex log (one JSON line each)
        events.jsonl        — structured event log (slog records)
        final.json          — clean-shutdown state report
        ready               — liveness marker (written when serving)
        stdout.log / stderr.log

Addresses are allocated up front — UDS paths under the workspace, or
TCP ports reserved by binding ``127.0.0.1:0`` and recording what the OS
handed out — so every node's config can name every peer before any
process boots (static peer directory; discovery is the file, matching
the dealer-style key distribution).
"""

from __future__ import annotations

import json
import os
import socket
from dataclasses import dataclass, field
from typing import Dict, List, Optional

#: mempool TTL for cluster runs: the default 60 s is tuned for a live
#: simulator; across a kill -9 + restart-from-checkpoint window an
#: accepted-but-expired transaction would audit as LOST, so cluster
#: pools hold entries long past any plausible recovery time.
CLUSTER_MEMPOOL_TTL_S = 600.0


@dataclass
class NodeFiles:
    """Per-node harness file map (all paths absolute)."""

    workdir: str
    config: str
    checkpoint_dir: str
    flight_dir: str
    submits_wal: str
    delivery_log: str
    events_log: str
    final_report: str
    ready_marker: str
    stdout: str
    stderr: str
    delivered_hint: str

    @classmethod
    def for_node(cls, root: str, index: int) -> "NodeFiles":
        wd = os.path.join(root, f"node{index}")
        return cls(
            workdir=wd,
            config=os.path.join(wd, "config.json"),
            checkpoint_dir=os.path.join(wd, "ckpt"),
            flight_dir=os.path.join(wd, "flight"),
            submits_wal=os.path.join(wd, "submits.wal"),
            delivery_log=os.path.join(wd, "delivery.jsonl"),
            events_log=os.path.join(wd, "events.jsonl"),
            final_report=os.path.join(wd, "final.json"),
            ready_marker=os.path.join(wd, "ready"),
            stdout=os.path.join(wd, "stdout.log"),
            stderr=os.path.join(wd, "stderr.log"),
            delivered_hint=os.path.join(wd, "delivered.hint"),
        )


@dataclass
class ClusterSpec:
    """Everything the supervisor, client, and audit need to find a
    running (or finished) cluster on disk."""

    root: str
    n: int
    transport: str  # "uds" | "tcp"
    addresses: List[str]
    seed: int
    nodes: List[NodeFiles] = field(default_factory=list)
    accepted_log: str = ""

    def to_json(self) -> dict:
        return {
            "root": self.root,
            "n": self.n,
            "transport": self.transport,
            "addresses": list(self.addresses),
            "seed": self.seed,
            "accepted_log": self.accepted_log,
            "nodes": [vars(nf) for nf in self.nodes],
        }

    @classmethod
    def from_json(cls, blob: dict) -> "ClusterSpec":
        spec = cls(
            root=blob["root"],
            n=int(blob["n"]),
            transport=blob["transport"],
            addresses=list(blob["addresses"]),
            seed=int(blob["seed"]),
            accepted_log=blob.get("accepted_log", ""),
        )
        spec.nodes = [NodeFiles(**nf) for nf in blob["nodes"]]
        return spec

    @classmethod
    def load(cls, root: str) -> "ClusterSpec":
        with open(os.path.join(root, "cluster.json")) as fh:
            return cls.from_json(json.load(fh))

    def save(self) -> None:
        with open(os.path.join(self.root, "cluster.json"), "w") as fh:
            json.dump(self.to_json(), fh, indent=1)


def allocate_addresses(root: str, n: int, transport: str) -> List[str]:
    """Pre-allocate n peer addresses.

    ``uds``: paths under <root>/sock — collision-free by construction
    and immune to port exhaustion on busy CI hosts. The gRPC address
    form is ``unix:<path>``.
    ``tcp``: reserve ephemeral ports by binding :0 and recording the
    OS's choice. The sockets are closed before the nodes boot — a small
    reuse race, acceptable for a harness (UDS is the CI default).
    """
    if transport == "uds":
        sock_dir = os.path.join(root, "sock")
        os.makedirs(sock_dir, exist_ok=True)
        return [
            f"unix:{os.path.join(sock_dir, f'node{i}.sock')}"
            for i in range(n)
        ]
    if transport != "tcp":
        raise ValueError(f"transport must be 'uds' or 'tcp', got {transport!r}")
    socks, addrs = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        addrs.append(f"127.0.0.1:{s.getsockname()[1]}")
    for s in socks:
        s.close()
    return addrs


def _derive_auth_master(seed: int) -> str:
    import hashlib

    return hashlib.sha256(f"dagrider-cluster-{seed}|auth".encode()).hexdigest()


def build_cluster(
    root: str,
    n: int,
    *,
    transport: str = "uds",
    seed: int = 0,
    coin: str = "round_robin",
    cert: str = "off",
    rbc: bool = True,
    gc_depth: int = 16,
    checkpoint_every_s: float = 0.5,
    adversaries: Optional[Dict[int, dict]] = None,
    wan: Optional[dict] = None,
    node_overrides: Optional[dict] = None,
) -> ClusterSpec:
    """Lay out a cluster workspace: keys, addresses, per-node configs.

    ``adversaries`` maps node index -> {"kind": ..., "seed": ...} for
    Byzantine-over-sockets scenarios; ``wan`` is a WanFault config dict
    applied to EVERY node's transport (delay/drop at the real gRPC send
    seam). ``node_overrides`` merges extra keys into every node config
    (e.g. {"cert": "agg"} or mempool tuning).
    """
    if n < 4:
        raise ValueError(f"cluster needs n >= 4 (3f+1, f >= 1), got {n}")
    os.makedirs(root, exist_ok=True)
    addrs = allocate_addresses(root, n, transport)

    from dag_rider_tpu_torch.node import _dump_secret_file, generate_keys

    keys_path = os.path.join(root, "keys.json")
    threshold = (n - 1) // 3 + 1  # f+1 coin shares reconstruct
    _dump_secret_file(
        keys_path,
        generate_keys(n, threshold, seed=f"dagrider-cluster-{seed}"),
    )

    spec = ClusterSpec(
        root=os.path.abspath(root),
        n=n,
        transport=transport,
        addresses=addrs,
        seed=seed,
        accepted_log=os.path.join(os.path.abspath(root), "accepted.jsonl"),
    )
    auth_master = _derive_auth_master(seed)
    for i in range(n):
        nf = NodeFiles.for_node(spec.root, i)
        os.makedirs(nf.workdir, exist_ok=True)
        os.makedirs(nf.checkpoint_dir, exist_ok=True)
        os.makedirs(nf.flight_dir, exist_ok=True)
        node_cfg = {
            "index": i,
            "n": n,
            "listen": addrs[i],
            "peers": {str(j): addrs[j] for j in range(n) if j != i},
            "keys": keys_path,
            "rbc": rbc,
            # cpu: real Ed25519 on every vertex without the device
            # verifier's AOT-compile boot cost — cluster rungs measure
            # process/socket behavior, not kernel throughput
            "verifier": "cpu",
            "coin": coin,
            "cert": cert,
            "gc_depth": gc_depth,
            "checkpoint_dir": nf.checkpoint_dir,
            "checkpoint_every_s": checkpoint_every_s,
            "mempool": {"ttl_s": CLUSTER_MEMPOOL_TTL_S},
            "auto_propose": False,
            "auth_master": auth_master,
            "snapshot_min_interval_s": 0.2,
        }
        if wan:
            node_cfg["wan"] = dict(wan)
        if adversaries and i in adversaries:
            node_cfg["adversary"] = dict(adversaries[i])
        if node_overrides:
            node_cfg.update(node_overrides)
        runner_cfg = {
            "node": node_cfg,
            "files": vars(nf),
        }
        with open(nf.config, "w") as fh:
            json.dump(runner_cfg, fh, indent=1)
        spec.nodes.append(nf)
    spec.save()
    return spec
