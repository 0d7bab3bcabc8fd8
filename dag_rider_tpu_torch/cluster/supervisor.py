"""Cluster liveness supervisor: boot, kill -9, restart, gather.

The supervisor owns the OS processes. It boots one
:mod:`dag_rider_tpu_torch.cluster.runner` per committee member, waits for the
per-node ready markers, then executes a **fault plan** — a list of
``{"t": seconds_from_start, "action": "kill" | "restart" | "term",
"node": i}`` events on the wall clock. ``kill`` is a genuine SIGKILL
(no handler runs, no flush happens: exactly the failure the WAL +
atomic-checkpoint machinery exists for); ``restart`` re-spawns the same
config, so the runner restores from its checkpoint, re-injects its WAL,
and rejoins via snapshot sync when the cluster has pruned past it.

Before a restart the supervisor writes the node's **delivered hint** —
the union of transaction payloads any CURRENT delivery log shows
committed — closing the torn-tail window where the dead node's own log
lost its final lines to the SIGKILL.

On any invariant violation the harness gathers each node's flight-
recorder dumps (the distributed black box): one causal chain spanning
processes, joined on content-derived trace ids.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional

from dag_rider_tpu_torch.cluster.directory import ClusterSpec
from dag_rider_tpu_torch.cluster.runner import read_delivered_txs


def seeded_kill_plan(
    seed: int,
    n: int,
    *,
    kill_at_s: float = 3.0,
    restart_after_s: float = 2.0,
    victims: int = 1,
) -> List[dict]:
    """A deterministic kill-and-rejoin plan: ``victims`` distinct nodes
    (chosen by seed, never node 0 so the client's primary target
    survives) each SIGKILLed at a seeded jitter around ``kill_at_s``
    and restarted ``restart_after_s`` later."""
    import random

    rng = random.Random(seed)
    order = list(range(1, n))
    rng.shuffle(order)
    plan = []
    for k, node in enumerate(order[: max(1, victims)]):
        t_kill = kill_at_s + k * 0.5 + rng.uniform(0.0, 0.5)
        plan.append({"t": round(t_kill, 3), "action": "kill", "node": node})
        plan.append(
            {
                "t": round(t_kill + restart_after_s, 3),
                "action": "restart",
                "node": node,
            }
        )
    return sorted(plan, key=lambda e: e["t"])


class ClusterSupervisor:
    """Spawns and terminates the per-node runner processes."""

    def __init__(
        self,
        spec: ClusterSpec,
        *,
        clock: Callable[[], float] = time.time,
        env: Optional[Dict[str, str]] = None,
        trace: bool = True,
    ) -> None:
        self.spec = spec
        self.clock = clock
        self.procs: Dict[int, subprocess.Popen] = {}
        self.kill_counts: Dict[int, int] = {}
        self.restart_counts: Dict[int, int] = {}
        self._outs: List = []
        base_env = dict(os.environ)
        # an environment string the port never reads; the runners'
        # environment stays the reference harness's
        base_env.setdefault("JAX_PLATFORMS", "cpu")
        if trace:
            base_env["DAGRIDER_TRACE"] = "1"
        if env:
            base_env.update(env)
        self._env = base_env

    # -- lifecycle -----------------------------------------------------

    def start(self, index: int) -> None:
        nf = self.spec.nodes[index]
        env = dict(self._env)
        # per-node flight dir: the distributed black box gathers into
        # one place per process, not one shared trampled directory
        env["DAGRIDER_FLIGHT_DIR"] = nf.flight_dir
        out = open(nf.stdout, "a")
        err = open(nf.stderr, "a")
        self._outs += [out, err]
        self.procs[index] = subprocess.Popen(
            [
                sys.executable,
                "-m",
                "dag_rider_tpu_torch.cluster.runner",
                "--config",
                nf.config,
            ],
            stdout=out,
            stderr=err,
            env=env,
        )

    def start_all(self) -> None:
        for i in range(self.spec.n):
            self.start(i)

    def wait_ready(self, timeout_s: float = 15.0) -> List[int]:
        """Block until every LIVE node's ready marker exists; returns
        the indices that failed to come up in time (empty = all good)."""
        deadline = self.clock() + timeout_s
        pending = set(self.procs)
        while pending and self.clock() < deadline:
            for i in sorted(pending):
                proc = self.procs[i]
                if proc.poll() is not None:
                    # died during boot: surface immediately
                    pending.discard(i)
                    continue
                if os.path.exists(self.spec.nodes[i].ready_marker):
                    pending.discard(i)
            if pending:
                time.sleep(0.05)
        dead = [
            i
            for i, p in self.procs.items()
            if p.poll() is not None
            or not os.path.exists(self.spec.nodes[i].ready_marker)
        ]
        return sorted(set(dead) | pending)

    def kill(self, index: int) -> None:
        """SIGKILL — the violent path. No handler, no flush, no
        checkpoint: whatever was not already on disk is gone."""
        proc = self.procs.get(index)
        if proc is None or proc.poll() is not None:
            return
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=10)
        self.kill_counts[index] = self.kill_counts.get(index, 0) + 1

    def write_delivered_hint(self, index: int) -> int:
        """Union every current delivery log's committed payloads into
        the node's hint file (read by the runner before re-injecting its
        WAL). Returns the hint size."""
        union = set()
        for i, nf in enumerate(self.spec.nodes):
            if i == index:
                continue
            union |= read_delivered_txs(nf.delivery_log)
        nf = self.spec.nodes[index]
        tmp = nf.delivered_hint + ".tmp"
        with open(tmp, "w") as fh:
            for tx in sorted(union):
                fh.write(tx.hex() + "\n")
        os.replace(tmp, nf.delivered_hint)
        return len(union)

    def restart(self, index: int) -> None:
        """Respawn a killed node from its on-disk state: checkpoint
        restore + WAL re-injection + (if pruned past) snapshot rejoin.
        The stale ready marker is cleared first so wait_ready() tracks
        THIS incarnation."""
        marker = self.spec.nodes[index].ready_marker
        try:
            os.remove(marker)
        except OSError:
            pass
        self.write_delivered_hint(index)
        self.start(index)
        self.restart_counts[index] = self.restart_counts.get(index, 0) + 1

    def run_plan(
        self, plan: List[dict], t0: Optional[float] = None
    ) -> List[dict]:
        """Execute fault events relative to ``t0`` (default: now).
        Returns the executed events with actual wall stamps attached."""
        start = self.clock() if t0 is None else t0
        executed = []
        for ev in sorted(plan, key=lambda e: e["t"]):
            delay = start + float(ev["t"]) - self.clock()
            if delay > 0:
                time.sleep(delay)
            node = int(ev["node"])
            if ev["action"] == "kill":
                self.kill(node)
            elif ev["action"] == "restart":
                self.restart(node)
            elif ev["action"] == "term":
                proc = self.procs.get(node)
                if proc is not None and proc.poll() is None:
                    proc.send_signal(signal.SIGTERM)
            else:
                raise ValueError(f"unknown fault action {ev['action']!r}")
            executed.append({**ev, "at": self.clock() - start})
        return executed

    def stop_all(self, timeout_s: float = 20.0) -> List[int]:
        """Graceful SIGTERM sweep (runners drain, checkpoint, and write
        final.json), SIGKILL stragglers. Returns indices that had to be
        SIGKILLed (their final.json is missing/stale — the audit treats
        them as crashed)."""
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        deadline = self.clock() + timeout_s
        forced = []
        for i, proc in sorted(self.procs.items()):
            left = deadline - self.clock()
            try:
                proc.wait(timeout=max(0.1, left))
            except subprocess.TimeoutExpired:
                proc.send_signal(signal.SIGKILL)
                proc.wait(timeout=10)
                forced.append(i)
        for fh in self._outs:
            try:
                fh.close()
            except OSError:
                pass
        self._outs = []
        return forced

    # -- post-mortem ---------------------------------------------------

    def gather_flight_dumps(self) -> Dict[int, List[str]]:
        """The distributed black box: every node's flight-recorder dump
        files (empty lists everywhere = clean run, the bench gate)."""
        dumps: Dict[int, List[str]] = {}
        for i, nf in enumerate(self.spec.nodes):
            try:
                files = sorted(
                    os.path.join(nf.flight_dir, f)
                    for f in os.listdir(nf.flight_dir)
                )
            except OSError:
                files = []
            dumps[i] = files
        return dumps

    def exit_codes(self) -> Dict[int, Optional[int]]:
        return {i: p.poll() for i, p in sorted(self.procs.items())}
