"""Seeded open-loop workload generation + whole-cluster load driving.

The port's copy of ``dag_rider_tpu/mempool/loadgen.py``.

Two pieces:

- :class:`LoadGenerator` — a seeded, open-loop (arrivals do not wait on
  the system; that is what makes overload *possible*, and overload is
  what admission control exists for), multi-client arrival schedule
  with Poisson, bursty-Poisson, or uniform profiles. Deterministic for
  a given seed: bench and chaos runs replay the exact same traffic.

- :class:`ClusterLoadDriver` — drives a ``Simulation`` through
  per-process :class:`~dag_rider_tpu_torch.mempool.Mempool` front doors:
  inject due arrivals, tick the batchers, feed built blocks to the
  processes, pump consensus; repeat. Runs on a **virtual clock** by
  default (fully deterministic — the byte-identity test replays the
  recorded block schedule and demands the same delivered order) or on
  the wall clock for bench rungs (real submit→a_deliver latency). The
  also keeps per-transaction lifecycle books, so a chaos run
  can *prove* shed-not-crash: every accepted transaction is delivered,
  pending, or in flight — never silently lost.

CLI smoke (the tier1-mempool CI lane):

    python -m dag_rider_tpu_torch.mempool.loadgen --n 4 --seconds 2 --rate 2000
"""

from __future__ import annotations

import argparse
import heapq
import json
import random
import time
from typing import Dict, List, Optional, Tuple

from dag_rider_tpu_torch.config import Config, MempoolConfig
from dag_rider_tpu_torch.core.types import Block

PROFILES = ("poisson", "burst", "uniform")


class LoadGenerator:
    """Open-loop multi-client arrival schedule. ``rate`` is the total
    offered tx/s split evenly across ``clients``; the burst profile
    multiplies each client's rate by ``burst_factor`` during a
    ``burst_len_s`` window every ``burst_every_s`` (phase-aligned across
    clients — the worst case for admission)."""

    def __init__(
        self,
        *,
        clients: int = 8,
        rate: float = 1000.0,
        tx_bytes: int = 32,
        seed: int = 0,
        profile: str = "poisson",
        burst_factor: float = 8.0,
        burst_every_s: float = 1.0,
        burst_len_s: float = 0.25,
    ) -> None:
        if clients < 1:
            raise ValueError(f"clients must be >= 1, got {clients}")
        if rate <= 0:
            raise ValueError(f"rate must be > 0, got {rate}")
        if profile not in PROFILES:
            raise ValueError(f"profile must be one of {PROFILES}, got {profile!r}")
        self.clients = clients
        self.rate = rate
        self.tx_bytes = tx_bytes
        self.seed = seed
        self.profile = profile
        self.burst_factor = burst_factor
        self.burst_every_s = burst_every_s
        self.burst_len_s = burst_len_s
        self._rngs = [
            random.Random((seed << 20) ^ (c * 2654435761)) for c in range(clients)
        ]
        self._seq = [0] * clients
        self.emitted = 0
        #: (next arrival time, client) min-heap
        self._next: List[Tuple[float, int]] = [
            (self._gap(c, 0.0), c) for c in range(clients)
        ]
        heapq.heapify(self._next)

    def _client_rate(self, c: int, t: float) -> float:
        r = self.rate / self.clients
        if (
            self.profile == "burst"
            and (t % self.burst_every_s) < self.burst_len_s
        ):
            r *= self.burst_factor
        return r

    def _gap(self, c: int, t: float) -> float:
        r = self._client_rate(c, t)
        if self.profile == "uniform":
            return 1.0 / r
        return self._rngs[c].expovariate(r)

    def _payload(self, c: int) -> bytes:
        self._seq[c] += 1
        head = f"s{self.seed}c{c}-{self._seq[c]:08d}".encode()
        return head.ljust(self.tx_bytes, b".")

    def events_until(self, t: float) -> List[Tuple[float, int, bytes]]:
        """Pop every arrival scheduled at or before ``t`` (advances the
        schedule — call with monotonically non-decreasing ``t``)."""
        out: List[Tuple[float, int, bytes]] = []
        while self._next and self._next[0][0] <= t:
            ts, c = heapq.heappop(self._next)
            out.append((ts, c, self._payload(c)))
            self.emitted += 1
            heapq.heappush(self._next, (ts + self._gap(c, ts), c))
        return out


class ClusterLoadDriver:
    """Pump a Simulation under open-loop mempool-fronted load.

    ``wall=False`` (default): virtual clock stepping ``dt`` per pump
    cycle — deterministic, used by tests and the chaos audit.
    ``wall=True``: real time — used by the bench rung so the latency
    histogram measures what a client would see.

    The chunked pumping deliberately throttles delivery below
    the offered load; sync patience is backlog-aware (a process with
    undelivered transport backlog is throttled, not partitioned —
    Process._maybe_request_sync), so the anti-entropy machinery no
    longer mistakes the throttle for a partition and the
    ``sync_patience=0`` workaround is gone: a genuinely dark peer under
    this load still gets anti-entropy recovery. Virtual-clock runs
    that must replay byte-identically across wall time should still pin
    ``sync_request_cooldown_s``/``sync_serve_cooldown_s`` (they are
    wall-clock rate limits) or sync_patience itself.
    """

    def __init__(
        self,
        sim,
        gen: LoadGenerator,
        *,
        mcfg: Optional[MempoolConfig] = None,
        dt: float = 0.005,
        chunk: Optional[int] = None,
        wall: bool = False,
    ) -> None:
        self.sim = sim
        self.gen = gen
        self.dt = dt
        # messages pumped per cycle. With propose_empty the cluster
        # never quiesces on its own, so this bounds how many DAG rounds
        # one virtual tick advances: a round-r broadcast burst is
        # ~n*(n-1) deliveries, so default = ~2 rounds per tick.
        self.chunk = chunk if chunk else 2 * sim.cfg.n * sim.cfg.n
        self.wall = wall
        self._vt = 0.0
        clock = time.monotonic if wall else (lambda: self._vt)
        self.mempools = sim.attach_mempools(mcfg, clock=clock)
        #: (cycle, process index, block) in submission order — the
        #: replay schedule for the byte-identity check
        self.submission_log: List[Tuple[int, int, Block]] = []
        #: every accepted payload (admission said yes) — the set the
        #: zero-loss audit accounts for
        self.accepted: set = set()
        self.shed_txs = 0
        self.cycles = 0

    def _inject(self, t: float) -> None:
        # t is elapsed-since-start (the generator's schedule origin); the
        # mempool clock is absolute in wall mode, so let the mempool
        # stamp with its own clock there — mixing the two frames once
        # produced hours-long "latencies" (absolute minus elapsed)
        now = None if self.wall else t
        n = self.sim.cfg.n
        for _, c, tx in self.gen.events_until(t):
            mp = self.mempools[c % n]
            res = mp.submit((tx,), client=f"c{c}", now=now)
            if res.accepted:
                self.accepted.add(tx)
            else:
                self.shed_txs += res.shed + res.deduped

    def _flush_batches(self, t: float, force: bool = False) -> None:
        now = None if self.wall else t
        for i, mp in enumerate(self.mempools):
            staged = len(self.sim.processes[i].blocks_to_propose)
            for b in mp.build_blocks(now=now, force=force, staged=staged):
                self.sim.processes[i].submit(b)
                self.submission_log.append((self.cycles, i, b))

    def run(
        self,
        duration_s: float,
        *,
        drain: bool = True,
        drain_s: Optional[float] = None,
    ) -> dict:
        """Offered load for ``duration_s`` (virtual or wall seconds),
        then — with ``drain`` — force-flush the batchers and pump so
        every in-flight block gets its chance to commit. ``drain_s``
        wall-bounds the drain for time-boxed bench rungs (a cut-short
        drain leaves transactions ``in_flight`` in the audit — still
        accounted for, never lost)."""
        start = time.monotonic()
        # a FaultyTransport's delay-held messages are released once per
        # cycle: delayed = reordered by ~one tick, not partitioned away
        # forever (a 5% permanent hold wedges quorum within a few rounds
        # and the whole run measures a stall, not consensus under churn)
        flush = getattr(self.sim.transport, "flush_delayed", None)
        while True:
            t = (time.monotonic() - start) if self.wall else self._vt
            if t >= duration_s:
                break
            self._inject(t)
            self._flush_batches(t)
            self.sim.run(max_messages=self.chunk)
            if callable(flush):
                flush()
            if not self.wall:
                self._vt += self.dt
            self.cycles += 1
        if drain:
            t = (time.monotonic() - start) if self.wall else self._vt
            self._flush_batches(t, force=True)
            self._drain(drain_s)
        return self.report(duration_s)

    def _drain(self, drain_s: Optional[float] = None) -> None:
        """Pump until the flushed blocks' waves commit: a wave is 4
        rounds and needs one more wave of leader support, so ~16 rounds
        of headroom; bounded — propose_empty keeps the cluster
        chattering forever, quiescence never comes. A FaultyTransport's
        held-back messages are released each sub-chunk (asynchrony:
        delivery is late, never never). Exits early once every accepted
        transaction's latency books are closed (no mempool holds an
        in-flight record)."""
        n = self.sim.cfg.n
        flush = getattr(self.sim.transport, "flush_delayed", None)
        budget = float("inf") if drain_s is None else drain_s
        t0 = time.monotonic()
        for _ in range(4):
            remaining = 16 * n * n
            while remaining > 0:
                if callable(flush):
                    flush()
                pumped = self.sim.run(max_messages=min(remaining, n * n))
                if pumped == 0 and not (
                    callable(flush) and self.sim.transport.delayed
                ):
                    break  # true quiescence (propose_empty off)
                remaining -= pumped
                if time.monotonic() - t0 > budget:
                    return
            if not any(len(mp._inflight) for mp in self.mempools):
                return

    # -- accounting --------------------------------------------------------

    def delivered_txs(self, view: int) -> List[bytes]:
        """This view's a_delivered payloads that originated from the
        cluster load, in total order."""
        return [
            tx
            for v in self.sim.deliveries[view]
            for tx in v.block.transactions
            if tx in self.accepted
        ]

    def audit(self) -> dict:
        """Zero-loss accounting: every accepted transaction must be
        delivered, pending in a pool, queued for proposal, or sitting in
        a DAG vertex. ``lost`` > 0 or ``duplicates`` > 0 is a bug."""
        delivered: set = set()
        for i in range(self.sim.cfg.n):
            delivered.update(self.delivered_txs(i))
        pending: set = set()
        for mp in self.mempools:
            pending.update(e.tx for e in mp.pool.pending())
        staged: set = set()
        for p in self.sim.processes:
            for b in p.blocks_to_propose:
                staged.update(b.transactions)
            for v in p.dag.vertices.values():
                staged.update(v.block.transactions)
        lost = self.accepted - delivered - pending - staged
        dup_max = 0
        for i in range(self.sim.cfg.n):
            seen: Dict[bytes, int] = {}
            for tx in self.delivered_txs(i):
                seen[tx] = seen.get(tx, 0) + 1
            dups = sum(1 for k in seen.values() if k > 1)
            dup_max = max(dup_max, dups)
        return {
            "accepted": len(self.accepted),
            "delivered": len(delivered & self.accepted),
            "pending": len(pending & self.accepted),
            "in_flight": len((staged & self.accepted) - delivered),
            "lost": len(lost),
            "duplicates": dup_max,
        }

    def report(self, duration_s: float) -> dict:
        """Rung-shaped summary: committed-tx/s over the load window plus
        the merged submit→a_deliver percentiles across every mempool."""
        from dag_rider_tpu_torch.utils.metrics import Histogram

        merged = Histogram()
        for mp in self.mempools:
            for s in mp.latency.samples:
                merged.observe(s)
        committed = len(self.delivered_txs(0))
        stats = [mp.stats() for mp in self.mempools]
        out = {
            "n": self.sim.cfg.n,
            "offered_tx": self.gen.emitted,
            "accepted_tx": len(self.accepted),
            "shed_tx": sum(s["shed"] for s in stats),
            "deduped_tx": sum(s["deduped"] for s in stats),
            "expired_tx": sum(s["expired"] for s in stats),
            "committed_tx": committed,
            "committed_tx_per_sec": round(committed / duration_s, 1)
            if duration_s > 0
            else 0.0,
            "blocks_built": sum(s["blocks_built"] for s in stats),
            "batch_fill": round(
                sum(s["batch_fill"] for s in stats) / max(1, len(stats)), 4
            ),
            "audit": self.audit(),
        }
        if len(merged):
            out["submit_deliver_p50_ms"] = round(1e3 * merged.percentile(50), 3)
            out["submit_deliver_p99_ms"] = round(1e3 * merged.percentile(99), 3)
        return out


def replay(sim, submission_log, *, chunk: Optional[int] = None) -> None:
    """Feed a recorded block schedule straight into ``Process.submit``
    (the legacy one-block path: no mempool, no batcher) at the same pump
    cycles that produced it, then pump to quiescence. With identical
    payload bytes the delivered transaction order must match the
    batched run byte for byte — consensus is a deterministic function
    of the proposed blocks and the delivery schedule."""
    n = sim.cfg.n
    chunk = chunk if chunk else 2 * n * n
    by_cycle: Dict[int, List[Tuple[int, Block]]] = {}
    last = 0
    for cycle, i, block in submission_log:
        by_cycle.setdefault(cycle, []).append((i, block))
        last = max(last, cycle)
    for cycle in range(last + 1):
        for i, block in by_cycle.get(cycle, ()):
            sim.processes[i].submit(block)
        sim.run(max_messages=chunk)
    for _ in range(4):
        sim.run(max_messages=16 * n * n)


def smoke(
    n: int = 4,
    seconds: float = 2.0,
    rate: float = 2000.0,
    seed: int = 7,
    profile: str = "burst",
) -> dict:
    """4-node sim under bursty load on the virtual clock: asserts clean
    agreement, zero lost accepted transactions, and no duplicate
    delivery — the CI lane's loadgen smoke."""
    from dag_rider_tpu_torch.consensus.simulator import Simulation

    cfg = Config(
        n=n,
        coin="round_robin",
        propose_empty=True,
        gc_depth=24,
    )
    sim = Simulation(cfg)
    gen = LoadGenerator(
        clients=2 * n, rate=rate, tx_bytes=32, seed=seed, profile=profile
    )
    drv = ClusterLoadDriver(
        sim,
        gen,
        mcfg=MempoolConfig(cap=4096, batch_bytes=256, batch_deadline_ms=20.0),
    )
    rep = drv.run(seconds)
    sim.check_agreement()
    audit = rep["audit"]
    assert audit["lost"] == 0, f"lost accepted transactions: {audit}"
    assert audit["duplicates"] == 0, f"duplicate deliveries: {audit}"
    assert rep["committed_tx"] > 0, f"nothing committed: {rep}"
    return rep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="dag_rider_tpu_torch.mempool.loadgen")
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--rate", type=float, default=2000.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument(
        "--profile", choices=list(PROFILES), default="burst"
    )
    args = ap.parse_args(argv)
    rep = smoke(
        n=args.n,
        seconds=args.seconds,
        rate=args.rate,
        seed=args.seed,
        profile=args.profile,
    )
    print(json.dumps(rep, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
