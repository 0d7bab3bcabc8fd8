"""Bounded, dedup'ing transaction pool with per-client FIFO lanes.

The port's copy of ``dag_rider_tpu/mempool/pool.py``.

The earlier ingestion edge was a bare Python list of whole blocks
(``Node._submit_queue``): unbounded, no dedup, no fairness, no aging.
This pool is the buffer the batcher (batcher.py) packs blocks from:

- **bounded** — at most ``cap`` pending transactions; adds beyond that
  are refused (the admission layer normally sheds before this hard wall
  is hit, so hitting it is itself a gauge of mis-set watermarks);
- **dedup'ing** — a transaction's bytes are its identity; re-submitting
  pending bytes is a no-op (retry storms must not multiply payloads);
- **per-client FIFO lanes** — each source keeps its own arrival order,
  and the batcher drains lanes round-robin so one firehose client
  cannot starve the others out of a block;
- **TTL eviction** — accepted-but-never-packed transactions older than
  ``ttl_s`` are dropped (a stalled cluster must not pin client payloads
  forever; the eviction count is surfaced so callers see the loss).

Not thread-safe on its own: the :class:`dag_rider_tpu_torch.mempool.Mempool`
facade serializes all access under one lock.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Tuple

from dag_rider_tpu_torch.config import MempoolConfig


@dataclasses.dataclass
class PoolEntry:
    """One pending transaction: payload bytes + provenance + age."""

    tx: bytes
    client: str
    enqueued_at: float


class TransactionPool:
    """The pending set. See module docstring for the four properties."""

    def __init__(self, cfg: MempoolConfig) -> None:
        self.cfg = cfg
        #: tx bytes -> entry; membership here IS the dedup check
        self._by_tx: Dict[bytes, PoolEntry] = {}
        #: per-client FIFO of tx keys (the lanes)
        self._lanes: Dict[str, Deque[bytes]] = {}
        #: lane rotation for round-robin draining (client names, in
        #: first-seen order; rotated as the batcher takes)
        self._lane_order: Deque[str] = deque()
        #: global arrival FIFO of (enqueued_at, tx) for TTL scans —
        #: entries taken by the batcher go stale here and are skipped
        #: lazily (enqueued_at must still match the live entry, so a
        #: re-added duplicate of an old payload never inherits its age)
        self._arrivals: Deque[Tuple[float, bytes]] = deque()
        self._bytes = 0
        # lifetime counters (the mempool gauges' raw material)
        self.admitted = 0
        self.deduped = 0
        self.expired = 0
        self.dropped_full = 0

    def __len__(self) -> int:
        return len(self._by_tx)

    @property
    def depth_bytes(self) -> int:
        return self._bytes

    @property
    def fill(self) -> float:
        """Pool occupancy fraction in [0, 1] — the admission signal."""
        return len(self._by_tx) / self.cfg.cap

    def __contains__(self, tx: bytes) -> bool:
        return tx in self._by_tx

    def add(self, tx: bytes, client: str, now: float) -> str:
        """Try to enqueue one transaction: ``"ok" | "dup" | "full"``."""
        if tx in self._by_tx:
            self.deduped += 1
            return "dup"
        if len(self._by_tx) >= self.cfg.cap:
            self.dropped_full += 1
            return "full"
        self._by_tx[tx] = PoolEntry(tx, client, now)
        lane = self._lanes.get(client)
        if lane is None:
            lane = self._lanes[client] = deque()
            self._lane_order.append(client)
        lane.append(tx)
        self._arrivals.append((now, tx))
        self._bytes += len(tx)
        self.admitted += 1
        return "ok"

    def _remove(self, tx: bytes) -> PoolEntry:
        entry = self._by_tx.pop(tx)
        self._bytes -= len(tx)
        return entry

    def expire(self, now: float) -> List[bytes]:
        """Drop pending transactions older than ttl_s; returns the
        evicted payloads (callers release latency bookkeeping)."""
        cutoff = now - self.cfg.ttl_s
        out: List[bytes] = []
        while self._arrivals and self._arrivals[0][0] <= cutoff:
            at, tx = self._arrivals.popleft()
            entry = self._by_tx.get(tx)
            if entry is None or entry.enqueued_at != at:
                continue  # already taken (or re-added fresher): stale record
            self._remove(tx)
            out.append(tx)
        self.expired += len(out)
        return out

    def oldest_age(self, now: float) -> float:
        """Age of the oldest pending transaction (0.0 when empty) — the
        batcher's deadline trigger."""
        while self._arrivals:
            at, tx = self._arrivals[0]
            entry = self._by_tx.get(tx)
            if entry is None or entry.enqueued_at != at:
                self._arrivals.popleft()  # stale: taken by the batcher
                continue
            return max(0.0, now - at)
        return 0.0

    def take(self, max_bytes: int, max_txs: int) -> List[bytes]:
        """Pop up to ``max_bytes`` worth of transactions, round-robin
        one per client lane (fairness across sources). Always yields at
        least one transaction when non-empty, even if that single
        payload exceeds ``max_bytes`` — an oversized transaction must
        ship alone, not wedge the pool."""
        out: List[bytes] = []
        size = 0
        # one pass of empties is tolerated per take; lanes are removed
        # from rotation the moment they drain so the loop terminates
        while self._lane_order and len(out) < max_txs:
            client = self._lane_order[0]
            lane = self._lanes[client]
            # lane fronts may be stale only via expire(), which removes
            # from _by_tx but not the lane; skip those
            while lane and lane[0] not in self._by_tx:
                lane.popleft()
            if not lane:
                self._lane_order.popleft()
                del self._lanes[client]
                continue
            tx = lane[0]
            if out and size + len(tx) > max_bytes:
                break
            lane.popleft()
            self._remove(tx)
            out.append(tx)
            size += len(tx)
            self._lane_order.rotate(-1)
        return out

    # -- checkpoint support ------------------------------------------------

    def pending(self) -> List[PoolEntry]:
        """Every live entry in lane order (client FIFO preserved) — the
        checkpoint payload."""
        out: List[PoolEntry] = []
        for client in self._lane_order:
            for tx in self._lanes[client]:
                entry = self._by_tx.get(tx)
                if entry is not None:
                    out.append(entry)
        return out

    def restore(self, entries, now: float) -> int:
        """Re-admit checkpointed entries (fresh age stamps: they were
        accepted before the restart and must not be TTL'd for downtime
        the client didn't cause). Returns the count restored; dups and
        over-cap entries fall out through the normal add() accounting."""
        restored = 0
        for client, tx in entries:
            if self.add(tx, client, now) == "ok":
                restored += 1
        return restored
