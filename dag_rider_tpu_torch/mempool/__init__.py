"""Mempool: the ingestion edge between clients and consensus.

The port's copy of ``dag_rider_tpu/mempool/__init__.py``.

DAG-Rider orders *blocks*; everything about which client
bytes ride in a block is decided here, Narwhal-style (data path
separate from the ordering path):

    client tx --> admission (accept/throttle/shed) --> pool (bounded,
    dedup, per-client FIFO lanes, TTL) --> batcher (size-or-deadline
    Block packing) --> Process.submit --> ... a_deliver

:class:`Mempool` is the facade gluing the three stages under one lock
(``Node.submit`` runs on client threads, the pump thread drains), plus
the end-to-end accounting: every accepted transaction's submit time is
held until its block is a_delivered, yielding the submit→a_deliver
latency histogram — the first *client-level* latency number in the
repo (verify timings measure the crypto seam, not what a client sees;
and under the simulator's dedup'd shared verifier those are amortized
anyway — utils.metrics.Metrics.mark_verify_amortized).

Deterministic: no hidden wall-clock reads — every method takes an
explicit ``now`` or falls back to the injected ``clock``, so the
simulator drives whole clusters on a virtual clock and replays
byte-identically (the byte-identity acceptance test in
tests/test_mempool.py depends on this).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Iterable, List, NamedTuple, Optional

from dag_rider_tpu_torch.config import MempoolConfig, env_float
from dag_rider_tpu_torch.core.codec import EPOCH_MAGIC
from dag_rider_tpu_torch.core.types import Block
from dag_rider_tpu_torch.mempool.admission import AdmissionController
from dag_rider_tpu_torch.mempool.batcher import BlockBatcher
from dag_rider_tpu_torch.mempool.pool import TransactionPool
from dag_rider_tpu_torch.obs import block_key, sample_tx, tx_key
from dag_rider_tpu_torch.utils.slog import NOOP, EventLog

__all__ = [
    "Mempool",
    "MempoolConfig",
    "SubmitResult",
    "AdmissionController",
    "BlockBatcher",
    "TransactionPool",
]


class SubmitResult(NamedTuple):
    """Per-call admission outcome + the backpressure signal.

    ``state`` is the admission ladder's current rung
    ("accept" | "throttle" | "shed") — a client seeing "throttle"
    should back off *now*, before its traffic starts landing in
    ``shed``.
    """

    accepted: int
    deduped: int
    shed: int
    state: str


class Mempool:
    """Admission + pool + batcher under one lock, with latency books."""

    def __init__(
        self,
        cfg: Optional[MempoolConfig] = None,
        *,
        clock: Callable[[], float] = time.monotonic,
        metrics=None,
        log: Optional[EventLog] = None,
        trace_sample: Optional[float] = None,
    ) -> None:
        self.cfg = cfg if cfg is not None else MempoolConfig.from_env()
        self.clock = clock
        #: obs seam: admission decisions + sampled tx lifecycle
        #: stamps (tx_submit / tx_batch) ride the structured event log
        self.log = log if log is not None else NOOP
        self.trace_sample = (
            env_float("DAGRIDER_TRACE_SAMPLE")
            if trace_sample is None
            else trace_sample
        )
        self._trace_state = "accept"
        #: optional utils.metrics.Metrics — submit→a_deliver samples are
        #: forwarded to its histogram so they ride the node's snapshot
        self.metrics = metrics
        self._lock = threading.RLock()
        self.pool = TransactionPool(self.cfg)
        self.admission = AdmissionController(self.cfg)
        self.batcher = BlockBatcher(self.cfg, self.pool)
        #: tx bytes -> accept time, held from admission until the block
        #: carrying it is a_delivered (or the entry is TTL'd / evicted).
        #: Doubles as the dedup horizon for in-flight-but-batched txs.
        self._inflight: Dict[bytes, float] = {}
        #: epoch control-op lane: EPOCH_MAGIC transactions
        #: bypass the admission ladder (shedding a membership change
        #: under load is the exact moment you need it) and ship in
        #: their own block ahead of payload batches — never inside a
        #: lane carrier, so the delivery-time boundary scan always
        #: sees the magic inline.
        self._control: List[bytes] = []
        #: in-flight bound: a wedged cluster must not grow this forever
        self._inflight_cap = 4 * self.cfg.cap
        from dag_rider_tpu_torch.utils.metrics import Histogram

        self.latency = Histogram()
        self.delivered_txs = 0
        #: payload bytes of OUR delivered transactions — the numerator
        #: of committed-bytes/s in the lanes A/B rung
        self.delivered_bytes = 0

    # -- front door --------------------------------------------------------

    def submit(
        self,
        txs: Iterable[bytes],
        *,
        client: str = "client0",
        now: Optional[float] = None,
    ) -> SubmitResult:
        """Admit transactions from one source. Never raises on overload:
        shed counts come back in the result, and ``state`` is the
        backpressure signal ("throttle"/"shed" → the caller should slow
        down)."""
        accepted = deduped = shed = 0
        trace = self.log.enabled
        with self._lock:
            t = self.clock() if now is None else now
            self.pool.expire(t)  # age out before measuring fill
            for tx in txs:
                if tx in self._inflight:
                    # pending OR batched-and-awaiting-delivery: either
                    # way re-admitting would deliver the payload twice
                    deduped += 1
                    self.pool.deduped += 1
                    continue
                if tx.startswith(EPOCH_MAGIC):
                    accepted += 1
                    self._control.append(tx)
                    self._note_inflight(tx, t)
                    if trace and sample_tx(tx, self.trace_sample):
                        self.log.event(
                            "tx_submit", tx=tx_key(tx), client=client
                        )
                    continue
                if not self.admission.decide(client, self.pool.fill, t):
                    shed += 1
                    continue
                verdict = self.pool.add(tx, client, t)
                if verdict == "ok":
                    accepted += 1
                    self._note_inflight(tx, t)
                    if trace and sample_tx(tx, self.trace_sample):
                        self.log.event(
                            "tx_submit", tx=tx_key(tx), client=client
                        )
                elif verdict == "dup":
                    deduped += 1
                else:  # "full": admission raced the hard wall
                    shed += 1
            state = self.admission.state
            if trace:
                if state != self._trace_state:
                    self.log.event(
                        "mempool_state",
                        state=state,
                        prev=self._trace_state,
                        fill=round(self.pool.fill, 4),
                    )
                if shed:
                    self.log.event(
                        "mempool_shed", shed=shed, client=client, state=state
                    )
            self._trace_state = state
            return SubmitResult(accepted, deduped, shed, state)

    def _note_inflight(self, tx: bytes, t: float) -> None:
        if len(self._inflight) >= self._inflight_cap:
            # evict the oldest accept record (dict preserves insertion
            # order): its latency sample is lost, exactly-once dedup for
            # that payload ends early — bounded state wins
            self._inflight.pop(next(iter(self._inflight)))
        self._inflight[tx] = t

    # -- pump side ---------------------------------------------------------

    def build_blocks(
        self,
        now: Optional[float] = None,
        *,
        force: bool = False,
        staged: int = 0,
    ) -> List[Block]:
        """TTL-evict, then drain triggered batches. The pump calls this
        each cycle and feeds the blocks to ``Process.submit``.

        ``staged`` is the consumer's current backlog (depth of
        ``Process.blocks_to_propose``); builds stop once backlog plus
        fresh blocks reach ``cfg.max_staged_blocks``, so overload piles
        up *here* — where the watermarks can shed — instead of in the
        unbounded proposal queue. ``force`` (shutdown/checkpoint flush)
        ignores the bound."""
        with self._lock:
            t = self.clock() if now is None else now
            if self.cfg.adaptive_deadline:
                self._adapt_deadline()
            for tx in self.pool.expire(t):
                self._inflight.pop(tx, None)
            control: List[Block] = []
            if self._control:
                # control lane flush: one dedicated block, ahead of any
                # payload batch and exempt from the staging bound — a
                # reconfiguration op must reach its boundary even when
                # the payload path is backlogged
                control.append(Block(tuple(self._control)))
                self._control = []
            limit: Optional[int] = None
            if not force:
                limit = max(0, self.cfg.max_staged_blocks - staged)
                if limit == 0:
                    return control
            blocks = control + self.batcher.drain(
                t, force=force, limit=limit
            )
            if blocks and self.log.enabled:
                for b in blocks:
                    keys = [
                        tx_key(tx)
                        for tx in b.transactions
                        if sample_tx(tx, self.trace_sample)
                    ]
                    if keys:
                        bk = block_key(b.encode())
                        for k in keys:
                            self.log.event("tx_batch", tx=k, block=bk)
            return blocks

    def _adapt_deadline(self) -> None:
        """Retune the batcher's effective deadline from the live
        submit→deliver histogram
        (cfg.adaptive_deadline). The hold deadline should be a small tax
        on what the client already waits end to end: target 5% of the
        measured p50, floored at 1 ms (never busy-ship every single
        transaction) and capped at the configured ``batch_deadline_ms``
        (never hold LONGER than the operator allowed). Until enough
        samples exist the configured value stands. Caller holds the
        lock."""
        if self.latency.count < 16:
            return
        p50_ms = self.latency.percentile(50.0) * 1e3
        eff = min(
            float(self.cfg.batch_deadline_ms), max(1.0, 0.05 * p50_ms)
        )
        prev = self.batcher.deadline_ms
        if abs(eff - prev) < 0.5:
            return
        self.batcher.deadline_ms = eff
        if self.metrics is not None:
            # gauge, not a counter: latest effective value wins
            self.metrics.counters["deadline_ms_effective"] = int(
                round(eff)
            )
        self.log.event(
            "deadline_adapted",
            deadline_ms=round(eff, 3),
            prev_ms=round(prev, 3),
            p50_ms=round(p50_ms, 3),
        )

    def observe_delivered(
        self, block: Block, now: Optional[float] = None
    ) -> None:
        """a_deliver callback: close the latency books for every
        transaction of ours this block carried (peers' blocks carry
        unknown payloads and are skipped by the inflight lookup)."""
        with self._lock:
            t = self.clock() if now is None else now
            for tx in block.transactions:
                t0 = self._inflight.pop(tx, None)
                if t0 is None:
                    continue
                self.delivered_txs += 1
                self.delivered_bytes += len(tx)
                s = max(0.0, t - t0)
                self.latency.observe(s)
                if self.metrics is not None:
                    self.metrics.observe_submit_deliver(s)

    # -- observability -----------------------------------------------------

    def stats(self) -> dict:
        """Gauge snapshot (cheap: counters + maintained sums only; the
        latency percentiles live in the metrics histogram)."""
        with self._lock:
            adm, pool = self.admission, self.pool
            return {
                "depth": len(pool),
                "depth_bytes": pool.depth_bytes,
                "admitted": pool.admitted,
                "deduped": pool.deduped,
                "shed": adm.shed_watermark
                + adm.shed_rate
                + pool.dropped_full,
                "shed_watermark": adm.shed_watermark,
                "shed_rate": adm.shed_rate,
                "shed_full": pool.dropped_full,
                "expired": pool.expired,
                "delivered_txs": self.delivered_txs,
                "delivered_bytes": self.delivered_bytes,
                "blocks_built": self.batcher.blocks_built,
                "txs_packed": self.batcher.txs_packed,
                "batch_fill": round(self.batcher.mean_fill(), 4),
                "state": adm.state,
            }

    # -- checkpoint support ------------------------------------------------

    def checkpoint_state(self) -> dict:
        """Pending (accepted, not yet batched) transactions with their
        lanes — what utils.checkpoint persists so a restart loses no
        accepted transaction. Batched-but-undelivered payloads are
        already covered by the Process manifest (blocks_to_propose) or
        by the DAG itself."""
        with self._lock:
            return {
                "version": 1,
                "pending": [
                    [e.client, e.tx.hex()] for e in self.pool.pending()
                ],
                # un-flushed control ops survive a restart too
                "control": [tx.hex() for tx in self._control],
            }

    def restore_state(
        self, state: dict, now: Optional[float] = None
    ) -> int:
        """Re-admit a checkpoint's pending set (fresh TTL stamps; see
        TransactionPool.restore). Returns the restored count."""
        with self._lock:
            t = self.clock() if now is None else now
            entries = [
                (client, bytes.fromhex(tx))
                for client, tx in state.get("pending", [])
            ]
            restored = self.pool.restore(entries, t)
            for client, tx in entries:
                if tx in self.pool:
                    self._note_inflight(tx, t)
            for hx in state.get("control", []):
                tx = bytes.fromhex(hx)
                if tx not in self._inflight:
                    self._control.append(tx)
                    self._note_inflight(tx, t)
                    restored += 1
            return restored

    def drop_committed(self, committed) -> int:
        """Take out of the pool every pending transaction that
        ``committed`` (a set of payloads) holds, with its latency stamp;
        returns how many left. A node restored from a checkpoint can hold
        one that its previous incarnation proposed and the cluster
        committed; if it then jumps past that commit by state transfer it
        never delivers it itself, and would batch it a second time."""
        with self._lock:
            gone = [e.tx for e in self.pool.pending() if e.tx in committed]
            for tx in gone:
                self.pool._remove(tx)
                self._inflight.pop(tx, None)
            return len(gone)
