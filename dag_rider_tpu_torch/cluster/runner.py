"""Per-node OS-process entrypoint — ``python -m dag_rider_tpu_torch.cluster.runner``.

One :class:`dag_rider_tpu_torch.node.Node` wrapped in the harness durability
seams the kill -9 chaos suite audits against:

- **Submit WAL**: a transaction is acknowledged to the client only after
  the node's mempool accepted it AND its hex landed in a line-buffered
  append-only WAL. ``write(2)`` data survives SIGKILL (the kernel owns
  it once the syscall returns), so every acknowledged transaction is
  recoverable even when the process dies between checkpoints.
- **Delivery log**: every a_delivered vertex appends one JSON line
  (round, source, digest, payload hexes, wall stamp) — the audit's
  commit-order record AND the latency join point for wire-level
  submit→deliver percentiles.
- **Re-injection**: on restart the WAL is replayed minus what the
  delivery log, the restored checkpoint state (mempool pending, staged
  blocks, DAG payloads), and the supervisor's cluster-delivered hint
  already cover — zero loss without duplicate delivery.
- **Clean stop**: SIGTERM drains, checkpoints, and writes ``final.json``
  (metrics snapshot + retained transaction set) for the audit's
  accepted ⊆ delivered ∪ retained accounting.

Trace ids cross the process boundary for free: the round-16 trace key is
content-derived (``obs.tx_key`` = crc32 of the transaction bytes), so
the identical payload bytes produce the identical id at the client, the
accepting node, and every delivering node — the wire format IS the
propagation. Runners started with DAGRIDER_TRACE=1 each keep a flight
recorder whose dumps the supervisor gathers into one distributed black
box on any invariant violation.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time
from typing import Callable, Set

from dag_rider_tpu_torch.core.types import Block
from dag_rider_tpu_torch.node import Node
from dag_rider_tpu_torch.utils.slog import EventLog


def read_wal(path: str) -> list:
    """Acknowledged transactions from a submit WAL, oldest first.

    Tolerates a torn final line (kill -9 mid-append): a line that does
    not decode as hex is skipped — by construction it can only be the
    last one, and a torn line was never fsync'd into an acknowledgement.
    """
    txs = []
    try:
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    txs.append(bytes.fromhex(line))
                except ValueError:
                    continue  # torn tail
    except OSError:
        return []
    return txs


def read_delivered_txs(path: str) -> Set[bytes]:
    """Transaction payloads already committed per a delivery log
    (JSONL; torn final line skipped)."""
    out: Set[bytes] = set()
    try:
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                    for hx in rec.get("tx", ()):
                        out.add(bytes.fromhex(hx))
                except (ValueError, TypeError):
                    continue  # torn tail
    except OSError:
        pass
    return out


def read_hint(path: str) -> Set[bytes]:
    """The supervisor's cluster-delivered hint (hex lines): payloads some
    OTHER node already committed while we were dead. Closes the torn-tail
    duplicate window — our own delivery log may be missing its final
    entries, but a survivor's is not."""
    out: Set[bytes] = set()
    try:
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if line:
                    try:
                        out.add(bytes.fromhex(line))
                    except ValueError:
                        continue
    except OSError:
        pass
    return out


def retained_txs(node: Node) -> Set[bytes]:
    """Every accepted-but-not-yet-committed payload the node currently
    holds: mempool pending, staged proposal blocks, and live DAG vertex
    payloads (covers batched-and-proposed but undelivered)."""
    out: Set[bytes] = set()
    if node.mempool is not None:
        for entry in node.mempool.pool.pending():
            out.add(entry.tx)
    for block in node.process.blocks_to_propose:
        out.update(block.transactions)
    for v in node.process.dag.vertices.values():
        if v.block is not None:
            out.update(v.block.transactions)
    return out


class NodeRunner:
    """The harness wrapper around one Node: WAL, delivery log, Submit
    front door, re-injection, and shutdown reporting."""

    def __init__(
        self,
        cfg: dict,
        *,
        clock: Callable[[], float] = time.time,
    ) -> None:
        self.cfg = cfg
        self.files = cfg["files"]
        self.clock = clock
        self.index = int(cfg["node"]["index"])
        self._stop = threading.Event()
        self._reinject_due = threading.Event()
        self._wal_lock = threading.Lock()
        self._dlog_lock = threading.Lock()

        # Line-buffered text appends: each write() reaches the kernel at
        # the newline, which is exactly the durability SIGKILL respects.
        self._wal = open(self.files["submits_wal"], "a", buffering=1)
        self._dlog = open(self.files["delivery_log"], "a", buffering=1)
        self._events = open(self.files["events_log"], "a", buffering=1)

        log = EventLog(
            self._event_sink, clock=clock, node=self.index
        )
        self.node = Node(cfg["node"], log=log)

        # Delivery-log wrap: Process calls its on_deliver attribute per
        # committed vertex (pump thread); chain ours after the Node's
        # own bookkeeping so mempool latency books stay intact.
        inner = self.node.process.on_deliver
        self.node.process.on_deliver = (
            lambda v: (inner(v), self._log_delivery(v))
        )

        # Crash recovery: anything acknowledged before the previous
        # incarnation died must be back in flight unless some log shows
        # it already committed (or the restored state still holds it).
        self._drop_committed_blocks()
        self._reinject()

        # Client front door LAST: no submissions race the re-injection.
        self.node.net.set_submit_sink(self._on_submit)

    # -- sinks ---------------------------------------------------------

    def _event_sink(self, rec: dict) -> None:
        try:
            self._events.write(json.dumps(rec, default=repr) + "\n")
        except ValueError:
            pass  # closed during shutdown race
        # A rejoining node that restored an old checkpoint proposes at
        # rounds the cluster may have pruned past; the snapshot jump (or
        # an attested-floor prune) then discards those vertices — and
        # the acknowledged payloads they carried, which are now in no
        # mempool, no staging list, and no live vertex. Re-run WAL
        # re-injection whenever state is discarded so they re-enter the
        # pipeline. Deferred to the run loop: this sink fires on the
        # pump thread, which owns the very state _reinject scans.
        if rec.get("event") in ("state_transferred", "pruned"):
            self._reinject_due.set()

    def _log_delivery(self, vertex) -> None:
        txs = (
            [tx.hex() for tx in vertex.block.transactions]
            if vertex.block is not None
            else []
        )
        rec = {
            "ts": self.clock(),
            "r": vertex.id.round,
            "s": vertex.id.source,
            "d": vertex.digest().hex(),
            "tx": txs,
        }
        with self._dlog_lock:
            try:
                self._dlog.write(json.dumps(rec) + "\n")
            except ValueError:
                pass

    # -- submit front door --------------------------------------------

    def _on_submit(self, request: bytes) -> bytes:
        """gRPC Submit sink: {"client": c, "txs": [hex...]} in, the
        admission verdict out. WAL-before-ack: accepted transactions
        are appended (and kernel-owned) before the response leaves."""
        req = json.loads(request)
        txs = tuple(bytes.fromhex(t) for t in req["txs"])
        res = self.node.submit(
            Block(txs), client=str(req.get("client", "wire"))
        )
        if res is None:  # no mempool: legacy queue accepted everything
            accepted = len(txs)
            deduped = shed = 0
            state = "accept"
        else:
            accepted, deduped, shed, state = res
        if accepted or deduped:
            # Per-call granularity: the client submits one transaction
            # per RPC, so accepted>0 means THE transaction is in. (A
            # dedup hit means a prior ack already covered these bytes.)
            if accepted:
                with self._wal_lock:
                    for tx in txs:
                        self._wal.write(tx.hex() + "\n")
        return json.dumps(
            {
                "accepted": accepted,
                "deduped": deduped,
                "shed": shed,
                "state": state,
            }
        ).encode()

    # -- crash recovery -----------------------------------------------

    def _reinject(self) -> None:
        wal = read_wal(self.files["submits_wal"])
        if not wal:
            return
        covered = read_delivered_txs(self.files["delivery_log"])
        covered |= read_hint(self.files["delivered_hint"])
        if self.node.mempool is not None:
            self.node.mempool.drop_committed(covered)
        try:
            covered |= retained_txs(self.node)
        except RuntimeError:
            # live-state scan raced the pump (dict mutated during
            # iteration); retry on the next run-loop tick
            self._reinject_due.set()
            return
        pending = [tx for tx in wal if tx not in covered]
        if not pending:
            return
        self.node.submit(Block(tuple(pending)), client="__wal__")
        self.node.process.metrics.inc("cluster_reinjects", len(pending))
        self.node.log.event(
            "cluster_reinject",
            count=len(pending),
            wal=len(wal),
            covered=len(covered & set(wal)),
        )

    def _drop_committed_blocks(self) -> None:
        """Take out of the restored proposal queue every transaction a
        delivery log shows committed, before the pump (which owns the
        queue) starts: the queue is checkpointed with the node, and
        holds the same hazard as the mempool (see
        :meth:`Mempool.drop_committed`)."""
        committed = read_delivered_txs(self.files["delivery_log"])
        committed |= read_hint(self.files["delivered_hint"])
        queue = self.node.process.blocks_to_propose
        kept = []
        for block in queue:
            if isinstance(block, Block):
                txs = tuple(tx for tx in block.transactions if tx not in committed)
                if not txs:
                    continue
                if len(txs) < len(block.transactions):
                    block = Block(txs)
            kept.append(block)
        queue.clear()
        queue.extend(kept)

    # -- lifecycle -----------------------------------------------------

    def run(self, duration: float = 0.0) -> int:
        self.node.start()
        # Ready marker AFTER start: the gRPC server is bound during Node
        # construction, the pump is live now — the supervisor's boot
        # barrier waits on this file.
        with open(self.files["ready_marker"], "w") as fh:
            fh.write(str(os.getpid()))
        deadline = self.clock() + duration if duration > 0 else None
        while not self._stop.is_set():
            if deadline is not None and self.clock() >= deadline:
                break
            if self._reinject_due.is_set():
                self._reinject_due.clear()
                self._reinject()
            self._stop.wait(0.05)
        self.shutdown()
        return 0

    def request_stop(self) -> None:
        self._stop.set()

    def shutdown(self) -> None:
        self.node.net.set_submit_sink(None)  # refuse new client traffic
        self.node.stop()  # final drain + checkpoint (incl. mempool)
        retained = retained_txs(self.node)
        # WAL orphans count as retained: a state-transfer jump right
        # before SIGTERM may have discarded acknowledged payloads the
        # run loop never got to re-inject. They are durable on disk and
        # re-enter the pipeline on the next boot, so the audit's
        # accepted ⊆ delivered ∪ retained accounting must see them.
        covered = read_delivered_txs(self.files["delivery_log"])
        covered |= read_hint(self.files["delivered_hint"])
        covered |= retained
        retained |= {
            tx
            for tx in read_wal(self.files["submits_wal"])
            if tx not in covered
        }
        final = {
            "index": self.index,
            "round": self.node.process.round,
            "decided_wave": self.node.process.decided_wave,
            "delivered": len(self.node.delivered),
            "retained": sorted(tx.hex() for tx in retained),
            "metrics": self.node.process.metrics.snapshot(),
        }
        tmp = self.files["final_report"] + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(final, fh)
        os.replace(tmp, self.files["final_report"])
        for fh in (self._wal, self._dlog, self._events):
            try:
                fh.close()
            except OSError:
                pass



def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="dag_rider_tpu_torch.cluster.runner")
    ap.add_argument("--config", required=True)
    ap.add_argument(
        "--duration", type=float, default=0.0, help="0 = until signaled"
    )
    args = ap.parse_args(argv)
    with open(args.config) as fh:
        cfg = json.load(fh)
    runner = NodeRunner(cfg)

    def _on_term(_sig, _frame):
        runner.request_stop()

    signal.signal(signal.SIGTERM, _on_term)
    signal.signal(signal.SIGINT, _on_term)
    return runner.run(args.duration)


if __name__ == "__main__":
    sys.exit(main())
