"""Sharded dissemination lanes: digest-only ordering.

The port's copy of ``dag_rider_tpu/lanes/__init__.py``.

Every DAG vertex used to carry its client block inline, so consensus
bandwidth — and the host pump's per-round cost — scaled with payload
weight. Lanes split the two concerns Narwhal-style (PAPERS: "Fides"):

- The producer's worker lane encodes the payload block, disseminates it
  over the dedicated lane channel (:mod:`dag_rider_tpu_torch.transport.lanebus`
  in-process; blobbus-shaped for the item-1 cluster crossing), and
  collects 2f+1 signed availability acks into a batch availability
  certificate — the same BLS share-aggregation machinery round
  certificates use (:meth:`CertVerifier.aggregate`).
- Consensus proposes a constant-size :class:`LaneRef` carrier block in
  the payload's place; the vector pump and cert path order it unchanged.
- Delivery resolves the ref back to payload bytes through the lane
  store, with pull-based fetch-on-miss (the unicast sync
  pattern): a process that missed the batch asks a certified holder —
  2f+1 availability acks guarantee an honest one exists — before
  surfacing transactions.

Commit order and delivered bytes are provably identical to the inline
oracle: the ref is proposed in exactly the round the payload block
would have been (materialization is synchronous at proposal time —
dissemination overlaps the submit→propose gap, never delays it), block
content doesn't influence ordering (edges, coins, and tiebreaks are
content-independent), and resolution substitutes the exact bytes whose
sha256 the 2f+1 certificate pinned. Any lane failure — not enough
acks, a payload aliasing the carrier magic, an undersized block —
degrades that one block to the inline path (``ladder.lanes`` pins the
edge), so lanes can never cost liveness, only bandwidth.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Dict, Optional, Tuple, Union

from dag_rider_tpu_torch.config import Config
from dag_rider_tpu_torch.core import codec
from dag_rider_tpu_torch.core.types import Block, LaneRef, Vertex
from dag_rider_tpu_torch.transport.lanebus import LaneEndpoint
from dag_rider_tpu_torch.utils.slog import NOOP, EventLog

#: lane store capacity in batches — FIFO eviction (refs are not
#: round-keyed, so the round-floor GC the DAG books use doesn't apply);
#: an evicted batch is still recoverable from any other certified holder
_STORE_CAP = 16384


class LanePending:
    """An in-flight lane publish: the original payload block plus the
    dissemination task's results. Sits in ``Process.blocks_to_propose``
    until proposal time, when :meth:`LaneCoordinator.materialize` turns
    it into the certified carrier block (or the payload itself, on
    degrade). Exposes ``transactions`` so queue readers — checkpointing,
    the zero-loss audit, depth-based backpressure — see the payload
    exactly as they would an inline block."""

    __slots__ = ("block", "payload", "digest", "self_sig", "future", "error")

    def __init__(self, block: Block) -> None:
        self.block = block
        self.payload: Optional[bytes] = None
        self.digest: Optional[bytes] = None
        self.self_sig: bytes = b""
        self.future = None
        self.error: Optional[BaseException] = None

    @property
    def transactions(self) -> Tuple[bytes, ...]:
        return self.block.transactions


class LaneCoordinator:
    """One process's lane state: publish, store, resolve.

    Pump-thread methods (:meth:`begin_publish`, :meth:`materialize`,
    :meth:`resolve_vertex`, checkpointing) interleave with handler tasks
    running on the lane pool; the coordinator's books are guarded by one
    lock, and every counter a test asserts on is incremented on the
    pump thread so the numbers are deterministic.
    """

    def __init__(
        self,
        cfg: Config,
        index: int,
        endpoint: LaneEndpoint,
        *,
        cert_signer=None,
        cert_verifier=None,
        metrics=None,
        log: EventLog = NOOP,
    ) -> None:
        self.cfg = cfg
        self.index = index
        self.endpoint = endpoint
        self.cert_signer = cert_signer
        self.cert_verifier = cert_verifier
        self.metrics = metrics
        self.log = log
        self.quorum = cfg.quorum
        self.min_bytes = cfg.lane_batch_bytes
        self._lock = threading.Lock()
        #: digest -> encoded payload block (insertion-ordered for FIFO
        #: eviction)
        self._store: "OrderedDict[bytes, bytes]" = OrderedDict()
        #: digest -> {signer: ack signature} (producer-side collection)
        self._acks: Dict[bytes, Dict[int, bytes]] = {}
        self._seq = 0
        self._fetch_rr = 0
        # handler-side tallies (mirrored to metrics as gauges from the
        # pump thread — pool threads never touch the Metrics object)
        self._stored = 0
        self._served = 0
        self._rejected = 0
        self._evicted = 0
        endpoint.subscribe(self._on_message)

    # -- publish (producer side) --------------------------------------

    def begin_publish(
        self, block: Block
    ) -> Optional[LanePending]:
        """Start disseminating ``block`` on the lane pool; None when the
        block should ship inline instead (too small for a lane
        round-trip, or its payload aliases the carrier magic — refusing
        those keeps :func:`codec.lane_ref_of` unambiguous at delivery).
        """
        txs = block.transactions
        if not txs:
            return None
        size = 4 + sum(4 + len(tx) for tx in txs)  # exact encoded size
        if size < self.min_bytes:
            return None
        if any(tx.startswith(codec.LANE_MAGIC) for tx in txs):
            return None
        pending = LanePending(block)
        pending.future = self.endpoint.bus.submit(
            self._do_publish, pending
        )
        return pending

    def _do_publish(self, pending: LanePending) -> None:
        """Pool task: encode, hash, store locally, self-ack, broadcast.
        The per-batch payload hash runs here — n in-flight publishes
        spread their hashes across the lane workers."""
        payload = pending.block.encode()
        digest = self.endpoint.bus.digest_of(payload)
        pending.payload = payload
        pending.digest = digest
        self.endpoint.bus.seed_block(digest, pending.block)
        if self.cert_signer is not None:
            pending.self_sig = self.cert_signer.sign_availability(digest)
        self._store_batch(digest, payload)
        self._broadcast_batch(digest, payload)

    def _broadcast_batch(self, digest: bytes, payload: bytes) -> int:
        """The dissemination seam — Byzantine lane behaviors wrap this
        to withhold the batch from a victim subset. Delivery is inline
        (lanebus module docstring): by the time this returns, every
        reachable peer has stored the batch and acked."""
        return self.endpoint.broadcast("batch", (digest, payload))

    def materialize(
        self, entry: Union[Block, LanePending]
    ) -> Block:
        """Proposal-time exchange: a plain block passes through; a
        pending publish waits for its acks and yields the certified
        carrier block, or degrades to the original payload (the inline
        oracle) when fewer than 2f+1 processes attested availability."""
        if not isinstance(entry, LanePending):
            return entry
        try:
            # Work-steal the publish if the pool hasn't started it: under
            # a submit burst the caller's own publish can sit behind n-1
            # queued siblings, and FIFO queue delay — not publish work —
            # would dominate proposal latency. cancel() succeeding means
            # the pool never ran (and never will run) this task, so the
            # caller runs it here and pays only its OWN encode+hash.
            if entry.future.cancel():
                self._do_publish(entry)
            else:
                # the publish task delivers inline, so its completion
                # means every reachable peer's ack is already booked — no
                # bus-wide flush (which would serialize on every OTHER
                # in-flight publish and put their wall time on the
                # consensus path)
                entry.future.result()
        except Exception as e:  # noqa: BLE001 — degrade, never wedge
            entry.error = e
            return self._degrade(entry, f"publish failed: {e!r}")
        digest = entry.digest
        with self._lock:
            acks = self._acks.pop(digest, {})
        acks[self.index] = entry.self_sig
        valid = self._filter_acks(acks)
        if len(valid) < self.quorum:
            return self._degrade(
                entry, f"{len(valid)}/{self.quorum} availability acks"
            )
        signers = tuple(sorted(valid))[: self.quorum]
        agg = b""
        if self.cert_verifier is not None and self.cert_signer is not None:
            agg = self.cert_verifier.aggregate(
                [valid[s] for s in signers]
            ) or b""
        ref = LaneRef(
            producer=self.index,
            seq=self._seq,
            digest=digest,
            count=len(entry.block.transactions),
            nbytes=len(entry.payload),
            signers=signers,
            agg_sig=agg,
        )
        self._seq += 1
        if self.metrics is not None:
            self.metrics.inc("lane_batches_certified")
            self._sync_gauges()
        if self.log.enabled:
            self.log.event(
                "lane_certified",
                view=self.index,
                seq=ref.seq,
                nbytes=ref.nbytes,
                signers=len(signers),
            )
        return Block((codec.encode_lane_ref(ref),))

    def _degrade(self, entry: LanePending, why: str) -> Block:
        if self.metrics is not None:
            self.metrics.inc("lane_publish_degraded")
        if self.log.enabled:
            self.log.event("lane_degrade", view=self.index, detail=why)
        return entry.block

    def _filter_acks(
        self, acks: Dict[int, bytes]
    ) -> Dict[int, bytes]:
        """Keep structurally valid acks. Unsigned deployments (the
        keyless simulator) treat presence under the right digest as the
        ack; signed ones drop any share that fails G1 decompression —
        the cheap structural gate that keeps a garbage share from
        poisoning the aggregate."""
        if self.cert_signer is None:
            return dict(acks)
        from dag_rider_tpu_torch.crypto import bls12381 as bls

        out = {}
        for signer, sig in acks.items():
            try:
                ok = bls.g1_decompress(sig) is not None
            except Exception:  # noqa: BLE001 — malformed share
                ok = False
            if ok:
                out[signer] = sig
        return out

    # -- lane channel handlers (pool threads) -------------------------

    def _on_message(self, sender: int, kind: str, value) -> None:
        if kind == "batch":
            self._on_batch(sender, value)
        elif kind == "ack":
            self._on_ack(sender, value)
        elif kind == "fetch":
            self._on_fetch(sender, value)

    def _on_batch(self, sender: int, value) -> None:
        claimed, body = value
        # memo hit for every receiver after the first — the bus hands
        # all n endpoints the same payload object (lanebus docstring)
        digest = self.endpoint.bus.digest_of(body)
        if digest != claimed or len(claimed) != 32:
            with self._lock:
                self._rejected += 1
            return
        self._store_batch(digest, body)
        if self.log.enabled:
            self.log.event(
                "lane_batch",
                view=self.index,
                sender=sender,
                nbytes=len(body),
            )
        self.endpoint.send(sender, "ack", self._make_ack(digest))

    def _make_ack(self, digest: bytes) -> Tuple[bytes, bytes]:
        """(echoed digest, signature) for one availability ack — the
        seam a garbage-ack Byzantine lane behavior wraps."""
        if self.cert_signer is None:
            return digest, b""
        return digest, self.cert_signer.sign_availability(digest)

    def _on_ack(self, sender: int, value) -> None:
        digest, sig = value
        with self._lock:
            self._acks.setdefault(digest, {})[sender] = sig

    def _on_fetch(self, sender: int, digest: bytes) -> None:
        with self._lock:
            body = self._store.get(digest)
            if body is not None:
                self._served += 1
        if body is not None:
            self.endpoint.send(sender, "batch", (digest, body))

    def _store_batch(self, digest: bytes, body: bytes) -> None:
        with self._lock:
            if digest not in self._store:
                self._store[digest] = body
                self._stored += 1
                while len(self._store) > _STORE_CAP:
                    self._store.popitem(last=False)
                    self._evicted += 1

    # -- resolve (delivery side) --------------------------------------

    def resolve_vertex(self, v: Vertex) -> Vertex:
        """Substitute a carrier block's payload before delivery. A
        non-carrier vertex passes through untouched, so the inline
        oracle path never pays anything here."""
        ref = codec.lane_ref_of(v.block)
        if ref is None:
            return v
        body = self._get_or_fetch(ref)
        block = self.endpoint.bus.block_of(ref.digest, body)
        return dataclasses.replace(v, block=block)

    def peek_block(self, block: Block) -> Optional[Block]:
        """Store-only resolve (no fetch) for audits over undelivered DAG
        state; None when the block is not a carrier or the batch is not
        held locally."""
        ref = codec.lane_ref_of(block)
        if ref is None:
            return None
        with self._lock:
            body = self._store.get(ref.digest)
        if body is None:
            return None
        return self.endpoint.bus.block_of(ref.digest, body)

    def _get_or_fetch(self, ref: LaneRef) -> bytes:
        with self._lock:
            body = self._store.get(ref.digest)
        if body is not None:
            return body
        # Miss: pull from a certified holder (unicast sync
        # pattern) — rotate through the ref's signers so one slow peer
        # doesn't absorb every fetch — then degrade to a broadcast ask.
        if self.metrics is not None:
            self.metrics.inc("lane_fetch_misses")
        if self.log.enabled:
            self.log.event(
                "lane_fetch",
                view=self.index,
                producer=ref.producer,
                seq=ref.seq,
            )
        holders = [s for s in ref.signers if s != self.index]
        if holders:
            start = self._fetch_rr % len(holders)
            holders = holders[start:] + holders[:start]
            self._fetch_rr += 1
        # sends are synchronous request/responses: a holder's serve has
        # landed in our store by the time send() returns
        for peer in holders:
            self.endpoint.send(peer, "fetch", ref.digest)
            with self._lock:
                body = self._store.get(ref.digest)
            if body is not None:
                return body
        self.endpoint.broadcast("fetch", ref.digest)
        with self._lock:
            body = self._store.get(ref.digest)
        if body is not None:
            return body
        raise RuntimeError(
            f"lane batch unrecoverable: producer {ref.producer} seq "
            f"{ref.seq} — no certified holder answered, yet 2f+1 "
            "attested availability"
        )

    # -- checkpoint / stats -------------------------------------------

    def checkpoint_state(self) -> dict:
        """Everything a restart needs: the batch store (availability
        the cluster counted this process for) and the publish sequence.
        No pending-fetch book exists to persist — fetches are
        synchronous within a delivery, never carried across steps; a
        pending *publish* persists as its payload block in
        ``blocks_to_propose`` and re-ships inline after restore."""
        with self._lock:
            batches = [
                [d.hex(), b.hex()] for d, b in self._store.items()
            ]
            return {"version": 1, "seq": self._seq, "batches": batches}

    def restore_state(self, state: Optional[dict]) -> None:
        """Inverse of :meth:`checkpoint_state`; None/empty (a pre-lanes
        checkpoint) restores an empty lane store. Batches are
        re-hashed on the way in — a corrupt manifest entry is dropped,
        not trusted (the digest IS the content's identity)."""
        import hashlib

        with self._lock:
            self._store.clear()
            self._acks.clear()
            self._seq = 0
        if not state:
            return
        with self._lock:
            self._seq = int(state.get("seq", 0))
        for d_hex, b_hex in state.get("batches", []):
            digest, body = bytes.fromhex(d_hex), bytes.fromhex(b_hex)
            if hashlib.sha256(body).digest() == digest:
                self._store_batch(digest, body)
        if self.log.enabled:
            self.log.event(
                "lane_restore",
                view=self.index,
                batches=len(state.get("batches", [])),
            )

    def _sync_gauges(self) -> None:
        with self._lock:
            stored, served = self._stored, self._served
            rejected, evicted = self._rejected, self._evicted
        c = self.metrics.counters
        c["lane_batches_stored"] = stored
        c["lane_fetch_served"] = served
        c["lane_acks_rejected"] = rejected
        c["lane_store_evicted"] = evicted

    def stats(self) -> dict:
        with self._lock:
            return {
                "seq": self._seq,
                "store": len(self._store),
                "stored": self._stored,
                "served": self._served,
                "rejected": self._rejected,
                "evicted": self._evicted,
            }
