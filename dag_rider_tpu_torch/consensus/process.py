"""The DAG-Rider process: Algorithms 1-3 of the paper, de-bugged.

The port's copy of ``dag_rider_tpu/consensus/process.py``.

This is the host-side consensus state machine — the counterpart of the
reference's ``Process`` (``process/process.go``), implementing the *paper
semantics* the reference quotes in its comments (Alg. 2 at
``process.go:189-199, 271-275, 300-302``; Alg. 3 at ``process.go:315-325,
358-361``; Alg. 1 ordering at ``process.go:405-411``) while fixing the
reference's defects (SURVEY.md §8):

- D2: genesis round 0 is seeded with one vertex per source (a "predefined
  set"), not n copies of the caller's own id.
- D3: round advancement lives *inside* the progress loop, not after an
  infinite loop; the machine is event-driven (``on_message``/``step``), not
  a busy-spin.
- D4: state mutation is real (no value-receiver copies to lose updates).
- D5: ``order_vertices`` is actually invoked by the commit rule.
- D6: delivery is an ``a_deliver`` client callback, not a re-broadcast into
  the consensus transport.
- D7: a public :meth:`submit` API feeds ``blocks_to_propose`` (and
  ``propose_empty`` keeps liveness when clients are idle).
- D8: the delivered-set dedup actually skips delivered vertices.
- D9: the common coin is pluggable; the threshold-BLS coin replaces the
  constant stub.
- D10: vertices are signature-checked (via the batched Verifier seam) and
  message stamps are cross-checked against the signed vertex id before any
  state changes.

Concurrency model: the process is a *synchronous* state machine — all
methods run on the caller's thread and delivery order is whatever the
Transport pump chooses. This makes N-process simulations deterministic and
replayable; threading (if any) lives in the Transport, exactly where the
process/network boundary sits in the reference (``process.go:186``).
"""

from __future__ import annotations

import time as _time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Set

import numpy as np

from dag_rider_tpu_torch.config import Config
from dag_rider_tpu_torch.consensus.coin import CommonCoin, FixedCoin, RoundRobinCoin
from dag_rider_tpu_torch.consensus.dag_state import DagState
from dag_rider_tpu_torch.core.codec import EPOCH_MAGIC, encode_epoch_op
from dag_rider_tpu_torch.core.stack import Stack
from dag_rider_tpu_torch.core.types import (
    Block,
    BroadcastMessage,
    EpochOp,
    RoundCertificate,
    SpanCertificate,
    Vertex,
    VertexID,
)
from dag_rider_tpu_torch.epoch.manager import (
    EpochManager,
    EpochTransition,
    derive_epoch_keys,
)
from dag_rider_tpu_torch.obs import block_key
from dag_rider_tpu_torch.transport.base import Transport, resolve_unicast
from dag_rider_tpu_torch.utils.metrics import Metrics, Timer
from dag_rider_tpu_torch.utils.slog import NOOP, EventLog

# a_deliver callback: (vertex) — the client-facing output of Algorithm 1.
DeliverCallback = Callable[[Vertex], None]


class Process:
    """One DAG-Rider participant."""

    def __init__(
        self,
        cfg: Config,
        index: int,
        transport: Transport,
        *,
        coin: Optional[CommonCoin] = None,
        verifier=None,
        signer=None,
        cert_signer=None,
        cert_verifier=None,
        on_deliver: Optional[DeliverCallback] = None,
        on_deliver_early: Optional[DeliverCallback] = None,
        log: EventLog = NOOP,
    ) -> None:
        if not 0 <= index < cfg.n:
            raise ValueError(f"index must be in [0, {cfg.n}), got {index}")
        self.cfg = cfg
        self.index = index
        self.transport = transport
        self.coin = coin if coin is not None else self._default_coin(cfg)
        self.verifier = verifier
        self.signer = signer
        self.cert_signer = cert_signer
        self.cert_verifier = cert_verifier
        self.on_deliver = on_deliver
        #: speculative a_deliver seam: with cfg.eager_deliver
        #: a decided wave's canonical chunk is surfaced here at DECISION
        #: time, ahead of the (possibly deferred) on_deliver flush. The
        #: stream is a prefix of the final order by construction;
        #: _order_vertices reconciles and treats divergence as an
        #: invariant violation.
        self.on_deliver_early = on_deliver_early
        # Structured event log (SURVEY §5 L5; the reference has 3 zap
        # Debug sites — here every state transition emits a typed event).
        # NOOP by default: one attribute test per call site.
        self.log = log.child(process=index) if log.enabled else log

        self.dag = DagState(cfg)
        # Genesis: the predefined round-0 vertex set, one per source (D2
        # fixed — the reference stamps every genesis vertex with the
        # caller's own id, process.go:43-49).
        for i in range(cfg.n):
            self.dag.insert(Vertex(id=VertexID(0, i)))

        self.round = 0
        #: round-batched pump (cfg.pump == "vector" / DAGRIDER_PUMP):
        #: VAL admission checks run batched at the top of :meth:`step`
        #: (_process_inbox) and the buffer drains whole round groups
        #: against the dense mirrors (_drain_buffer_vector). Scalar mode
        #: is the reference oracle; byte-identical commit order is the
        #: gate (tests/test_pump_vector.py).
        self._vector = cfg.pump == "vector"
        #: deferred VAL messages awaiting _process_inbox (vector mode
        #: only; control messages are never deferred).
        self._inbox: List[BroadcastMessage] = []
        self._buffer: List[Vertex] = []
        #: vector-mode buffer storage: round -> {source: vertex} in
        #: arrival order (dicts preserve insertion order; the source key
        #: doubles as the duplicate-membership probe — within one round a
        #: (round, source) collision IS a vid collision, and an int key
        #: skips the VertexID tuple hash the n=256 host profile's flame chart
        #: charges ~0.5s of dict.get to).
        self._buffer_rounds: Dict[int, Dict[int, Vertex]] = {}
        #: scalar-mode buffer membership mirror; vector mode keys the
        #: round groups by vid instead and leaves this set empty.
        self._buffered_ids: Set[VertexID] = set()
        #: blocked-vertex memo for _drain_buffer's short-circuit; entries
        #: live exactly as long as the vertex sits in the buffer.
        self._blocked_on: Dict[VertexID, VertexID] = {}
        self._pending_verify: List[Vertex] = []
        self._pending_verify_ids: Set[VertexID] = set()
        self._waves_tried: Set[int] = set()
        #: entries are payload Blocks — or, when dissemination lanes are
        #: attached, LanePending handles whose in-flight publish
        #: materializes into a certified carrier block at proposal time
        #:; handles expose ``transactions`` so queue readers
        #: (checkpoint, audits, depth backpressure) need not care
        self.blocks_to_propose: Deque[Block] = deque()
        #: dissemination-lane coordinator, wired post-construction via
        #: attach_lanes when cfg.lanes is on (None = inline payloads,
        #: the byte-identity oracle)
        self.lanes = None
        self.decided_wave = 0
        self._pending_waves: Set[int] = set()
        self.delivered_log: List[VertexID] = []
        #: deliveries dropped from delivered_log by GC pruning (the log
        #: keeps only the live window when cfg.gc_depth is set)
        self.delivered_trimmed = 0
        #: dense bool[capacity, n] twin of ``delivered`` — lets the
        #: ordering pass diff a closure bitmap against delivered state in
        #: one vectorized op instead of per-slot set probes (the
        #: per-commit rescan of the whole history was ~25% of the 64-node
        #: host profile). Written only by _order_vertices; checkpoint
        #: restore re-derives it via _rebuild_delivered_mask.
        self._delivered_mask = np.zeros_like(self.dag.exists)
        self._stuck_steps = 0
        #: msgs_received watermark for backlog-aware sync patience — see
        #: _maybe_request_sync (a node still being fed is throttled, not
        #: partitioned)
        self._rx_at_patience = 0
        self._sync_last_request = float("-inf")
        #: round-robin cursor over peers for pull-based sync requests;
        #: start offset by our index so n stuck nodes don't all probe
        #: peer 0 in the same window
        self._sync_peer_rr = index + 1
        self._sync_last_serve: Dict[int, float] = {}  # requester -> mono
        #: responder -> GC floor from sync_nack replies; f+1 distinct
        #: floors above our round flip state_transfer_needed (the node
        #: runtime acts on it — Process has no transport-level RPC).
        self._horizon_nacks: Dict[int, int] = {}
        self.state_transfer_needed = False
        #: round lo of our most recent sync request — nacks are judged
        #: against the *requested window*, not just our round: a node
        #: whose round is ahead of peers' floors can still be wedged
        #: re-requesting pruned straggler rounds forever.
        self._sync_last_lo: Optional[int] = None
        #: responder -> highest nacked floor (monotone for honest
        #: responders; bounded at n entries). The (f+1)-th largest value
        #: is the highest floor at least one HONEST responder attests —
        #: rounds at/below it are finalized history nobody will serve.
        self._window_nacks: Dict[int, int] = {}
        #: f+1-attested peer GC floor (monotone max). It gates ONLY the
        #: sync-request targeting (_maybe_request_sync skips blockers
        #: at/below it — the endless re-request wedge this exists for).
        #: It deliberately does NOT touch admission: f+1 floors prove
        #: one honest peer pruned that history, not that every honest
        #: peer has — a lower-floor peer may still serve it, so
        #: dropping buffered vertices here could forfeit a recovery
        #: (and fork our delivered log from peers who did deliver
        #: them). Kept-but-unrequested vertices cost bounded memory and
        #: zero traffic; if the gap ever blocks real progress the node
        #: falls behind until the floors-above-round rule flips
        #: state_transfer_needed, the designed recovery.
        self._attested_floor = 0
        #: equivocation book, round -> n-slot digest list indexed by
        #: source (the vid-keyed dict was the
        #: hottest memo in the n=256 host profile — a list index replaces
        #: the tuple hash). Trimmed with the GC floor like the dag.
        self._seen_digests: Dict[int, List[Optional[bytes]]] = {}
        # -- aggregated round certificates -------------------
        #: cert fast path is live only when the knob, a verifier, and
        #: both cert-key seams are present; otherwise every field below
        #: stays empty and the per-vertex path is untouched.
        self._cert = (
            cfg.cert == "agg"
            and verifier is not None
            and cert_signer is not None
            and cert_verifier is not None
        )
        #: round -> {source: vertex} awaiting that round's certificate
        #: (non-aggregator rounds only)
        self._cert_pool: Dict[int, Dict[int, Vertex]] = {}
        #: aggregator-side: round -> {source: (digest, cert_sig)} of
        #: directly verified vertices, consumed by _maybe_assemble_certs
        self._cert_stash: Dict[int, Dict[int, tuple]] = {}
        #: rounds settled either way (cert applied or degraded) — later
        #: copies take the normal per-vertex path
        self._cert_done: Set[int] = set()
        #: rounds whose certificate we already assembled and gossiped
        self._certs_sent: Set[int] = set()
        #: round -> steps spent waiting on its certificate; exceeding
        #: cfg.cert_patience degrades the round to per-vertex verifies
        #: (a Byzantine aggregator can cost a round its fast path, never
        #: its liveness)
        self._cert_wait: Dict[int, int] = {}
        #: certificates received but not yet applied (application runs in
        #: step(), after _process_inbox, so a cert can never outrun the
        #: VALs it covers through the deferred-inbox path)
        self._pending_certs: List[RoundCertificate] = []
        # -- cert-of-certs overlay ---------------
        #: span width k; epoch e covers rounds e*k+1 .. (e+1)*k and its
        #: designated span aggregator is process e % n. 0 = off. Spans
        #: ride ON TOP of round certificates: a receiver never waits on
        #: one (liveness stays anchored on the per-round path), it only
        #: settles still-pending covered rounds with one combined check.
        self._span = int(cfg.cert_span or 0) if self._cert else 0
        #: span-aggregator side: epoch -> {round: verified cert} banked
        #: toward that epoch's cert-of-certs
        self._span_bank: Dict[int, Dict[int, RoundCertificate]] = {}
        #: epochs whose span we already assembled and gossiped
        self._spans_sent: Set[int] = set()
        #: epochs settled locally (span applied) or abandoned (a covered
        #: round degraded / bank went stale) — later spans are ignored
        self._span_done: Set[int] = set()
        #: epoch -> ticks a partial bank has been waiting; stale epochs
        #: abandon (the overlay is best-effort, certs keep flowing)
        self._span_wait: Dict[int, int] = {}
        #: spans received but not yet applied (same deferred application
        #: discipline as _pending_certs)
        self._pending_spans: List[SpanCertificate] = []
        # -- epoch reconfiguration --------------------------
        #: None = static membership (the oracle path). NAMING NOTE: the
        #: span-certificate books above use "epoch" for their k-round
        #: aggregation groups — unrelated. Everything reconfiguration
        #: lives behind epoch_mgr / the ``epoch_*`` method prefix.
        self.epoch_mgr = (
            EpochManager(cfg.epoch_waves) if cfg.epoch else None
        )
        #: pending epoch-boundary GC floor (applied at the next
        #: maybe_prune, never mid-ordering — see _epoch_advance)
        self._epoch_gc_floor: Optional[int] = None
        self.metrics = Metrics()
        if self._cert:
            self.metrics.counters["cert_path_enabled"] = 1
            if self._span:
                self.metrics.counters["span_path_enabled"] = 1
        if self.epoch_mgr is not None:
            # visible-at-zero gauges, same discipline as the eager path:
            # "epoch 0, nothing rejected" must be distinguishable from
            # "epoch path absent" in snapshots
            self.metrics.counters["epoch_path_enabled"] = 1
            self.metrics.counters["epoch_current"] = 0
            self.metrics.counters["epoch_stale_rejected"] = 0
            #: high-water mark of live (unpruned) vertices — the
            #: flatness witness for epoch GC
            self.metrics.counters["vertices_live_max"] = 0
        #: verified span certificates kept for snapshot attestation
        #:: span-epoch -> SpanCertificate, populated on both
        #: the aggregator and receiver sides, pruned with the GC floor
        #: but only below the snapshot base (the attestation must cover
        #: the window a joiner restores).
        self._span_chain: Dict[int, SpanCertificate] = {}
        self._started = False
        # Burst delivery (the north-star batching shape): when True,
        # ``on_message`` only queues — the caller (Simulation pump / net
        # inbox drain) delivers a whole burst, then calls :meth:`step`
        # once, so ``_drain_verify`` sees round-sized batches instead of
        # one dispatch per message.
        self.defer_steps = False
        # Deferred a_deliver (pipeline overlap): when True, _try_wave
        # commits waves immediately (decided_wave advances, protocol
        # progress is unaffected) but queues the ordering/delivery walk
        # for :meth:`flush_deliveries` — the only host work with no
        # causal dependency on an in-flight verify dispatch, so a caller
        # can run it while the device crunches the next batch. Safe to
        # defer: an admitted leader's entire causal history is already
        # present (buffer admission gate), so the closure is identical
        # whenever it runs, and FIFO flushing preserves delivery order.
        self.defer_delivery = False
        self._deferred_orders: Deque = deque()
        # -- pipelined waves + eager delivery ---------------
        #: cfg.wave_pipeline: every undecided wave whose commit round
        #: holds a quorum is (re)attempted each step by
        #: _try_waves_pipelined instead of once at the 4-round boundary.
        self._pipelined_waves = bool(cfg.wave_pipeline)
        #: vertices dispatched through a hold-tail verifier window whose
        #: masks have not come back yet (FIFO = dispatch = resolve order)
        self._verify_owed: Deque[Vertex] = deque()
        #: waves whose boundary-equivalent attempt (round counter at or
        #: past the commit round) has been taken — the pipelined twin of
        #: the oracle's _waves_tried one-shot bookkeeping
        self._waves_spent: Set[int] = set()
        #: wave -> (round_size(r4), round_size(r1)) at the last early
        #: attempt; votes and leader presence are pure functions of
        #: those fills, so an unchanged pair means an unchanged verdict
        self._wave_try_memo: Dict[int, tuple] = {}
        #: cfg.eager_deliver: speculative delivery log + its own dense
        #: mask (the eager twin of delivered_log/_delivered_mask) and
        #: the reconciliation cursor _order_vertices advances
        self._eager = bool(cfg.eager_deliver)
        self.eager_log: List[VertexID] = []
        self._eager_cursor = 0
        self._eager_mask = (
            np.zeros_like(self.dag.exists) if self._eager else None
        )
        if self._eager:
            # visible-at-zero gauges: "0 mismatches" must be
            # distinguishable from "eager path absent" in snapshots
            self.metrics.counters["eager_rollbacks_expected_zero"] = 0
            self.metrics.counters["eager_delivered"] = 0
            # Cert-quorum optimism needs no extra wiring here: a
            # certificate applied in _apply_certificate admits its
            # round inside the same step() loop, so the pipelined wave
            # pass decides — and the eager surface fires — the moment
            # the round-certificate quorum forms. The CertVerifier's
            # on_certified seam (verifier/cert.py) is for SINGLE-owner
            # stacks (node.py); the simulator's verifier is shared.

        transport.subscribe(index, self.on_message)

    @staticmethod
    def _default_coin(cfg: Config) -> CommonCoin:
        if cfg.coin == "fixed":
            return FixedCoin(0)
        if cfg.coin == "round_robin":
            return RoundRobinCoin(cfg.n)
        raise ValueError(
            "threshold_bls coin must be constructed explicitly with keys"
        )

    @property
    def buffer(self) -> List[Vertex]:
        """Buffered vertices awaiting predecessors.

        Scalar mode stores a flat arrival-order list; vector mode stores
        per-round groups (the drain key) and flattens on demand —
        round-ascending, arrival order within a round — for external
        readers (checkpoint save, sync targeting, tests). The setter
        accepts a flat list either way (checkpoint restore assigns one).
        """
        if self._vector:
            out: List[Vertex] = []
            for r in sorted(self._buffer_rounds):
                out.extend(self._buffer_rounds[r].values())
            return out
        return self._buffer

    @buffer.setter
    def buffer(self, vs: List[Vertex]) -> None:
        if self._vector:
            groups: Dict[int, Dict[int, Vertex]] = {}
            for v in vs:
                groups.setdefault(v.id.round, {})[v.id.source] = v
            self._buffer_rounds = groups
        else:
            self._buffer = vs

    # ------------------------------------------------------------------
    # Client API (Algorithm 1 lines 1-4)
    # ------------------------------------------------------------------

    def submit(self, block: Block) -> None:
        """Enqueue a client block for proposal — the missing writer of the
        reference's ``blocksToPropose`` (D7, ``process.go:80``) — and kick
        the state machine: with ``propose_empty=False`` a quiescent cluster
        must be able to resume on submission alone.

        With dissemination lanes attached the block's payload starts its
        lane round-trip here, so the dissemination overlaps the
        submit→propose gap; the inline enqueue is the oracle (and the
        degradation target for any block a lane cannot certify)."""
        if self.lanes is not None:
            self._submit_via_lanes(block)
        else:
            self._submit_inline(block)

    def _submit_inline(self, block: Block) -> None:
        """The oracle path: the payload block itself rides the vertex."""
        self.blocks_to_propose.append(block)
        if self._started:
            self.step()

    def _submit_via_lanes(self, block: Block) -> None:
        """Lane path: start the payload publish on the lane
        workers and queue the pending handle in the block's submission
        slot — proposal-time materialization keeps the carrier in
        exactly the round the inline block would have taken, which is
        what makes lanes-vs-inline byte-identity provable. Blocks the
        lane refuses (undersized, magic-aliasing) ship inline."""
        if any(
            tx.startswith(EPOCH_MAGIC) for tx in block.transactions
        ):
            # Epoch control transactions must ride the vertex
            # itself: the boundary scan reads delivered blocks, and a
            # lane carrier would hide the magic behind a payload ref
            # that stragglers resolve at different times.
            self._submit_inline(block)
            return
        pending = self.lanes.begin_publish(block)
        if pending is None:
            self._submit_inline(block)
            return
        self.blocks_to_propose.append(pending)
        if self._started:
            self.step()

    def attach_lanes(self, coordinator) -> None:
        """Wire a LaneCoordinator (post-construction, like the eager
        sink): subsequent submits disseminate payloads via lanes and
        deliveries resolve carrier refs back to payload bytes."""
        self.lanes = coordinator

    def start(self) -> None:
        """Begin participating: advance from the genesis round."""
        self._started = True
        self.step()

    # ------------------------------------------------------------------
    # r_deliver path (Algorithm 2 lines 1-4)
    # ------------------------------------------------------------------

    def on_message(self, msg: BroadcastMessage) -> None:
        """Reliable-broadcast delivery of a remote vertex.

        The reference trusts message stamps outright (D10,
        ``process.go:159-162``); here the stamps must match the (signed)
        vertex identity, and the signature is checked before the vertex can
        influence any state.
        """
        self.metrics.inc("msgs_received")
        if msg.kind != "val" or msg.vertex is None:
            self._on_control(msg)
            return
        if self.epoch_mgr is not None and msg.epoch < self.epoch_mgr.epoch:
            self._epoch_reject_stale(msg)
            return
        if self._vector:
            # Defer the admission checks to step(): nothing between
            # delivery and the next step reads the state those checks
            # write (the DAG only mutates inside step, and sync serving
            # reads the DAG, not the inbox), so running them batched at
            # the step boundary is observationally identical to running
            # them here — in FIFO order either way.
            self._inbox.append(msg)
            if not self.defer_steps:
                if self._started:
                    self.step()
                else:
                    # not started: run the checks now (scalar counters
                    # and pending/buffer state stay exactly in sync)
                    # without stepping
                    self._process_inbox()
            return
        v = msg.vertex
        if (
            v.id.round != msg.round
            or v.id.source != msg.sender
            or not 0 <= v.id.source < self.cfg.n
            or v.id.round < 1
        ):
            self.metrics.inc("msgs_rejected_stamp")
            self.log.event(
                "reject_stamp", round=msg.round, sender=msg.sender
            )
            return
        if v.id.round <= self.dag.base_round:
            # At/below the GC floor: retired everywhere, unadmittable
            # here — drop BEFORE digest/verify/coin-share observation, or
            # replayed old VALs would re-feed the books the prune just
            # retired and burn verify work.
            self.metrics.inc("msgs_below_gc_horizon")
            return
        pooled = self._cert_pool.get(v.id.round) if self._cert else None
        if (
            self.dag.present(v.id)
            or v.id in self._buffered_ids
            or v.id in self._pending_verify_ids
            or (pooled is not None and v.id.source in pooled)
        ):
            row = self._seen_digests.get(v.id.round)
            prev = row[v.id.source] if row is not None else None
            if prev is not None and prev != v.digest():
                # same (round, source), different content — equivocation.
                self.metrics.inc("equivocations_detected")
                self.log.event(
                    "equivocation", round=v.round, source=v.source
                )
            else:
                self.metrics.inc("msgs_duplicate")
            return
        if not self.edges_valid(v):
            self.metrics.inc("msgs_rejected_edges")
            self.log.event(
                "reject_edges",
                round=v.round,
                source=v.source,
                strong=len(v.strong_edges),
                weak=len(v.weak_edges),
            )
            return
        self._note_seen(v)
        if self.verifier is not None:
            if (
                self._cert
                and v.id.round % self.cfg.n != self.index
                and v.id.round not in self._cert_done
            ):
                # await this round's certificate instead of paying a
                # per-vertex verify; patience degrades us back if the
                # aggregator never delivers
                self._cert_pool.setdefault(v.id.round, {})[v.id.source] = v
            else:
                self._pending_verify.append(v)
                self._pending_verify_ids.add(v.id)
        else:
            self._admit_to_buffer(v)
        if self._started and not self.defer_steps:
            self.step()

    def _on_control(self, msg: BroadcastMessage) -> None:
        """Non-VAL dispatch, shared by both pump paths (the caller has
        already counted msgs_received)."""
        if (
            self.epoch_mgr is not None
            and msg.epoch < self.epoch_mgr.epoch
            and (msg.kind == "cert" or msg.kind == "cert_span")
        ):
            # Signed pre-rotation consensus traffic replayed after the
            # boundary: reject at the seam. sync/sync_nack
            # stay exempt — a straggler's sync probe is how it learns it
            # is behind and enters the state-transfer path.
            self._epoch_reject_stale(msg)
            return
        if msg.kind == "sync":
            self._serve_sync(msg)
        elif msg.kind == "sync_nack":
            self._on_sync_nack(msg)
        elif msg.kind == "cert":
            self._on_certificate(msg)
        elif msg.kind == "cert_span":
            self._on_span(msg)
        else:
            # RBC control traffic (echo/ready/fetch) is consumed by the
            # transport/rbc.py stage; a Process only eats vertex payloads.
            self.metrics.inc("msgs_ignored_kind")

    def on_messages(self, batch: List[BroadcastMessage]) -> None:
        """Batch delivery entry (transport ``pump_grouped``): one call
        per destination per pump chunk instead of one handler dispatch
        per message. Scalar mode degrades to the per-message path;
        vector mode queues VALs for the batched inbox checks and runs
        ONE step for the whole batch."""
        if not batch:
            return
        if not self._vector:
            for m in batch:
                self.on_message(m)
            return
        self.metrics.inc("msgs_received", len(batch))
        inbox = self._inbox
        for m in batch:
            if m.kind != "val" or m.vertex is None:
                # mixed batch (network codec frames): fall back to the
                # per-message split so controls dispatch in position
                for m2 in batch:
                    if m2.kind == "val" and m2.vertex is not None:
                        inbox.append(m2)
                    else:
                        self._on_control(m2)
                break
        else:
            # pure VAL run — one C-level extend
            inbox.extend(batch)
        if not self.defer_steps:
            if self._started:
                self.step()
            else:
                self._process_inbox()

    def on_val_batch(self, batch: List[BroadcastMessage]) -> None:
        """Grouped-pump fast entry (vector mode): the broker guarantees
        a pure VAL run (controls are delivered singly as barriers), so
        the batch goes straight to the inbox with no per-message kind
        scan. :meth:`on_messages` stays the kind-agnostic entry for
        codec-decoded network frames."""
        self.metrics.inc("msgs_received", len(batch))
        self._inbox.extend(batch)
        if not self.defer_steps:
            if self._started:
                self.step()
            else:
                self._process_inbox()

    def _process_inbox(self) -> None:
        """Run the deferred VAL admission checks (vector mode) — the
        exact scalar on_message sequence per message, in FIFO order,
        with the per-message constants hoisted and everything the
        broadcast shares across the n-1 sibling processes memoized on
        the message/vertex objects (stamp verdict, edge gate, digest).
        The body is deliberately inline — at n=256 one round is ~65k
        copies through this loop, and every helper call or re-probed
        attribute showed up as ~0.5 us x 65k x rounds in the profile."""
        inbox, self._inbox = self._inbox, []
        n = self.cfg.n
        gate_key = (n, self.cfg.quorum)
        wave_len = self.cfg.wave_length
        dag = self.dag
        base = dag.base_round  # nothing in this loop prunes
        exists = dag.exists
        n_rows = exists.shape[0]
        groups = self._buffer_rounds
        pending = self._pending_verify_ids
        seen = self._seen_digests
        metrics_inc = self.metrics.inc
        verifier = self.verifier
        observe_share = self.coin.observe_share
        cert_on = self._cert
        cert_pool = self._cert_pool
        cert_done = self._cert_done
        my_index = self.index
        cur_epoch = (
            self.epoch_mgr.epoch if self.epoch_mgr is not None else None
        )
        last_r = -1  # round-group cache: batches arrive in same-round runs
        grp: Optional[Dict[int, Vertex]] = None
        seen_row: Optional[List[Optional[bytes]]] = None
        exists_row: Optional[list] = None
        pool_row: Optional[Dict[int, Vertex]] = None
        pool_this = False
        for msg in inbox:
            if cur_epoch is not None and msg.epoch < cur_epoch:
                self._epoch_reject_stale(msg)
                continue
            v = msg.vertex
            ok = msg.__dict__.get("_stamp_ok")
            if ok is None or ok[0] != n:
                ok = (
                    n,
                    v.id.round == msg.round
                    and v.id.source == msg.sender
                    and 0 <= v.id.source < n
                    and v.id.round >= 1,
                )
                object.__setattr__(msg, "_stamp_ok", ok)
            if not ok[1]:
                metrics_inc("msgs_rejected_stamp")
                self.log.event(
                    "reject_stamp", round=msg.round, sender=msg.sender
                )
                continue
            vid = v.id
            r = vid.round
            if r <= base:
                metrics_inc("msgs_below_gc_horizon")
                continue
            if r != last_r:
                last_r = r
                grp = groups.get(r)
                # presence snapshot: nothing in this loop inserts into
                # the dag, so one .tolist() per round-run turns the
                # per-message VertexID dict probe into a C list index
                # (the n=256 host profile: those probes were ~0.5s of the
                # remaining 2.9s at n=256)
                rr = r - base
                exists_row = exists[rr].tolist() if rr < n_rows else None
                seen_row = seen.get(r)
                pool_row = cert_pool.get(r) if cert_on else None
                pool_this = (
                    cert_on and r % n != my_index and r not in cert_done
                )
            src = vid.source
            if (
                (exists_row is not None and exists_row[src])
                or (grp is not None and src in grp)
                or (pool_row is not None and src in pool_row)
                or (pending and vid in pending)
            ):
                prev = seen_row[src] if seen_row is not None else None
                if prev is not None and prev != v.digest():
                    metrics_inc("equivocations_detected")
                    self.log.event(
                        "equivocation", round=r, source=src
                    )
                else:
                    metrics_inc("msgs_duplicate")
                continue
            g = v.__dict__.get("_gate")
            if g is not None and g[0] == gate_key:
                valid = not g[1]
            else:
                valid = self.edges_valid(v)
            if not valid:
                metrics_inc("msgs_rejected_edges")
                self.log.event(
                    "reject_edges",
                    round=r,
                    source=vid.source,
                    strong=len(v.strong_edges),
                    weak=len(v.weak_edges),
                )
                continue
            if seen_row is None:
                seen_row = seen[r] = [None] * n
            seen_row[src] = v.__dict__.get("_digest") or v.digest()
            if verifier is not None:
                if pool_this:
                    if pool_row is None:
                        pool_row = cert_pool[r] = {}
                    pool_row[src] = v
                else:
                    self._pending_verify.append(v)
                    pending.add(vid)
            else:
                if grp is None:
                    grp = groups[r] = {}
                grp[src] = v
                cs = v.coin_share
                if cs is not None and r % wave_len == 0:
                    observe_share(r // wave_len, src, cs)

    def edges_valid(self, v: Vertex) -> bool:
        """The r_deliver admission gate: >= 2f+1 distinct strong edges
        (process.go:164-168), all targeting round-1, all sources in
        [0, n) — a Byzantine vertex must not be able to index outside the
        dense mirrors (negative sources would silently alias via numpy
        wraparound), and every downstream fancy-index (dag.insert,
        _drain_buffer) relies on this gate having run. Vectorized over
        the memoized edge arrays and memoized on the vertex: the result
        is a pure function of (vertex, n, quorum), so the n-1 sibling
        processes of an in-process cluster reuse it instead of
        re-scanning ~2f+1 edges each."""
        vr = v.id.round
        gate_key = (self.cfg.n, self.cfg.quorum)
        cached_gate = v.__dict__.get("_gate")
        if cached_gate is not None and cached_gate[0] == gate_key:
            return not cached_gate[1]
        sr, ss, wr, ws = v.edge_arrays()
        n_cfg = self.cfg.n
        bad_edges = bool(
            len(np.unique(ss)) < self.cfg.quorum
            or (sr != vr - 1).any()
            or (ss < 0).any()
            or (ss >= n_cfg).any()
            or (wr < 1).any()
            or (wr > vr - 2).any()
            or (ws < 0).any()
            or (ws >= n_cfg).any()
        )
        object.__setattr__(v, "_gate", (gate_key, bad_edges))
        return not bad_edges

    def _admit_to_buffer(self, v: Vertex) -> None:
        if self._vector:
            self._buffer_rounds.setdefault(v.id.round, {})[v.id.source] = v
        else:
            self._buffer.append(v)
            self._buffered_ids.add(v.id)
        self._observe_coin_share(v)

    def _remove_from_buffer(self, vid: VertexID) -> None:
        """Single site for buffer-exit bookkeeping: the id set and the
        blocked-vertex memo must leave together, or a later drain pass
        resurrects a stale short-circuit for a vertex that is long gone
        (the storage list/group entry is dropped by the drain itself)."""
        self._buffered_ids.discard(vid)
        self._blocked_on.pop(vid, None)

    def _observe_coin_share(self, v: Vertex) -> None:
        if v.coin_share is not None and v.round % self.cfg.wave_length == 0:
            wave = v.round // self.cfg.wave_length
            self.coin.observe_share(wave, v.source, v.coin_share)

    def take_verify_batch(self) -> List[Vertex]:
        """Pop the pending-verify queue without verifying — the collect
        half of cross-process dispatch coalescing: a caller that owns
        several processes sharing one device Verifier gathers every
        process's batch and issues ONE merged dispatch
        (Verifier.verify_rounds), then hands each mask back through
        :meth:`apply_verify_mask`. Per-vertex accept bits are a pure
        function of (vertex bytes, registry), so coalescing cannot change
        any process's behavior."""
        batch, self._pending_verify = self._pending_verify, []
        self._pending_verify_ids.clear()
        return batch

    def apply_verify_mask(
        self, batch: List[Vertex], ok: List[bool], seconds: float
    ) -> None:
        """Admit/reject a previously collected batch (apply half of the
        coalescing protocol; also the tail of :meth:`_drain_verify`)."""
        self.metrics.observe_verify_batch(len(batch), seconds)
        cert = self._cert
        n = self.cfg.n
        for v, good in zip(batch, ok):
            if good:
                self._admit_to_buffer(v)
                if (
                    cert
                    and v.cert_sig is not None
                    and v.id.round % n == self.index
                    and v.id.round not in self._certs_sent
                ):
                    # we are this round's designated aggregator: bank the
                    # directly verified share for certificate assembly
                    self._cert_stash.setdefault(v.id.round, {})[
                        v.id.source
                    ] = (v.digest(), v.cert_sig)
            else:
                self.metrics.inc("msgs_rejected_signature")
                self.log.event(
                    "reject_signature", round=v.round, source=v.source
                )

    def _drain_verify(self) -> None:
        """Batch-verify queued vertices through the Verifier seam — one
        whole batch per dispatch (the north-star shape).

        Under cfg.wave_pipeline with a windowed verifier (node.py wires
        a VerifierPipeline directly as ``self.verifier``), the dispatch
        window spans pump cycles: each pass ships
        this cycle's batch with ``hold_tail=True`` so up to depth-1
        chunks stay in flight on the device while the host runs the
        next transport pump, and applies whatever masks resolved —
        which cover the OLDEST owed vertices in FIFO dispatch order.
        :meth:`_flush_verify_owed` settles the remainder at quiescence,
        so admission is only ever deferred, never lost. The lockstep
        simulator keeps its own full-drain coalescing path
        (take_verify_batch/apply_verify_mask) — byte-identity of its
        A/B runs is argued there."""
        if not self._pending_verify:
            return
        batch = self.take_verify_batch()
        rc = getattr(self.verifier, "run_coalesced", None)
        if (
            self._pipelined_waves
            and callable(rc)
            and callable(getattr(self.verifier, "drain", None))
        ):
            with Timer() as t:
                ok = rc(batch, hold_tail=True)
            self._verify_owed.extend(batch)
            if ok:
                front = [
                    self._verify_owed.popleft() for _ in range(len(ok))
                ]
                self.apply_verify_mask(front, ok, t.seconds)
            return
        with Timer() as t:
            ok = self.verifier.verify_batch(batch)
        self.apply_verify_mask(batch, ok, t.seconds)

    def _flush_verify_owed(self) -> bool:
        """Resolve every mask still held across pump cycles by the
        hold-tail window (see :meth:`_drain_verify`) and admit/reject
        the owed vertices. Called at step() quiescence: when no other
        transition can fire, the held tail is the only possible source
        of progress left."""
        if not self._verify_owed:
            return False
        with Timer() as t:
            ok = self.verifier.drain()
        front = [self._verify_owed.popleft() for _ in range(len(ok))]
        self.apply_verify_mask(front, ok, t.seconds)
        return bool(front)

    # ------------------------------------------------------------------
    # Aggregated round certificates
    # ------------------------------------------------------------------
    # Round r's designated aggregator is process r % n. It verifies the
    # round's vertices directly (the per-vertex oracle path), then sums
    # the quorum's BLS shares into ONE certificate and gossips it; every
    # other process parks round-r vertices in _cert_pool and admits them
    # on one aggregate check instead of n signature verifies. A bad or
    # missing certificate degrades that round back to per-vertex — the
    # resilient.py ladder shape applied to the protocol layer.

    def _note_seen(self, v: Vertex) -> None:
        """Record ``v``'s digest in the per-round equivocation book."""
        row = self._seen_digests.get(v.id.round)
        if row is None:
            row = self._seen_digests[v.id.round] = [None] * self.cfg.n
        row[v.id.source] = v.digest()

    def _on_certificate(self, msg: BroadcastMessage) -> None:
        """Queue a received round certificate; application runs in
        :meth:`step` after the deferred inbox drains, so a certificate
        can never outrun the VALs it covers."""
        cert = msg.cert
        if not self._cert or cert is None:
            self.metrics.inc("msgs_ignored_kind")
            return
        if (
            cert.round < 1
            or cert.round <= self.dag.base_round
            or cert.round in self._cert_done
        ):
            self.metrics.inc("certs_ignored")
            return
        self._pending_certs.append(cert)
        if self._started and not self.defer_steps:
            self.step()

    def _on_span(self, msg: BroadcastMessage) -> None:
        """Queue a received cert-of-certs; like round certificates,
        application is deferred to :meth:`step`. Shape gating is strict —
        a span must be exactly this deployment's epoch geometry."""
        span = msg.span
        if not self._cert or not self._span or span is None:
            self.metrics.inc("msgs_ignored_kind")
            return
        k = self._span
        if (
            span.first_round < 1
            or len(span.signers) != k
            or (span.first_round - 1) % k != 0
            or span.last_round <= self.dag.base_round
            or (span.first_round - 1) // k in self._span_done
        ):
            self.metrics.inc("spans_ignored")
            return
        self._pending_spans.append(span)
        if self._started and not self.defer_steps:
            self.step()

    def _cert_step(self) -> bool:
        """Apply queued span + round certificates and assemble ours when
        enough material is banked. Returns True when anything admitted
        vertices (buffer progress). Spans apply first so a round they
        settle skips its (now redundant) per-round check this step."""
        progress = False
        if self._pending_spans:
            spans, self._pending_spans = self._pending_spans, []
            for span in spans:
                progress |= self._apply_span(span)
        if self._pending_certs:
            certs, self._pending_certs = self._pending_certs, []
            fresh: List[RoundCertificate] = []
            seen: Set[tuple] = set()
            for c in certs:
                key = c.signing_key()
                if (
                    c.round > self.dag.base_round
                    and c.round not in self._cert_done
                    and key not in seen
                ):
                    seen.add(key)
                    fresh.append(c)
            # two or more live certificates in one step share ONE
            # combined product check (verify_many), with per-cert
            # localization when the combined check fails
            verdicts = (
                self.cert_verifier.verify_many(fresh)
                if len(fresh) >= 2
                else [None] * len(fresh)
            )
            for cert, ok in zip(fresh, verdicts):
                progress |= self._apply_certificate(cert, ok)
        if self._cert_stash:
            self._maybe_assemble_certs()
        if self._span and self._span_bank:
            self._maybe_assemble_spans()
        return progress

    def _apply_certificate(
        self, cert: RoundCertificate, valid: Optional[bool] = None
    ) -> bool:
        r = cert.round
        if r <= self.dag.base_round or r in self._cert_done:
            return False
        if valid is None:
            valid = self.cert_verifier.verify_certificate(cert)
        if not valid:
            # forged aggregate / bad bitmap / substituted digests: reject
            # and fall back to per-vertex verifies for the whole round
            self.metrics.inc("certs_rejected")
            self.log.event("cert_reject", round=r)
            self._degrade_cert_round(r)
            return False
        self.metrics.inc("certs_verified")
        self._bank_span_cert(cert)
        pool = self._cert_pool.pop(r, None) or {}
        self._cert_done.add(r)
        self._cert_wait.pop(r, None)
        covered = dict(zip(cert.signers, cert.digests))
        admitted = False
        for src, v in pool.items():
            d = covered.get(src)
            if d is not None and d == (
                v.__dict__.get("_digest") or v.digest()
            ):
                # certificate-admitted: enters the DAG through the
                # trusted buffer/insert_many path, no per-vertex verify
                self._admit_to_buffer(v)
                self.metrics.inc("sigs_saved")
                admitted = True
            else:
                # pooled copy the certificate doesn't vouch for — the
                # per-vertex oracle decides
                self._pending_verify.append(v)
                self._pending_verify_ids.add(v.id)
        return admitted

    def _degrade_cert_round(self, r: int) -> None:
        """agg -> per-vertex degradation rung: route the round's pooled
        vertices through the normal verify queue. A Byzantine aggregator
        costs a round its fast path, never its liveness."""
        pool = self._cert_pool.pop(r, None)
        self._cert_done.add(r)
        self._cert_wait.pop(r, None)
        self.metrics.inc("cert_rounds_degraded")
        self.log.event(
            "cert_degraded", round=r, pooled=len(pool) if pool else 0
        )
        if pool:
            for v in pool.values():
                self._pending_verify.append(v)
                self._pending_verify_ids.add(v.id)
        if self._span:
            # a degraded round's certificate will never be banked, so a
            # partially banked epoch covering it can never complete —
            # abandon it (the span is an overlay; nothing to degrade)
            e = (r - 1) // self._span
            if self._span_bank.pop(e, None) is not None:
                self._span_wait.pop(e, None)
                self._span_done.add(e)

    def _cert_tick(self) -> bool:
        """One patience tick for every round still waiting on its
        certificate; expired rounds degrade. Returns True when anything
        degraded (there is now per-vertex work to drain). Partial span
        banks age here too — k rounds' worth of patience, since an epoch
        legitimately spans k certificate latencies."""
        if self._span and self._span_bank:
            stale = []
            for e in self._span_bank:
                w = self._span_wait.get(e, 0) + 1
                self._span_wait[e] = w
                if w > self.cfg.cert_patience * self._span:
                    stale.append(e)
            for e in stale:
                del self._span_bank[e]
                self._span_wait.pop(e, None)
                self._span_done.add(e)
                self.metrics.inc("span_timeouts")
                self.log.event("span_timeout", epoch=e)
        if not self._cert_pool:
            return False
        patience = self.cfg.cert_patience
        timed_out = []
        for r in self._cert_pool:
            w = self._cert_wait.get(r, 0) + 1
            self._cert_wait[r] = w
            if w > patience:
                timed_out.append(r)
        for r in timed_out:
            self.metrics.inc("cert_timeouts")
            self.log.event("cert_timeout", round=r)
            self._degrade_cert_round(r)
        return bool(timed_out)

    # -- cert-of-certs ---------------------------

    def _bank_span_cert(self, cert: RoundCertificate) -> None:
        """Bank a VERIFIED (or self-assembled) round certificate toward
        its epoch's cert-of-certs — span-aggregator side only."""
        k = self._span
        if not k:
            return
        e = (cert.round - 1) // k
        if (
            e % self.cfg.n != self.index
            or e in self._spans_sent
            or e in self._span_done
        ):
            return
        self._span_bank.setdefault(e, {})[cert.round] = cert

    def _maybe_assemble_spans(self) -> None:
        """Fold a fully banked epoch into one SpanCertificate and gossip
        it. The bank is keyed by round inside the epoch's k-round window,
        so len == k means gap-free coverage."""
        k = self._span
        for e in sorted(self._span_bank):
            bank = self._span_bank[e]
            if len(bank) < k:
                continue
            del self._span_bank[e]
            self._span_wait.pop(e, None)
            if e in self._spans_sent:
                continue
            self._spans_sent.add(e)
            first = e * k + 1
            span = self.cert_verifier.make_span(
                first, [bank[r] for r in sorted(bank)]
            )
            if span is None:
                continue
            # pre-gossip self-check, knob-gated like the round-cert one
            if self.cfg.cert_selfcheck and not self.cert_verifier.verify_span(
                span
            ):
                continue
            # the aggregator banks its own span for snapshot attestation
            # — receivers bank verified spans in _apply_span
            self._span_chain[e] = span
            self.metrics.inc("spans_assembled")
            self.log.event("span_assembled", first_round=first, rounds=k)
            self.transport.broadcast(
                BroadcastMessage(
                    vertex=None,
                    round=span.last_round,
                    sender=self.index,
                    kind="cert_span",
                    span=span,
                    epoch=self._wire_epoch,
                )
            )

    def _apply_span(self, span: SpanCertificate) -> bool:
        """Settle every covered round still awaiting its certificate with
        the span's ONE combined check. Rounds already settled (cert
        applied, degraded, or pruned) are left alone — a span never
        un-decides anything, and a receiver never waits for one."""
        k = self._span
        e = (span.first_round - 1) // k
        if span.last_round <= self.dag.base_round or e in self._span_done:
            return False
        pending = [
            r
            for r in range(span.first_round, span.last_round + 1)
            if r > self.dag.base_round and r not in self._cert_done
        ]
        if not pending:
            self.metrics.inc("spans_ignored")
            return False
        if not self.cert_verifier.verify_span(span):
            # no degradation: the per-round certificates remain the
            # covered rounds' liveness anchor, so a bad span costs
            # nothing but this check
            self.metrics.inc("spans_rejected")
            self.log.event("span_reject", first_round=span.first_round)
            return False
        self.metrics.inc("spans_verified")
        self._span_done.add(e)
        self._span_chain[e] = span
        admitted = False
        for r in pending:
            covered = dict(
                zip(
                    span.signers[r - span.first_round],
                    span.digests[r - span.first_round],
                )
            )
            pool = self._cert_pool.pop(r, None) or {}
            self._cert_done.add(r)
            self._cert_wait.pop(r, None)
            self.metrics.inc("span_rounds_settled")
            for src, v in pool.items():
                d = covered.get(src)
                if d is not None and d == (
                    v.__dict__.get("_digest") or v.digest()
                ):
                    self._admit_to_buffer(v)
                    self.metrics.inc("sigs_saved")
                    admitted = True
                else:
                    self._pending_verify.append(v)
                    self._pending_verify_ids.add(v.id)
        return admitted

    def _maybe_assemble_certs(self) -> None:
        quorum = self.cfg.quorum
        for r in sorted(self._cert_stash):
            entries = self._cert_stash[r]
            if len(entries) < quorum:
                continue
            del self._cert_stash[r]
            if r in self._certs_sent:
                continue
            self._certs_sent.add(r)
            cert = self.cert_verifier.make_certificate(
                r, [(src, d, sig) for src, (d, sig) in entries.items()]
            )
            if cert is None:
                continue
            # Self-check before gossip: the shared verifier memoizes the
            # verdict by certificate content, so in-process receivers'
            # checks are dict hits — the cluster pays each aggregate
            # pairing once (mirrors the simulator's dedup'd verify).
            # Knob-gated (DAGRIDER_CERT_SELFCHECK): off trades early
            # local-corruption detection for assembly latency; peers
            # verify independently either way, so safety is unchanged.
            if self.cfg.cert_selfcheck and not self.cert_verifier.verify_certificate(
                cert
            ):
                continue
            self._bank_span_cert(cert)
            self.metrics.inc("certs_assembled")
            self.log.event("cert_assembled", round=r, signers=len(cert.signers))
            self.transport.broadcast(
                BroadcastMessage(
                    vertex=None,
                    round=r,
                    sender=self.index,
                    kind="cert",
                    cert=cert,
                    epoch=self._wire_epoch,
                )
            )

    # ------------------------------------------------------------------
    # The progress engine (Algorithm 2 lines 5-15)
    # ------------------------------------------------------------------

    def step(self) -> None:
        """Drive the state machine until quiescent.

        The reference's main loop busy-spins and its round-advance block is
        dead code after an infinite loop (D3, ``process.go:200-245``); here
        buffer-drain, round advancement, wave commits and proposals repeat
        until no further progress is possible.
        """
        made_progress = False
        progress = True
        cert_ticked = False
        while progress:
            progress = False
            if self._inbox:
                self._process_inbox()
            if self._cert:
                if self.log.enabled:
                    t0 = _time.perf_counter()
                    progress |= self._cert_step()
                    self.log.event(
                        "phase_cert", dur_s=_time.perf_counter() - t0
                    )
                else:
                    progress |= self._cert_step()
            self._drain_verify()
            progress |= self._drain_buffer()
            progress |= self._try_advance()
            if self._pipelined_waves:
                progress |= self._try_waves_pipelined()
            progress |= self._retry_pending_waves()
            if self.epoch_mgr is not None:
                progress |= self._epoch_retry_held_waves()
                live = int(self.dag.exists.sum())
                if live > self.metrics.counters["vertices_live_max"]:
                    self.metrics.counters["vertices_live_max"] = live
            made_progress |= progress
            if not progress and self._verify_owed:
                # quiescent with masks still in the hold-tail window:
                # settle them now — the held tail is the only remaining
                # source of admissions
                progress |= self._flush_verify_owed()
            if not progress and self._cert and not cert_ticked:
                # one patience tick per step(), taken only at quiescence
                # so a timeout-degraded round drains in THIS step
                cert_ticked = True
                progress |= self._cert_tick()
        self._maybe_request_sync(made_progress)

    def _drain_buffer(self) -> bool:
        """Admit buffered vertices whose predecessors are all present
        (Alg. 2 lines 6-10, quoted at reference ``process.go:189-195``).

        A vertex from a future round stays buffered (``process.go:203-206``);
        repeated passes handle chains unlocked by an admission.
        """
        if self._vector:
            return self._drain_buffer_vector()
        admitted_any = False
        changed = True
        log_admit = self.log.wants("admit")
        present = self.dag.present
        # Short-circuit memo: the first still-missing predecessor seen for
        # each blocked vertex. While that one vertex is absent the full
        # ~2f+1-edge scan must fail too, so repeated drain passes check
        # ONE id instead of every edge (identical admission decisions —
        # the memo only skips work when the outcome is already known).
        blocked = self._blocked_on
        while changed:
            changed = False
            exists = self.dag.exists  # re-fetch: capacity growth reallocates
            base = self.dag.base_round
            keep: List[Vertex] = []
            # Pass 1: cheap filters; survivors become candidates for ONE
            # vectorized predecessor check over the whole buffer.
            cand: List[Vertex] = []
            cand_arrs = []
            for v in self._buffer:
                vid = v.id
                if vid.round > self.round:
                    keep.append(v)
                    continue
                if vid.round <= base:
                    # Below the pruned floor: its predecessors are retired
                    # and the GC ordering rule excludes it from delivery
                    # anywhere — unadmittable, drop it. (No re-pass: a
                    # drop adds nothing to the DAG, so it cannot unlock
                    # any other vertex's predecessor check.)
                    self._remove_from_buffer(vid)
                    self.metrics.inc("msgs_below_gc_horizon")
                    continue
                if present(vid):
                    # raced in via another path; drop rather than
                    # re-insert (no re-pass — see above)
                    self._remove_from_buffer(vid)
                    self.metrics.inc("msgs_duplicate")
                    continue
                bp = blocked.get(vid)
                if (
                    bp is not None
                    and bp.round > base
                    and not present(bp)
                ):
                    keep.append(v)
                    continue
                # (a memoized blocker at/below the pruned floor falls
                # through to full re-evaluation: the weak-target-below-
                # base satisfaction rule below must get its chance, or a
                # vertex blocked before a prune would wait forever on a
                # round nobody can serve anymore)
                cand.append(v)
                cand_arrs.append(v.edge_arrays())
            # Pass 2: strong-predecessor check for ALL candidates in one
            # fancy index + one segmented reduce against the dense mirror
            # (edge rounds/sources are gate-validated in [0, n) and below
            # v.round <= self.round < capacity, so the index cannot
            # alias). The per-candidate numpy-call version of this check
            # was ~half the n=256 host profile. Admissions land in pass 3
            # AFTER this snapshot; a candidate whose predecessor is
            # admitted later in the same sweep just waits for the next
            # while-pass — same fixpoint, identical admitted set.
            if cand:
                lens = np.fromiter(
                    (a[1].size for a in cand_arrs),
                    dtype=np.intp,
                    count=len(cand),
                )
                rows = (
                    np.fromiter(
                        (v.id.round for v in cand),
                        dtype=np.intp,
                        count=len(cand),
                    )
                    - 1
                    - base
                )
                ss_cat = (
                    np.concatenate([a[1] for a in cand_arrs])
                    if len(cand) > 1
                    else cand_arrs[0][1]
                )
                hits = exists[np.repeat(rows, lens), ss_cat]
                offs = np.zeros(len(cand), dtype=np.intp)
                np.cumsum(lens[:-1], out=offs[1:])
                # every vertex carries >= quorum >= 1 strong edges (the
                # admission gate proved it), so no zero-length segment
                ok = np.bitwise_and.reduceat(hits, offs)
                # Pass 3: admit / memo the first missing blocker.
                for i, v in enumerate(cand):
                    if not ok[i]:
                        seg = hits[offs[i] : offs[i] + lens[i]]
                        k = int(np.argmin(seg))
                        blocked[v.id] = VertexID(
                            v.id.round - 1, int(cand_arrs[i][1][k])
                        )
                        keep.append(v)
                        continue
                    _, _, wr, ws = cand_arrs[i]
                    if wr.size:
                        if base:
                            # weak targets under the pruned floor are in
                            # finalized history — treated satisfied (they
                            # can never be re-fetched, and ordering never
                            # descends below the GC horizon).
                            w_live = wr > base
                            wr, ws = wr[w_live], ws[w_live]
                        if wr.size:
                            # live mirror, not the pass-2 snapshot: an
                            # insert below may have grown capacity
                            w_hit = self.dag.exists[wr - base, ws]
                            if not w_hit.all():
                                k = int(np.argmin(w_hit))
                                blocked[v.id] = VertexID(
                                    int(wr[k]), int(ws[k])
                                )
                                keep.append(v)
                                continue
                    self._remove_from_buffer(v.id)
                    self.dag.insert(v)
                    self.metrics.inc("vertices_admitted")
                    if log_admit:
                        self.log.event(
                            "admit", round=v.round, source=v.source
                        )
                    changed = True
                    admitted_any = True
            self._buffer = keep
        return admitted_any

    def _drain_buffer_vector(self) -> bool:
        """Round-batched buffer drain (the vector pump).

        Edges only ever target LOWER rounds (strong: r-1, weak: < r-1 —
        gate-enforced), so there are no intra-round dependencies and ONE
        ascending sweep over the round groups reaches the same fixpoint
        as the scalar while-changed loop: by the time round r is
        checked, every admissible vertex below it has been admitted.
        Per group the strong-predecessor check is one fancy index into a
        SINGLE ``exists`` row + one segmented AND, and admissions land
        as one :meth:`DagState.insert_many` batch. Admitted sets — and
        hence everything downstream — are identical to scalar; only the
        per-vertex bookkeeping is batched.
        """
        groups = self._buffer_rounds
        if not groups:
            return False
        admitted_any = False
        dag = self.dag
        n = self.cfg.n
        vertices = dag.vertices
        metrics_inc = self.metrics.inc
        log_on = self.log.wants("admit")
        for r in sorted(groups):
            if r > self.round:
                continue  # future round: stays buffered (process.go:203)
            grp = groups.pop(r)
            base = dag.base_round
            if r <= base:
                # Below the pruned floor: unadmittable everywhere — see
                # the scalar pass-1 comment.
                metrics_inc("msgs_below_gc_horizon", len(grp))
                continue
            exists_prev = dag.exists[r - 1 - base]
            if len(grp) > 1 and exists_prev.all():
                # Steady-state shape: round r-1 fully present, so every
                # strong probe passes — ONE pass over the group fuses
                # the duplicate filter with collecting the per-vertex
                # flat strong-row indices (memoized cluster-wide on the
                # shared vertex objects), and the whole batch lands as
                # one 1-D scatter in insert_many. A weak edge (rare
                # here: weak edges only exist for sources the proposer
                # could NOT reach) bails to the general path below.
                srcs: List[int] = []
                flats: List[np.ndarray] = []
                admit: List[Vertex] = []
                sa, fa, aa = srcs.append, flats.append, admit.append
                dups = 0
                weak_seen = False
                for v in grp.values():
                    if v.id in vertices:
                        dups += 1
                        continue
                    d = v.__dict__
                    a = d.get("_edge_arrays") or v.edge_arrays()
                    if a[2].size:
                        weak_seen = True
                        break
                    s = v.id.source
                    sa(s)
                    aa(v)
                    fs = d.get("_flat_strong")
                    if fs is None or fs[0] != n:
                        fs = (n, s * n + a[1])
                        object.__setattr__(v, "_flat_strong", fs)
                    fa(fs[1])
                if not weak_seen:
                    if dups:
                        metrics_inc("msgs_duplicate", dups)
                    if admit:
                        dag.insert_many(
                            admit, trusted=True, prepped=(srcs, flats)
                        )
                        metrics_inc("vertices_admitted", len(admit))
                        if log_on:
                            for v in admit:
                                self.log.event(
                                    "admit", round=v.round, source=v.source
                                )
                        admitted_any = True
                    continue
            live = [v for v in grp.values() if v.id not in vertices]
            dups = len(grp) - len(live)
            if dups:
                metrics_inc("msgs_duplicate", dups)
            if not live:
                continue
            arrs = [
                v.__dict__.get("_edge_arrays") or v.edge_arrays()
                for v in live
            ]
            if len(live) == 1:
                ok = (True,) if exists_prev[arrs[0][1]].all() else (False,)
            elif exists_prev.all():
                # full presence but weak edges in the group: every
                # strong probe passes; the loop below gates the weak
                ok = (True,) * len(live)
            else:
                lens = np.fromiter(
                    (a[1].size for a in arrs),
                    dtype=np.intp,
                    count=len(live),
                )
                hits = exists_prev[np.concatenate([a[1] for a in arrs])]
                offs = np.zeros(len(live), dtype=np.intp)
                np.cumsum(lens[:-1], out=offs[1:])
                # >= quorum >= 1 strong edges each (gate-proved), so
                # no zero-length segment
                ok = np.bitwise_and.reduceat(hits, offs)
            admit: List[Vertex] = []
            keep: List[Vertex] = []
            for i, v in enumerate(live):
                if not ok[i]:
                    keep.append(v)
                    continue
                wr, ws = arrs[i][2], arrs[i][3]
                if wr.size:
                    if base:
                        # weak targets under the pruned floor are
                        # finalized history — treated satisfied (scalar
                        # pass-3 rule)
                        w_live = wr > base
                        wr, ws = wr[w_live], ws[w_live]
                    if wr.size and not dag.exists[wr - base, ws].all():
                        keep.append(v)
                        continue
                admit.append(v)
            if admit:
                # the drain already proved single-round grouping,
                # non-presence and the edge gate — skip re-validation
                dag.insert_many(admit, trusted=True)
                metrics_inc("vertices_admitted", len(admit))
                if log_on:
                    for v in admit:
                        self.log.event(
                            "admit", round=v.round, source=v.source
                        )
                admitted_any = True
            if keep:
                groups[r] = {v.id.source: v for v in keep}
        return admitted_any

    def _try_advance(self) -> bool:
        """Round advancement (Alg. 2 lines 11-15, quoted at
        ``process.go:196-199``): when the current round has 2f+1 vertices,
        fire the wave boundary, move to the next round, and propose."""
        advanced = False
        while self.dag.round_size(self.round) >= self.cfg.quorum:
            r = self.round
            # Wave boundary fires BEFORE the proposal gate: committing a
            # wave needs no new proposal (the paper's wave_ready is an
            # independent upon-clause), so an idle client must not stall
            # delivery of a completed wave.
            if (
                r > 0
                and r % self.cfg.wave_length == 0
                and not self._pipelined_waves
            ):
                # cfg.wave_pipeline delegates every attempt to the
                # per-step _try_waves_pipelined pass (same step, same
                # DAG state — decisions land no later, never differ)
                w = r // self.cfg.wave_length
                if w not in self._waves_tried:
                    self._waves_tried.add(w)
                    self._try_wave(w)
            if self.epoch_mgr is not None and self.epoch_mgr.hold_round(
                r + 1, self.cfg.wave_length
            ):
                # Epoch barrier: rounds past the boundary's
                # last round belong to the next epoch and must carry
                # next-epoch coin shares — a mix of pre- and
                # post-rotation shares for one wave can never aggregate,
                # which would wedge the retro leader chain. Hold here
                # until the boundary chunk delivers and the local epoch
                # crosses; every correct process converges at round 4B.
                self.metrics.inc("epoch_barrier_holds")
                break
            if not self.blocks_to_propose and not self.cfg.propose_empty:
                break  # paper: wait until a block is available
            self.round += 1
            self.metrics.inc("rounds_advanced")
            self.log.event("round_advance", round=self.round)
            v = self._create_vertex(self.round)
            if self.log.enabled and v.block.transactions:
                # causal lifecycle stamp: this block (joined by payload
                # crc in the mempool's tx_batch events) now rides the
                # (round, source) vertex the tx_deliver stamp names
                self.log.event(
                    "tx_propose",
                    block=block_key(v.block.encode()),
                    round=self.round,
                    source=self.index,
                )
            self.dag.insert(v)
            self._note_seen(v)
            if (
                self._cert
                and v.cert_sig is not None
                and self.round % self.cfg.n == self.index
            ):
                # our own proposal in a round we aggregate: bank the share
                self._cert_stash.setdefault(self.round, {})[self.index] = (
                    v.digest(),
                    v.cert_sig,
                )
            self._broadcast_vertex(v)
            self.metrics.inc("vertices_proposed")
            advanced = True
        return advanced

    def _broadcast_vertex(self, v: Vertex) -> None:
        """Dissemination seam for own proposals. The local DAG already
        holds ``v`` (state first, wire second), so an override that
        mutates, withholds, or splits what goes on the wire — the
        Byzantine strategies in consensus/adversary.py — cannot corrupt
        this process's own dense mirrors, only test its peers."""
        self.transport.broadcast(
            BroadcastMessage(
                vertex=v,
                round=v.round,
                sender=self.index,
                epoch=self._wire_epoch,
            )
        )

    def _create_vertex(self, rnd: int) -> Vertex:
        """Vertex factory (Alg. 2 lines 17-21 + 29-31, quoted at
        ``process.go:271-275`` and ``process.go:300-302``)."""
        block = (
            self.blocks_to_propose.popleft()
            if self.blocks_to_propose
            else Block()
        )
        if self.lanes is not None:
            # a LanePending handle becomes its certified carrier block
            # (or the payload itself on degrade); plain blocks pass
            # through untouched
            block = self.lanes.materialize(block)
        # u.id IS VertexID(rnd-1, u.source) — reuse instead of
        # re-constructing n ids per proposal (a top allocation site of
        # the n=256 host profile)
        strong = tuple(
            u.id for u in self.dag.vertices_in_round(rnd - 1)
        )
        weak = self._weak_edges_for(rnd, strong)
        share = None
        if rnd % self.cfg.wave_length == 0:
            wave = rnd // self.cfg.wave_length
            share = self.coin.my_share(wave)
            if share is not None:
                self.coin.observe_share(wave, self.index, share)
        v = Vertex(
            id=VertexID(rnd, self.index),
            block=block,
            strong_edges=strong,
            weak_edges=weak,
            coin_share=share,
        )
        if self._cert:
            # BLS share over the digest (which excludes both signatures),
            # attached before the ed25519 sign copies the fields forward
            object.__setattr__(
                v, "cert_sig", self.cert_signer.sign_digest(v.digest())
            )
        if self.signer is not None:
            v = self.signer.sign_vertex(v)
        # Own proposals satisfy the admission gate by construction
        # (strong = the full quorum-checked frontier, weak from the
        # sweep); pre-stamping the gate memo keeps dag.insert and sibling
        # processes off the re-validation path.
        object.__setattr__(
            v, "_gate", ((self.cfg.n, self.cfg.quorum), False)
        )
        return v

    def _weak_edges_for(
        self, rnd: int, strong: tuple
    ) -> tuple:
        """Weak edges: for every round r < rnd-1 (descending), any vertex
        not already reachable gets a weak edge (Alg. 2 lines 29-31; the
        reference's ``setWeakEdges`` runs one BFS per candidate,
        ``process.go:303-309`` — here one incremental closure bitmap)."""
        if rnd < 3:
            return ()
        dag = self.dag
        n = self.cfg.n
        # Backward sweep. Invariant: when the sweep reaches round r,
        # reached[r] is the set of round-r vertices in the causal history
        # of v via all higher rounds — valid because after processing a
        # round every existing vertex there is *covered* (reachable or
        # freshly weak-linked), so covered vertices' out-edges are exactly
        # what must propagate. Order within a round is irrelevant (edges
        # only cross rounds).
        #
        # Truncation: every vertex of round <= rnd-2 already
        # present at our previous proposal is in that proposal's causal
        # history (its strong edges took ALL of round rnd-2, and its sweep
        # weak-linked everything unreachable below), and our previous
        # vertex is itself a strong-edge target of this proposal — so only
        # rounds >= dag.insert_min_round (the lowest round inserted since
        # that sweep) can hold uncovered candidates. Paths are monotone in
        # round, so stopping the propagation at lo loses nothing above it.
        # Steady state sweeps O(1) rounds instead of O(R); cold start and
        # checkpoint restore reset the marker to 0 (full sweep).
        # The GC horizon also floors the sweep: rounds <= base_round are
        # retired and excluded from delivery everywhere, so they can
        # never need a weak edge.
        lo = max(1, dag.base_round + 1, min(dag.insert_min_round, rnd - 1))
        dag.insert_min_round = rnd
        dag_base = dag.base_round
        base = lo - 1  # lowest row the sweep can write (r == lo writes lo-1)
        reached = np.zeros((rnd - base, n), dtype=bool)  # rows base..rnd-1
        covered = np.zeros(n, dtype=bool)
        for e in strong:  # frontier round rnd-1: covered = strong targets
            covered[e.source] = True
        weak: List[VertexID] = []
        for r in range(rnd - 1, lo - 1, -1):
            if r <= rnd - 2:
                covered = reached[r - base].copy()
                for u in dag.vertices_in_round(r):
                    if not covered[u.source]:
                        weak.append(u.id)
                        covered[u.source] = True
            if r == 1:
                break  # round 0 is genesis; nothing below to propagate to
            reached[r - 1 - base] |= covered @ dag.strong[r - dag_base]
            for i in np.flatnonzero(covered):
                for (r2, j) in dag.weak.get((r, i), ()):
                    if r2 >= lo:  # below lo is never read
                        reached[r2 - base, j] = True
        return tuple(weak)

    # ------------------------------------------------------------------
    # Catch-up sync (anti-entropy) — elastic recovery, SURVEY §5.
    #
    # A process that was down (or partitioned) while the cluster advanced
    # has buffered vertices whose predecessors nobody will re-broadcast:
    # without this, it stalls forever (the reference has the same hole,
    # plus no persistence at all). Requesters ask for a bounded round
    # window once the buffer has been stuck for `sync_patience` steps;
    # responders re-broadcast their *original signed* vertices for those
    # rounds, capped per (requester, window). Served vertices flow through
    # the normal admission path — signatures, stamps and (with RBC) the
    # Bracha consistency machinery still gate them, so a Byzantine
    # "helper" cannot use sync to smuggle an equivocation.
    # ------------------------------------------------------------------

    def _maybe_request_sync(self, made_progress: bool = False) -> None:
        # Stuck = no progress while there is something to wait for: a
        # non-empty buffer (missing predecessors), or queued client blocks
        # with an incomplete current round (our — or our peers' — round-r
        # broadcasts were lost, so everyone's buffers can be EMPTY while
        # the cluster deadlocks; a quiescent cluster with no pending
        # blocks is *idle*, not stuck, and must not request forever).
        # Scalar mirrors the buffer in _buffered_ids; vector keys the
        # round-group dicts by vid instead — either emptiness check is
        # O(1), unlike the ``buffer`` property which flattens groups.
        waiting = (
            (
                bool(self._buffer_rounds)
                if self._vector
                else bool(self._buffered_ids)
            )
            or bool(self._cert_pool)  # rounds parked awaiting a cert
            or (
                bool(self.blocks_to_propose)
                and self.round >= 1
                and self.dag.round_size(self.round) < self.cfg.quorum
            )
        )
        if self.cfg.sync_patience <= 0 or made_progress or not waiting:
            # any forward progress resets patience — a node that is being
            # fed (however slowly) is not partitioned
            self._stuck_steps = 0
            return
        rx = self.metrics.counters.get("msgs_received", 0)
        if rx != self._rx_at_patience:
            # Traffic is still ARRIVING at this node: a caller pumping in
            # chunks (mempool load generators, WAN clocks) is throttling
            # delivery below the offered load — throttled, not
            # partitioned. HOLD the counter (don't accrue, don't reset):
            # patience accrues only across steps where nothing reached us
            # at all. Without this gate every chunk-limited pump cycle
            # read as a stall, and once sync_patience elapsed all n nodes
            # broadcast requests whose vertex re-serves amplify n^2 into
            # a re-serve storm (the mempool load generators had to run with
            # sync_patience=0 to avoid it). Receipts — not the shared
            # broker's global queue length — are the signal a real
            # deployment would have: a partitioned node sees silence and
            # correctly keeps accruing toward a sync request.
            self._rx_at_patience = rx
            return
        self._stuck_steps += 1
        if self._stuck_steps < self.cfg.sync_patience:
            return
        now = _time.monotonic()
        if now - self._sync_last_request < self.cfg.sync_request_cooldown_s:
            return  # patience keeps accruing; request fires on cooldown
        self._stuck_steps = 0
        self._sync_last_request = now
        lo: Optional[int] = None
        # Rounds at/below our GC floor — or the f+1-attested PEER floor —
        # are unservable everywhere (peers refuse pruned windows) and
        # unadmittable here; requesting them would loop forever.
        floor = max(self.dag.base_round, self._attested_floor)
        for v in self.buffer:
            for e in (*v.strong_edges, *v.weak_edges):
                if e.round > max(0, floor) and not self.dag.present(e):
                    lo = e.round if lo is None else min(lo, e.round)
        if lo is not None:
            # Anchor at our own frontier: buffered vertices only reveal
            # the round directly below themselves, so chasing their
            # predecessors would walk the gap backward one round per
            # request. Rounds < self.round are quorum-complete locally,
            # but self.round itself may not be (lost broadcasts).
            lo = min(lo, max(1, self.round))
        elif (
            self.blocks_to_propose
            and self.round >= 1
            and self.dag.round_size(self.round) < self.cfg.quorum
        ):
            # Nothing is missing *below* the buffer, but we want to
            # advance and our current round lacks quorum (lost
            # broadcasts): ask for the current round.
            lo = self.round
        else:
            # Nothing sync can provide (e.g. idle with future-round
            # vertices buffered and no client blocks): requesting would
            # be a perpetual O(n^2) duplicate-traffic loop.
            return
        hi = lo + self.cfg.sync_window - 1
        self._sync_last_lo = lo
        self.metrics.inc("sync_requested")
        self.log.event("sync_request", lo=lo, hi=hi)
        req = BroadcastMessage(
            vertex=None,
            round=lo,
            sender=self.index,
            kind="sync",
            origin=hi,
            epoch=self._wire_epoch,
        )
        # Anti-entropy is PULL gossip: ask ONE peer per patience window,
        # rotating deterministically, instead of broadcasting the
        # request to all n-1. A broadcast request makes every peer
        # answer with the full window — n responders x window x n
        # destinations amplified one stuck round into ~n^2 duplicate
        # traffic at n=32 (the re-serve storm). Rotation reaches an
        # honest, connected peer within f+1 windows; if the stack has
        # no unicast seam (or the chosen peer is gone) the request
        # degrades to the old broadcast.
        send = resolve_unicast(self.transport)
        if send is not None:
            peer = self._sync_peer_rr % self.cfg.n
            if peer == self.index:
                peer = (peer + 1) % self.cfg.n
            self._sync_peer_rr = peer + 1
            try:
                send(peer, req)
                return
            except KeyError:
                pass  # peer not subscribed (down/late): fall back
        self.transport.broadcast(req)

    def _on_sync_nack(self, msg: BroadcastMessage) -> None:
        """A responder's "your window is below my GC floor" signal.

        Once f+1 DISTINCT responders (at least one honest) report floors
        above our round, anti-entropy can never close the gap —
        ``state_transfer_needed`` flips and the node runtime fetches a
        peer snapshot (utils.checkpoint.restore_from_snapshot). Floors at
        or below our round are stale/irrelevant for THAT signal and clear
        that responder's entry (progress may have resumed).

        Separately, floors above the *requested window* (lo) feed the
        attested-floor quorum even when our round is ahead of them: a
        node blocked on pruned straggler rounds would otherwise ignore
        every nack and re-request unservable history forever (its own
        GC floor may never advance past the blockers, e.g. with
        gc_depth=None against pruning peers)."""
        if (
            not 0 <= msg.sender < self.cfg.n
            or msg.sender == self.index
            or msg.origin != self.index
        ):
            return
        floor = msg.round
        if self._sync_last_lo is not None and floor >= self._sync_last_lo:
            prev = self._window_nacks.get(msg.sender, 0)
            if floor > prev:
                self._window_nacks[msg.sender] = floor
            if len(self._window_nacks) >= self.cfg.f + 1:
                # Highest floor that f+1 distinct responders (>= 1
                # honest) attest: the (f+1)-th largest reported value.
                # Byzantine inflation is clipped to what an honest
                # responder corroborates.
                attested = sorted(self._window_nacks.values())[
                    len(self._window_nacks) - (self.cfg.f + 1)
                ]
                if attested > self._attested_floor:
                    self._attested_floor = attested
                    self.log.event(
                        "attested_floor", floor=attested,
                        responders=len(self._window_nacks),
                    )
                    self.metrics.inc("sync_attested_floor_raises")
        if floor > self.round:
            self._horizon_nacks[msg.sender] = floor
            self.metrics.inc("sync_nacks")
            # Threshold over CURRENTLY-live floors only: entries recorded
            # while briefly behind must not linger and let a single later
            # Byzantine nack fake the f+1 quorum after we caught up.
            live = {
                k: v for k, v in self._horizon_nacks.items() if v > self.round
            }
            self._horizon_nacks = live
            if len(live) >= self.cfg.f + 1:
                if not self.state_transfer_needed:
                    self.log.event(
                        "behind_horizon", floors=sorted(live.values())
                    )
                self.state_transfer_needed = True
        else:
            self._horizon_nacks.pop(msg.sender, None)

    def _serve_sync(self, msg: BroadcastMessage) -> None:
        # Requester id is range-checked (spoofable in-protocol, but the
        # throttle table stays bounded at n entries) and self-requests are
        # ignored.
        if not 0 <= msg.sender < self.cfg.n or msg.sender == self.index:
            return
        lo = max(1, msg.round)
        hi = msg.origin if msg.origin is not None else lo
        hi = min(hi, lo + self.cfg.sync_window - 1, self.round)
        if hi < lo and lo > self.dag.base_round:
            return
        # Rate limit per requester (not per window — window rotation must
        # not multiply the budget, and a lost response must be
        # re-requestable once the cooldown passes). The below-horizon
        # nack path shares this throttle: the requester id is spoofable
        # in-protocol, and an unthrottled nack broadcast would be an n^2
        # traffic amplifier.
        now = _time.monotonic()
        if (
            now - self._sync_last_serve.get(msg.sender, float("-inf"))
            < self.cfg.sync_serve_cooldown_s
        ):
            self.metrics.inc("sync_throttled")
            return
        self._sync_last_serve[msg.sender] = now
        if lo <= self.dag.base_round:
            # Below the GC horizon: that history is retired here (and
            # excluded from delivery everywhere) — refuse cleanly rather
            # than serve a partial window the requester can't use, and
            # tell the requester WHY (sync_nack with our floor): f+1
            # such nacks are its signal that anti-entropy cannot help
            # and peer state transfer (snapshot sync) is needed.
            self.metrics.inc("sync_refused_pruned")
            self.log.event(
                "sync_refuse_pruned", lo=lo, floor=self.dag.base_round
            )
            self.transport.broadcast(
                BroadcastMessage(
                    vertex=None,
                    round=self.dag.base_round,
                    sender=self.index,
                    kind="sync_nack",
                    origin=msg.sender,
                    epoch=self._wire_epoch,
                )
            )
            return
        # Serve UNICAST to the requester when the stack has a
        # per-destination seam: a broadcast response multiplies every
        # served vertex by n-1 destinations, and with many peers
        # answering the same request the re-serve traffic amplifies
        # ~n^2 — at n=32 one patience round buried live VALs behind
        # ~300k stale duplicates and wedged the cluster. Under Bracha
        # (requires_broadcast) the seam resolves to None and responses
        # stay broadcast: peers must see repeat VALs to refresh READYs
        # or the requester can never reach delivery quorum.
        send = resolve_unicast(self.transport)
        count = 0
        for r in range(lo, hi + 1):
            for v in self.dag.vertices_in_round(r):
                out = BroadcastMessage(
                    vertex=v,
                    round=v.round,
                    sender=v.source,
                    epoch=self._wire_epoch,
                )
                if send is not None:
                    try:
                        send(msg.sender, out)
                    except KeyError:
                        # requester has no inbox on this broker (left,
                        # or never subscribed): degrade to broadcast
                        # for the rest of the window
                        send = None
                        self.transport.broadcast(out)
                else:
                    self.transport.broadcast(out)
                count += 1
        if count:
            self.metrics.inc("sync_served", count)
            self.log.event("sync_serve", lo=lo, hi=hi, vertices=count)

    # ------------------------------------------------------------------
    # Wave commit (Algorithm 3, quoted at process.go:315-325, 358-361)
    # ------------------------------------------------------------------

    def _retry_pending_waves(self) -> bool:
        fired = False
        for w in sorted(self._pending_waves):
            if self.coin.ready(w):
                self._pending_waves.discard(w)
                self._try_wave(w)
                fired = True
        return fired

    def _try_waves_pipelined(self) -> bool:
        """Attempt every live undecided wave whose commit round already
        holds a quorum.

        The boundary one-shot in _try_advance serializes wave
        evaluation behind the local round counter: a wave whose votes
        land mid-step waits for the counter to cross round(w, 4), and a
        wave that fails its single boundary attempt is only ever
        committed retroactively through a later wave's chain walk. Here
        every wave from decided_wave+1 up to the DAG's quorum frontier
        is (re)attempted each pass, so a decision lands the moment its
        votes exist and undecided waves stay retryable while younger
        waves fill — overlapping wave instances instead of a lockstep
        4-round cadence.

        The committed leader sequence — and therefore the total order —
        is unchanged (the A/B invariant): chain-walk path checks run
        over the deciding leader's immutable causal past, so they are
        time-invariant, and a wave's one-shot is spent exactly at the
        first attempt with the round counter at/past its commit round —
        the same DAG state the oracle's boundary attempt sees — so no
        wave decides here that the boundary path would have skipped
        (decisions land earlier in the step, never different).
        """
        wl = self.cfg.wave_length
        frontier = self.dag.quorum_frontier(self.cfg.quorum)
        if frontier < wl:
            self.metrics.counters["waves_inflight"] = 0
            return False
        before = self.decided_wave
        w_hi = self.cfg.wave_of_round(frontier)
        for w in range(self.decided_wave + 1, w_hi + 1):
            r4 = self.cfg.wave_round(w, wl)
            if r4 > frontier:
                break
            if w <= self.decided_wave or w in self._waves_spent:
                continue
            spend = self.round >= r4
            if spend:
                # boundary-equivalent attempt: one-shot spent, exactly
                # like the oracle's _waves_tried bookkeeping
                self._waves_spent.add(w)
                self._wave_try_memo.pop(w, None)
                self._try_wave(w)
                continue
            # early retryable attempt: votes and leader presence are
            # pure functions of the r4/r1 fills (strong edges are fixed
            # at admission), so an unchanged fill pair means the last
            # verdict stands — skip the reach count
            fills = (
                self.dag.round_size(r4),
                self.dag.round_size(self.cfg.wave_round(w, 1)),
            )
            if self._wave_try_memo.get(w) == fills:
                continue
            self._wave_try_memo[w] = fills
            self._try_wave(w, quiet=True)
        if self.decided_wave > before:
            self._waves_spent = {
                w for w in self._waves_spent if w > self.decided_wave
            }
            self._wave_try_memo = {
                w: m
                for w, m in self._wave_try_memo.items()
                if w > self.decided_wave
            }
        # gauge: undecided waves whose commit round has a quorum — the
        # live overlap depth of the wave pipeline
        self.metrics.counters["waves_inflight"] = max(
            0,
            min(w_hi, self.cfg.wave_of_round(frontier))
            - self.decided_wave,
        )
        return self.decided_wave > before

    def _try_wave(self, wave: int, quiet: bool = False) -> None:
        """The commit rule (reference ``waveReady``, ``process.go:312-354``,
        with D4/D5 fixed: state persists and ordering actually runs).

        ``quiet`` marks a retryable pipelined attempt: a failed quorum
        or absent leader is expected to be re-tried as the DAG fills,
        so it must not inflate ``waves_skipped`` or spam skip events —
        the spend-time attempt (and the oracle boundary path) keeps the
        reference accounting."""
        if wave <= self.decided_wave:
            return
        if not self.coin.ready(wave):
            self._pending_waves.add(wave)
            if not quiet:
                self.log.event("wave_pending_coin", wave=wave)
            return
        leader = self._wave_leader(wave)
        if leader is None:
            if not quiet:
                self.metrics.inc("waves_skipped")
                self.log.event("wave_skip", wave=wave, reason="no_leader")
            return
        r4, r1 = self.cfg.wave_round(wave, self.cfg.wave_length), self.cfg.wave_round(wave, 1)
        votes = self._strong_reach_count(r4, r1, leader.source)
        if votes < self.cfg.quorum:
            if not quiet:
                self.metrics.inc("waves_skipped")
                self.log.event(
                    "wave_skip", wave=wave, reason="quorum", votes=votes
                )
            return
        # Retroactive leader chain (process.go:341-350): walk back through
        # undecided waves, committing every prior leader the current one
        # covers by a strong path.
        t0 = _time.perf_counter()
        leaders: Stack[Vertex] = Stack()
        leaders.push(leader)
        cur = leader
        for w in range(wave - 1, self.decided_wave, -1):
            if not self.coin.ready(w):
                if self.cfg.wave_round(w, 1) <= self.dag.base_round:
                    # The coin shares for w live below our GC window
                    # (after a prune or state transfer), so the leader
                    # is unknowable here — and every delivery this
                    # chain link could produce sits at rounds <=
                    # r1(w) <= base, all floor-excluded at this
                    # process. Skipping the link keeps the total order
                    # identical to processes that do walk it.
                    continue
                # An IN-WINDOW link whose shares are still in flight:
                # skipping would diverge the total order (other
                # processes may commit this leader), so defer the WHOLE
                # commit and let _retry_pending_waves re-enter once the
                # shares land — decided_wave is untouched, so the
                # re-entry redoes the full walk.
                self._pending_waves.add(wave)
                self.log.event(
                    "wave_pending_chain_coin", wave=wave, link=w
                )
                return
            prior = self._wave_leader(w)
            if prior is not None and (
                self._leader_path(cur.id, prior.id)
                if self._vector
                else self.dag.path(cur.id, prior.id, strong_only=True)
            ):
                leaders.push(prior)
                cur = prior
        self.decided_wave = wave
        self.metrics.inc("waves_decided")
        # interval stamp at DECIDE time — a deferred flush that runs two
        # waves' ordering walks back-to-back must not record ~0 cadence
        self.metrics.observe_wave_decided()
        self.log.event(
            "wave_decided",
            wave=wave,
            leader=leader.source,
            votes=votes,
            chain=len(leaders),
        )
        if self._eager:
            # surface the exact canonical chunks NOW, ahead of the
            # (possibly deferred) on_deliver flush — list(leaders)
            # iterates in pop order (oldest leader first) without
            # consuming the stack the flush still owns
            self._eager_surface(list(leaders), wave)
        if self.defer_delivery:
            # cur is the oldest leader in the chain — maybe_prune anchors
            # the GC floor on it until the deferred walk flushes.
            self._deferred_orders.append(
                (leaders, _time.perf_counter() - t0, cur.round)
            )
            return
        self._order_vertices(leaders)
        self.metrics.observe_wave_commit(_time.perf_counter() - t0)
        self.maybe_prune()

    def _eager_surface(self, chain: List[Vertex], wave: int) -> None:
        """Speculatively surface a decided chain's canonical chunks
       .

        The chunks computed here are byte-identical to what the
        canonical _order_vertices walk will deliver for the same chain:
        a leader's closure is immutable once admitted (admission
        requires full causal history), the GC exclusion bound is a pure
        function of the leader round, and the eager mask has exactly
        the prior decisions' chunks applied (decisions and flushes are
        both FIFO). So the speculative stream is a prefix of the final
        order by construction; _order_vertices reconciles and routes
        any divergence through the flight recorder."""
        mask = self._eager_mask
        if mask.shape[0] < self.dag.exists.shape[0]:
            grown = np.zeros_like(self.dag.exists)
            grown[: mask.shape[0]] = mask
            self._eager_mask = mask = grown
        base = self.dag.base_round
        gc = self.cfg.gc_depth
        cb = self.on_deliver_early
        lanes = self.lanes
        by_round = self.dag._round_vertices
        count = 0
        for leader in chain:
            reached = self.dag.closure_stopped(leader.id, mask)
            lo_round = max(1, base + 1)
            if gc is not None:
                lo_round = max(lo_round, leader.round - gc + 1)
            lo = lo_round - base
            hi = leader.round + 1 - base
            if hi <= lo:
                continue
            fresh = reached[lo:hi] & ~mask[lo:hi]
            rrs, srcs = np.nonzero(fresh)
            if not rrs.size:
                continue
            mask[lo:hi][fresh] = True
            cur = -1
            d: Dict[int, Vertex] = {}
            for rr, src in zip(rrs.tolist(), srcs.tolist()):
                if rr != cur:
                    cur = rr
                    d = by_round[rr + lo_round]
                v = d[src]
                self.eager_log.append(v.id)
                if cb is not None:
                    if lanes is not None:
                        v = lanes.resolve_vertex(v)
                    cb(v)
            count += int(rrs.size)
        if count:
            self.metrics.inc("eager_delivered", count)
            self.log.event("eager_deliver", wave=wave, count=count)

    def _reconcile_eager(self, n_before: int) -> None:
        """Match canonical deliveries just appended by _order_vertices
        against the speculative stream (prefix property). The canonical
        order always wins — the eager stream is advisory — so a
        mismatch never rolls back delivered state; it bumps the
        expected-zero counter, fires the flight-recorder trigger, and
        disables further speculation on this process."""
        fresh = self.delivered_log[n_before:]
        if not fresh:
            return
        cur = self._eager_cursor
        elog = self.eager_log
        ok = 0
        for vid in fresh:
            if cur < len(elog) and elog[cur] == vid:
                cur += 1
                ok += 1
                continue
            self.metrics.inc("eager_rollbacks_expected_zero")
            self.log.event(
                "eager_mismatch",
                cursor=cur,
                expected=str(elog[cur]) if cur < len(elog) else None,
                delivered=str(vid),
            )
            self.log.event(
                "invariant_violation",
                kind="eager_prefix",
                detail=f"speculative order diverged at cursor {cur}",
            )
            self._eager = False
            break
        self._eager_cursor = cur
        if ok:
            self.metrics.inc("eager_reconciled", ok)
            self.log.event("eager_reconciled", count=ok)

    def flush_deliveries(self) -> None:
        """Run queued ordering/delivery walks (see ``defer_delivery``).
        The wave-commit metric observes chain-walk + ordering as one
        sample, same as the inline path."""
        while self._deferred_orders:
            leaders, partial, _ = self._deferred_orders.popleft()
            with Timer() as t:
                self._order_vertices(leaders)
            self.metrics.observe_wave_commit(partial + t.seconds)
        self.maybe_prune()

    def maybe_prune(self, floor: Optional[int] = None) -> int:
        """Retire DAG/process state below the GC horizon (cfg.gc_depth).

        The floor is ``oldest_undelivered_leader_round - gc_depth``: the
        ordering rule (see _order_vertices) already guarantees no correct
        process will ever deliver below it, so dropping that state cannot
        diverge the total order. Pending deferred delivery walks anchor
        the floor at their oldest leader — pruning may never outrun a
        delivery that is merely deferred. Returns vertices removed.

        ``floor`` overrides the computed horizon (epoch-boundary
        GC): the caller — :meth:`_epoch_advance` — passes a floor
        that is a pure function of the committed boundary, so every
        correct process prunes at the same point in the total order and
        the ``base_round`` delivery exclusion stays identical
        everywhere. Deferred delivery walks still clamp it.
        """
        gc = self.cfg.gc_depth
        if floor is None and self._epoch_gc_floor is not None:
            # one-shot epoch-boundary floor armed by _epoch_advance
            floor, self._epoch_gc_floor = self._epoch_gc_floor, None
        if floor is None:
            if gc is None or self.decided_wave == 0:
                return 0
            anchor = self.cfg.wave_round(self.decided_wave, 1)
            for (_, _, oldest_round) in self._deferred_orders:
                anchor = min(anchor, oldest_round)
            floor = anchor - gc
        else:
            for (_, _, oldest_round) in self._deferred_orders:
                floor = min(floor, oldest_round - (gc or 1))
        if floor <= self.dag.base_round:
            return 0
        old_base = self.dag.base_round
        removed = self.dag.prune_below(floor)
        shift = self.dag.base_round - old_base
        # Realign the delivered bitmap with the shifted dense rows.
        dmask = self._delivered_mask
        new = np.zeros_like(self.dag.exists)
        src = dmask[shift:]
        m = min(src.shape[0], new.shape[0])
        new[:m] = src[:m]
        self._delivered_mask = new
        if self._eager_mask is not None:
            # the eager twin shifts with the same realignment, and the
            # reconciled head of the speculative log retires with the
            # canonical one (entries past the cursor are still awaiting
            # their canonical match and must survive the prune)
            enew = np.zeros_like(self.dag.exists)
            esrc = self._eager_mask[shift:]
            em = min(esrc.shape[0], enew.shape[0])
            enew[:em] = esrc[:em]
            self._eager_mask = enew
            nb = self.dag.base_round
            drop = 0
            while (
                drop < self._eager_cursor
                and drop < len(self.eager_log)
                and self.eager_log[drop].round < nb
            ):
                drop += 1
            if drop:
                self.eager_log = self.eager_log[drop:]
                self._eager_cursor -= drop
        # Bound the book-keeping that grows with history. delivered_log
        # keeps only the live window (the trimmed count is preserved for
        # checkpoints/metrics); deliveries below the horizon can never
        # recur, so dedup state for them is dead weight.
        base = self.dag.base_round
        if self.delivered_log and self.delivered_log[0].round < base:
            keep = [v for v in self.delivered_log if v.round >= base]
            self.delivered_trimmed += len(self.delivered_log) - len(keep)
            self.delivered_log = keep
        self._seen_digests = {
            r: row for r, row in self._seen_digests.items() if r >= base
        }
        if self._cert:
            # Certificate books follow the same floor. Pooled vertices at
            # or below it are retired history (unadmittable anyway).
            for r in [r for r in self._cert_pool if r <= base]:
                del self._cert_pool[r]
                self._cert_wait.pop(r, None)
            self._cert_stash = {
                r: s for r, s in self._cert_stash.items() if r > base
            }
            self._cert_done = {r for r in self._cert_done if r > base}
            self._certs_sent = {r for r in self._certs_sent if r > base}
            if self._span:
                # epoch books retire once the epoch's last round sinks
                # below the floor ((e+1)*k is epoch e's last round)
                k = self._span
                self._span_bank = {
                    e: b
                    for e, b in self._span_bank.items()
                    if (e + 1) * k > base
                }
                self._span_wait = {
                    e: w
                    for e, w in self._span_wait.items()
                    if e in self._span_bank
                }
                self._spans_sent = {
                    e for e in self._spans_sent if (e + 1) * k > base
                }
                self._span_done = {
                    e for e in self._span_done if (e + 1) * k > base
                }
                # the attestation chain keeps exactly the spans whose
                # window overlaps the restorable DAG (rounds > base) —
                # what snapshot_bytes will cover
                self._span_chain = {
                    e: s
                    for e, s in self._span_chain.items()
                    if (e + 1) * k > base
                }
        # A reliable-broadcast stage keeps per-slot vote books — retire
        # them along the same floor (transport/rbc.py prune_below), or a
        # long-running RBC node leaks exactly the state class the DAG
        # prune just bounded.
        tp_prune = getattr(self.transport, "prune_below", None)
        if tp_prune is not None:
            tp_prune(base)
        # ... and the coin's per-wave share books (same floor, in waves)
        if base >= 1:
            self.coin.prune_below(self.cfg.wave_of_round(base))
        # Pending waves whose shares just got pruned can never become
        # ready — and their deliveries are floor-excluded here anyway;
        # without this they would be re-polled every step forever.
        self._pending_waves = {
            w
            for w in self._pending_waves
            if self.cfg.wave_round(w, 1) > base
        }
        self._waves_spent = {
            w for w in self._waves_spent if self.cfg.wave_round(w, 1) > base
        }
        self._wave_try_memo = {
            w: f
            for w, f in self._wave_try_memo.items()
            if self.cfg.wave_round(w, 1) > base
        }
        self.metrics.inc("vertices_pruned", removed)
        self.log.event("pruned", floor=base, removed=removed)
        return removed

    def _wave_leader(self, wave: int) -> Optional[Vertex]:
        """Leader lookup (reference ``getWaveVertexLeader``,
        ``process.go:356-371``): the unique vertex at round(w, 1) authored
        by the coin's choice, if present in this process's DAG."""
        src = self.coin.choose_leader(wave)
        return self.dag.get(VertexID(self.cfg.wave_round(wave, 1), src))

    def _leader_path(self, hi: VertexID, lo: VertexID) -> bool:
        """Strong-path query for the retroactive leader chain (vector
        pump): seeded vector @ matrix descent over the dense mirrors
        (:func:`ops.dag_kernels.leader_reach_np`) — O(k·n²) bit ops for
        a k-round gap instead of the scalar closure walk's per-round
        Python bookkeeping. Same boolean-semiring reachability as
        ``dag.path(strong_only=True)``; tests pin the twin against the
        jitted kernel."""
        from dag_rider_tpu_torch.ops.dag_kernels import leader_reach_np

        dag = self.dag
        if not dag.present(hi) or not dag.present(lo):
            return False
        if hi == lo:
            return True
        if lo.round >= hi.round:
            return False
        vec = leader_reach_np(
            dag.strong_stack(hi.round, lo.round), hi.source
        )
        return bool(vec[lo.source])

    def _strong_reach_count(self, r_hi: int, r_lo: int, leader_src: int) -> int:
        """|{v in dag[r_hi] : strong path v -> leader}| — host twin of
        ops.dag_kernels.wave_commit_votes.

        Back-propagates a reach VECTOR up the wave instead of chaining
        n x n bool matmuls: only the leader's column of the full reach
        matrix is ever consumed, so each level is one masked column
        selection + row-OR (~n^2 bit ops) rather than an n^3 matmul —
        at n=256 this was ~4.5 ms per wave try, ~10% of the host loop."""
        base = self.dag.base_round
        if r_hi == r_lo:
            return int(self.dag.exists[r_hi - base, leader_src])
        # vec[i] = True iff (r, i) strong-reaches the leader at r_lo
        vec = self.dag.strong[r_lo + 1 - base][:, leader_src]
        for r in range(r_lo + 2, r_hi + 1):
            vec = self.dag.strong[r - base][:, vec].any(axis=1)
        votes = vec & self.dag.exists[r_hi - base]
        return int(votes.sum())

    # ------------------------------------------------------------------
    # Total order delivery (Algorithm 1 lines 51-57, process.go:405-411)
    # ------------------------------------------------------------------

    def _order_vertices(self, leaders: Stack[Vertex]) -> None:
        """Deterministic a_deliver of every vertex in each committed
        leader's causal history, oldest leader first (D5/D6/D8 fixed: it
        runs, it calls the client callback, and delivered vertices are
        skipped exactly once)."""
        n_before = len(self.delivered_log)
        trace = self.log.enabled
        dmask = self._delivered_mask
        if dmask.shape[0] < self.dag.exists.shape[0]:
            grown = np.zeros_like(self.dag.exists)
            grown[: dmask.shape[0]] = dmask
            self._delivered_mask = dmask = grown
        base = self.dag.base_round
        gc = self.cfg.gc_depth
        while not leaders.is_empty():
            leader = leaders.pop()
            chunk_start = len(self.delivered_log)
            # Delivered-pruned closure: identical fresh set as the full
            # closure (delivery is causally closed), but the sweep stops
            # at the already-delivered frontier instead of descending the
            # whole DAG depth on every commit.
            reached = self.dag.closure_stopped(leader.id, dmask)
            # Deterministic GC exclusion (cfg.gc_depth): vertices at
            # round <= leader.round - gc_depth are skipped by EVERY
            # process for the same committed leader (a pure function of
            # the leader round), so the total order stays identical while
            # state below the horizon becomes safely prunable. A vertex
            # excluded at its first containing leader stays excluded at
            # every later one (leader rounds only grow).
            lo_round = max(1, base + 1)
            if gc is not None:
                lo_round = max(lo_round, leader.round - gc + 1)
            # One vectorized diff against delivered state, then touch only
            # the genuinely-new slots. argwhere's row-major order IS the
            # delivery order (ascending round, then source).
            lo = lo_round - base
            hi = leader.round + 1 - base
            if hi <= lo:
                self._epoch_note_delivery(leader, chunk_start)
                continue
            fresh = reached[lo:hi] & ~dmask[lo:hi]
            if self._vector:
                # Same slots in the same order (nonzero is row-major,
                # exactly argwhere's ascending round-then-source), but
                # the mask write and the counter land once per commit
                # instead of once per slot.
                rrs, srcs = np.nonzero(fresh)
                if rrs.size:
                    dmask[lo:hi][fresh] = True
                    self.metrics.inc("vertices_delivered", int(rrs.size))
                    by_round = self.dag._round_vertices
                    log_append = self.delivered_log.append
                    cb = self.on_deliver
                    lanes = self.lanes
                    # per-round source dict fetched once per run of
                    # consecutive slots (nonzero is round-major), and
                    # the existing v.id is reused — constructing a
                    # fresh VertexID per delivered slot was a visible
                    # slice of the n=256 commit path
                    cur = -1
                    d: Dict[int, Vertex] = {}
                    for rr, src in zip(rrs.tolist(), srcs.tolist()):
                        if rr != cur:
                            cur = rr
                            d = by_round[rr + lo_round]
                        v = d[src]
                        log_append(v.id)
                        if cb is not None:
                            if lanes is not None:
                                # carrier refs surface as payload bytes
                                # (fetch-on-miss inside); the id the log
                                # keeps is unchanged
                                v = lanes.resolve_vertex(v)
                            cb(v)
                        if (
                            trace
                            and src == self.index
                            and v.block.transactions
                        ):
                            # the proposer's own delivery closes the
                            # lifecycle chain opened by tx_propose
                            self.log.event(
                                "tx_deliver",
                                round=rr + lo_round,
                                source=src,
                            )
                self._epoch_note_delivery(leader, chunk_start)
                continue
            for rr, src in np.argwhere(fresh):
                vid = VertexID(int(rr) + lo_round, int(src))
                dmask[vid.round - base, vid.source] = True
                self.delivered_log.append(vid)
                self.metrics.inc("vertices_delivered")
                if self.on_deliver is not None:
                    v = self.dag.vertices[vid]
                    if self.lanes is not None:
                        v = self.lanes.resolve_vertex(v)
                    self.on_deliver(v)
                if trace and vid.source == self.index:
                    v = self.dag.vertices[vid]
                    if v.block.transactions:
                        self.log.event(
                            "tx_deliver", round=vid.round, source=vid.source
                        )
            self._epoch_note_delivery(leader, chunk_start)
        self.log.event(
            "delivered",
            count=len(self.delivered_log) - n_before,
            total=len(self.delivered_log),
        )
        if self._eager_mask is not None and self._eager:
            self._reconcile_eager(n_before)

    @property
    def delivered(self) -> Set[VertexID]:
        """Delivered vertex ids as a set, derived on demand —
        ``delivered_log`` (order) and ``_delivered_mask`` (dense dedup)
        are the authorities; nothing on the hot path reads this."""
        return set(self.delivered_log)

    def _rebuild_delivered_mask(self) -> None:
        """Re-derive the dense delivered bitmap from ``delivered_log`` —
        for callers (checkpoint restore) that replace the log wholesale."""
        base = self.dag.base_round
        self._delivered_mask = np.zeros_like(self.dag.exists)
        for vid in self.delivered_log:
            if vid.round >= base:
                self._delivered_mask[vid.round - base, vid.source] = True
        if self._eager_mask is not None:
            # a wholesale log replacement (checkpoint restore) voids the
            # speculative stream: restart it from the canonical state so
            # nothing already delivered is ever re-surfaced
            self._eager_mask = self._delivered_mask.copy()
            self.eager_log = []
            self._eager_cursor = 0

    # ------------------------------------------------------------------
    # Epoch reconfiguration
    # ------------------------------------------------------------------

    @property
    def _wire_epoch(self) -> int:
        """Epoch id stamped on outgoing messages. 0 (static membership
        or epoch 0) makes the codec omit the epoch section entirely, so
        pre-epoch deployments keep byte-identical wire frames."""
        mgr = self.epoch_mgr
        return mgr.epoch if mgr is not None else 0

    def _epoch_reject_stale(self, msg: BroadcastMessage) -> None:
        """Count + trace one rejected pre-rotation message (the caller
        has already matched kind and compared epochs)."""
        self.metrics.inc("epoch_stale_rejected")
        self.log.event(
            "epoch_stale",
            kind=msg.kind,
            msg_epoch=msg.epoch,
            epoch=self.epoch_mgr.epoch,
            sender=msg.sender,
        )

    def _epoch_note_delivery(
        self, leader: Vertex, chunk_start: int
    ) -> None:
        """Entry seam for the epoch ladder (analysis/ladder.py): called
        once per committed leader chunk from :meth:`_order_vertices`.
        With reconfiguration off it falls through to the static-
        membership oracle; with it on, the chunk is scanned for control
        transactions and the boundary crossing is evaluated."""
        if self.epoch_mgr is None:
            self._epoch_static()
            return
        self._epoch_scan_chunk(leader, chunk_start)

    def _epoch_static(self) -> None:
        """Static-membership oracle: membership never changes, so a
        delivered chunk carries no reconfiguration consequence. The
        explicit seam (rather than an inlined no-op) is what lets the
        ladder checker prove the degradation edge stays intact."""

    def _epoch_scan_chunk(self, leader: Vertex, chunk_start: int) -> None:
        """Scan the chunk just delivered for ``leader`` (delivery-log
        entries from ``chunk_start`` on) for epoch control transactions,
        then cross the boundary if this chunk's wave reached it. Both
        halves are pure functions of the total order, so every correct
        process schedules and crosses identically."""
        mgr = self.epoch_mgr
        wave = self.cfg.wave_of_round(leader.round)
        had_boundary = mgr.boundary_wave
        accepted = 0
        vertices = self.dag.vertices
        for vid in self.delivered_log[chunk_start:]:
            v = vertices.get(vid)
            if v is not None and v.block.transactions:
                accepted += mgr.note_block(v.block, wave)
        if accepted:
            self.metrics.inc("epoch_ctrl_txs", accepted)
            if had_boundary is None and mgr.boundary_wave is not None:
                self.log.event(
                    "epoch_scheduled",
                    boundary=mgr.boundary_wave,
                    wave=wave,
                    ops=accepted,
                )
        if mgr.should_advance(wave):
            self._epoch_advance()

    def _epoch_advance(self) -> None:
        """Cross the pending boundary: rotate the threshold-coin keys
        (mode per cfg.epoch_rotate), retire the finished epoch's wave
        books (coin share/sigma entries and wave one-shot memos at or
        below the boundary — the planted-leak test pins this), and arm
        the epoch GC floor so the settled prefix prunes into the
        span-attested snapshot window."""
        mgr = self.epoch_mgr
        t = mgr.advance()
        b = t.boundary_wave
        self.metrics.inc("epoch_boundaries")
        self.metrics.counters["epoch_current"] = mgr.epoch
        mode = self.cfg.epoch_rotate
        if mode != "none" and getattr(self.coin, "keys", None) is not None:
            keys = derive_epoch_keys(
                t, self.cfg.n, self.cfg.f + 1, mode, self.index
            )
            if keys is not None:
                self.coin.rotate(keys, t.first_wave)
                self.metrics.inc("epoch_rotations")
        # Finished-epoch cleanup (satellite 3): waves <= B are settled
        # (the crossing itself proves decided_wave >= B), so their share
        # books and one-shot/memo entries are dead weight that the
        # round-floor prune would otherwise keep alive until the GC
        # window catches up.
        self.coin.prune_below(t.first_wave)
        self._pending_waves = {w for w in self._pending_waves if w > b}
        self._waves_spent = {w for w in self._waves_spent if w > b}
        self._waves_tried = {w for w in self._waves_tried if w > b}
        self._wave_try_memo = {
            w: f for w, f in self._wave_try_memo.items() if w > b
        }
        gc = self.cfg.gc_depth
        if gc is not None:
            # Epoch GC floor: keep epoch_gc rounds (default gc_depth)
            # behind the boundary's last round, clamped so it never
            # outruns the ordering rule's exclusion window for the next
            # possible leader (round 4B+1 delivers down to 4B+2-gc).
            # Applied at the NEXT maybe_prune — never mid-ordering,
            # where _order_vertices holds dense-array aliases.
            depth = self.cfg.epoch_gc or gc
            wl = self.cfg.wave_length
            floor = min(
                self.cfg.wave_round(b, wl) - depth,
                self.cfg.wave_round(b + 1, 1) - gc,
            )
            if self._epoch_gc_floor is None or floor > self._epoch_gc_floor:
                self._epoch_gc_floor = floor
        self.log.event(
            "epoch_advanced",
            epoch=mgr.epoch,
            boundary=b,
            ops=len(t.ops),
            seed=t.seed.hex()[:16],
        )

    def _epoch_retry_held_waves(self) -> bool:
        """While the barrier holds the round counter at the boundary's
        last round, the scalar oracle's one-shot boundary attempt for
        waves <= B has already been spent — but those waves keep filling
        as straggler vertices land, and the crossing cannot happen until
        one of them decides. Re-attempt them with the same fills-changed
        memo the pipelined pass uses (which is why pipelined mode needs
        no twin of this)."""
        mgr = self.epoch_mgr
        if (
            mgr is None
            or mgr.boundary_wave is None
            or self._pipelined_waves
        ):
            return False
        before = self.decided_wave
        wl = self.cfg.wave_length
        for w in range(self.decided_wave + 1, mgr.boundary_wave + 1):
            if w <= self.decided_wave:
                continue
            fills = (
                self.dag.round_size(self.cfg.wave_round(w, wl)),
                self.dag.round_size(self.cfg.wave_round(w, 1)),
            )
            if fills[0] < self.cfg.quorum:
                continue
            if self._wave_try_memo.get(w) == fills:
                continue
            self._wave_try_memo[w] = fills
            self._try_wave(w, quiet=True)
        return self.decided_wave > before

    # -- checkpoint seam ------------------------------------------------

    def epoch_state(self) -> Optional[Dict]:
        """JSON-serializable epoch manager state for checkpoint
        manifests and snapshot heads (None = static membership)."""
        mgr = self.epoch_mgr
        if mgr is None:
            return None
        return {
            "epoch": mgr.epoch,
            "seed": mgr.seed.hex(),
            "epoch_waves": mgr.epoch_waves,
            "boundary_wave": mgr.boundary_wave,
            "pending_ops": [
                [wave, op.kind, op.target, op.nonce, op.payload.hex()]
                for wave, op in mgr.pending_ops
            ],
            "last_boundary": (
                mgr.history[-1].boundary_wave if mgr.history else 0
            ),
        }

    def restore_epoch_state(self, d: Optional[Dict]) -> None:
        """Install checkpointed epoch state (inverse of
        :meth:`epoch_state`) and re-derive the restored epoch's coin
        keys — both rotation modes chain every input from the committed
        seed, so a joiner lands on the exact key set the survivors
        rotated to at the original crossing."""
        import hashlib as _hashlib

        mgr = self.epoch_mgr
        if mgr is None or not d:
            return
        mgr.epoch = int(d.get("epoch", 0))
        seed_hex = d.get("seed")
        if seed_hex:
            mgr.seed = bytes.fromhex(seed_hex)
        bw = d.get("boundary_wave")
        mgr.boundary_wave = int(bw) if bw is not None else None
        mgr.pending_ops = []
        mgr._seen = set()
        for wave, kind, target, nonce, payload in d.get(
            "pending_ops", []
        ):
            op = EpochOp(
                kind=kind,
                target=int(target),
                nonce=int(nonce),
                payload=bytes.fromhex(payload),
            )
            mgr._seen.add(
                _hashlib.sha256(encode_epoch_op(op)).digest()
            )
            mgr.pending_ops.append((int(wave), op))
        last_b = int(d.get("last_boundary", 0))
        if (
            mgr.epoch > 0
            and self.cfg.epoch_rotate != "none"
            and getattr(self.coin, "keys", None) is not None
        ):
            t = EpochTransition(
                epoch=mgr.epoch,
                boundary_wave=last_b,
                seed=mgr.seed,
                ops=(),
            )
            keys = derive_epoch_keys(
                t,
                self.cfg.n,
                self.cfg.f + 1,
                self.cfg.epoch_rotate,
                self.index,
            )
            if keys is not None:
                self.coin.rotate(keys, t.first_wave)
        self.metrics.counters["epoch_current"] = mgr.epoch
