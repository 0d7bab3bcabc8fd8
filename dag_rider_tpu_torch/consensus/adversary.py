"""Seeded Byzantine adversary strategies driving a faulty Process.

The port's copy of ``dag_rider_tpu/consensus/adversary.py``.

The transport-level mutator in transport/faults.py corrupts honest
traffic in flight; this module is the stronger model — the *sender
itself* is Byzantine. A :class:`ByzantineProcess` runs the full honest
state machine (its own DAG only ever holds gate-valid vertices: inserting
a forged out-of-range edge into the dense mirrors would corrupt the
adversary, not test its peers) but hands every proposal to a seeded
:class:`ByzantineBehavior` at the ``_broadcast_vertex`` dissemination
seam, where the wire output is mutated, withheld, or split.

Strategies (the Byzantine suite):

- :class:`EquivocateBehavior` — conflicting, validly re-signed payloads
  for the same (round, source) slot; ``split=True`` sends disjoint
  variants to disjoint halves of the cluster (the divergence-inducing
  shape Bracha RBC exists to close — safe only under ``rbc=True``).
- :class:`WithholdBehavior` — selective per-destination withholding of
  own proposals (crash-ish at the edge, but asymmetric: some peers see
  the vertex, some must recover it via anti-entropy).
- :class:`InvalidEdgesBehavior` — validly signed vertices whose
  strong/weak edges violate the admission gate (out-of-range sources,
  wrong target rounds, sub-quorum parents) — exercising the
  ``edges_valid`` clamp in consensus/process.py.
- :class:`GarbageCoinBehavior` — sustained threshold-coin pollution:
  every wave-boundary proposal carries a well-formed-but-worthless BLS
  share (a real G1 point that is NOT a signature under the adversary's
  share key — random bytes would fail point decompression and be
  skipped for free), so the coin's batched bad-share filter
  (consensus/coin.py) must recover wave after wave, not once.

All randomness is seeded per behavior instance — scenarios replay
byte-for-byte.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Callable, Optional

from dag_rider_tpu_torch.consensus.process import Process
from dag_rider_tpu_torch.core.types import Block, BroadcastMessage, Vertex, VertexID

#: strategy names accepted by :func:`make_behavior` (and the scenario
#: runner's --adversary flag)
ADVERSARIES = (
    "equivocate",
    "equivocate_split",
    "withhold",
    "invalid_edges",
    "garbage_coin",
    "lane_withhold",
    "lane_garbage_ack",
    "stale_epoch",
)


def _resolve_enqueue(transport) -> Optional[Callable]:
    """Find a per-destination send seam by unwrapping ``.inner`` chains
    until something exposes ``enqueue(dest, msg)`` (InMemoryTransport
    does; FaultyTransport/RbcTransport wrap it). Per-destination sends
    still traverse the wrapper's delivery-time fault/RBC machinery —
    handlers registered with the inner broker ARE the wrapped ones.
    Returns None when the stack has no such seam (point-to-point sends
    degrade to broadcast-or-withhold)."""
    seen: set = set()
    tp = transport
    while tp is not None and id(tp) not in seen:
        seen.add(id(tp))
        fn = getattr(tp, "enqueue", None)
        if callable(fn):
            return fn
        tp = getattr(tp, "inner", None)
    return None


class ByzantineBehavior:
    """Base strategy: honest dissemination (broadcast verbatim).
    Subclasses override :meth:`disseminate`; ``stats`` counts what the
    adversary actually did, so scenario reports can assert the attack
    genuinely ran (no vacuous survivals)."""

    name = "honest"

    def __init__(self, seed: int = 0) -> None:
        self.rng = random.Random(seed)
        self.stats = {"mutated": 0, "withheld": 0, "extra_sent": 0}

    def bind(self, proc: Process) -> None:
        """Hook run once after the host process is fully constructed —
        strategies that corrupt state *creation* (not just the wire)
        install themselves here. Default: nothing."""

    def bind_lanes(self, proc: Process) -> None:
        """Hook run when a dissemination-lane coordinator is attached
        — lanes are wired post-construction, after
        :meth:`bind` has already run, so lane strategies install here.
        Default: nothing (a lanes-off run leaves lane adversaries
        honest, and their stats prove vacuity)."""

    def disseminate(self, proc: Process, v: Vertex) -> None:
        proc.transport.broadcast(self._msg(v))

    @staticmethod
    def _msg(v: Vertex) -> BroadcastMessage:
        return BroadcastMessage(vertex=v, round=v.round, sender=v.id.source)

    def _resign(self, proc: Process, v: Vertex) -> Vertex:
        """Valid signature over forged content — the adversary owns its
        key, so honest nodes must reject on *semantic* gates (edges,
        RBC consistency), not signature checks."""
        if proc.signer is not None:
            v = proc.signer.sign_vertex(v)
        return v

    def _variant(self, proc: Process, v: Vertex, tag: str) -> Vertex:
        """Same (round, source) slot, different payload, validly
        re-signed. dataclasses.replace drops the memoized digest/gate,
        so honest nodes evaluate the forgery on its own content."""
        self.stats["mutated"] += 1
        forged = dataclasses.replace(
            v,
            block=Block((f"equiv-{tag}-r{v.round}".encode(),)),
            signature=None,
        )
        return self._resign(proc, forged)


class EquivocateBehavior(ByzantineBehavior):
    """Equivocation at the source. ``split=False``: both variants are
    broadcast to everyone — a FIFO broker admits the first and every
    honest node flags the second (``equivocations_detected``), so this
    drives *detection*. ``split=True``: disjoint halves of the cluster
    receive different variants — without an RBC stage the halves admit
    conflicting payloads and agreement genuinely breaks (the planted
    violation the invariant mutation tests rely on); under ``rbc=True``
    neither variant reaches an echo quorum and safety holds."""

    name = "equivocate"

    def __init__(self, seed: int = 0, *, split: bool = False) -> None:
        super().__init__(seed)
        self.split = split
        if split:
            self.name = "equivocate_split"

    def disseminate(self, proc: Process, v: Vertex) -> None:
        alt = self._variant(proc, v, "b")
        if self.split:
            enqueue = _resolve_enqueue(proc.transport)
            if enqueue is not None:
                dests = [i for i in range(proc.cfg.n) if i != proc.index]
                self.rng.shuffle(dests)
                half = len(dests) // 2
                for d in dests[:half]:
                    enqueue(d, self._msg(v))
                for d in dests[half:]:
                    enqueue(d, self._msg(alt))
                self.stats["extra_sent"] += 1
                return
        proc.transport.broadcast(self._msg(v))
        proc.transport.broadcast(self._msg(alt))
        self.stats["extra_sent"] += 1


class WithholdBehavior(ByzantineBehavior):
    """Selective per-destination withholding: each proposal picks a
    seeded victim subset that never receives it. Victims see the slot
    referenced by later honest vertices and must recover it through the
    anti-entropy sync path (or advance without it — an f-bounded source
    owes nobody liveness of its own slots)."""

    name = "withhold"

    def disseminate(self, proc: Process, v: Vertex) -> None:
        dests = [i for i in range(proc.cfg.n) if i != proc.index]
        enqueue = _resolve_enqueue(proc.transport)
        if enqueue is None:
            # no point-to-point seam: degrade to all-or-nothing
            if self.rng.random() < 0.5:
                self.stats["withheld"] += len(dests)
                return
            proc.transport.broadcast(self._msg(v))
            return
        k = self.rng.randrange(1, max(2, len(dests)))
        victims = set(self.rng.sample(dests, k))
        msg = self._msg(v)
        for d in dests:
            if d in victims:
                self.stats["withheld"] += 1
            else:
                enqueue(d, msg)


class InvalidEdgesBehavior(ByzantineBehavior):
    """Validly signed vertices with forged edges, cycling through the
    admission-gate violation classes: a strong edge with an
    out-of-range source (>= n — sources are packed unsigned, so the
    clamp, not wraparound, must catch it), strong edges targeting the
    wrong round, fewer than quorum distinct strong parents, and weak
    edges outside [1, round-2]. Honest nodes must reject at
    ``edges_valid`` (``msgs_rejected_edges``) and stay safe and live."""

    name = "invalid_edges"
    MODES = ("oob_source", "stale_round", "thin_quorum", "weak_oob")

    def disseminate(self, proc: Process, v: Vertex) -> None:
        mode = self.MODES[self.rng.randrange(len(self.MODES))]
        proc.transport.broadcast(self._msg(self._forge(proc, v, mode)))

    def _forge(self, proc: Process, v: Vertex, mode: str) -> Vertex:
        strong, weak = v.strong_edges, v.weak_edges
        vr = v.id.round
        if mode == "stale_round" and vr < 2:
            mode = "oob_source"  # round -1 targets can't even be encoded
        if mode == "oob_source":
            strong = strong + (VertexID(vr - 1, proc.cfg.n + 7),)
        elif mode == "stale_round":
            strong = tuple(VertexID(vr - 2, e.source) for e in strong)
        elif mode == "thin_quorum":
            strong = strong[: max(1, proc.cfg.quorum - 1)]
        else:  # weak_oob: weak round vr-1 violates wr <= vr-2 (and >= 1)
            weak = weak + (VertexID(max(1, vr - 1), 0),)
        self.stats["mutated"] += 1
        forged = dataclasses.replace(
            v, strong_edges=strong, weak_edges=weak, signature=None
        )
        return self._resign(proc, forged)


class GarbageCoinBehavior(ByzantineBehavior):
    """Sustained threshold-coin pollution, applied at share *creation*
    (:meth:`bind` wraps ``coin.my_share``): every wave-boundary proposal
    carries a seeded garbage share that is a genuine G1 point — it
    decodes, enters honest share books, and lands in the first
    combination attempt (``aggregate`` walks shares sorted by source, so
    run this adversary at a LOW index) — but is no signature under any
    share key. The coin's first aggregate fails each wave and the
    batched filter must discard the junk and recombine
    (ThresholdCoin.filtered counts the recoveries). Purely random bytes
    would be useless here: they fail point decompression and aggregate
    skips them without ever engaging the filter.

    Poisoning my_share (rather than rewriting the wire) also keeps the
    vertex signature honest over the garbage — exactly the adversary
    model: a validly signed vertex whose *coin contribution* is junk.
    Share-less coins (round_robin, fixed) return None and are left
    alone."""

    name = "garbage_coin"

    def bind(self, proc: Process) -> None:
        coin = proc.coin
        orig = coin.my_share

        def poisoned(wave: int):
            if orig(wave) is None:
                return None
            self.stats["mutated"] += 1
            return self._garbage_share(wave)

        coin.my_share = poisoned  # instance attribute shadows the method

    def _garbage_share(self, wave: int) -> bytes:
        from dag_rider_tpu_torch.crypto import bls12381 as bls

        pt = bls.hash_to_g1(
            b"dagrider-garbage-share|"
            + wave.to_bytes(8, "little")
            + self.rng.randbytes(8)
        )
        return bls.g1_compress(pt)


class LaneWithholdBehavior(ByzantineBehavior):
    """Payload withholding at the lane layer: vertices and
    lane *refs* flow honestly, but each lane batch is withheld from a
    seeded victim subset. A victim admits and orders the carrier vertex
    normally (ordering is payload-blind — that's the point of lanes)
    and only discovers the hole at delivery resolution, where
    fetch-on-miss must recover the bytes from a certified holder. If
    the victim set is large enough to starve the 2f+1 ack quorum, the
    producer's own materialize degrades the block to the inline oracle
    instead — zero loss either way."""

    name = "lane_withhold"

    def bind_lanes(self, proc: Process) -> None:
        coord = proc.lanes
        if coord is None:
            return
        endpoint = coord.endpoint
        dests = [i for i in range(proc.cfg.n) if i != proc.index]

        def withholding(digest: bytes, payload: bytes) -> int:
            k = self.rng.randrange(1, max(2, len(dests)))
            victims = set(self.rng.sample(dests, k))
            sent = 0
            for d in dests:
                if d in victims:
                    self.stats["withheld"] += 1
                else:
                    endpoint.send(d, "batch", (digest, payload))
                    sent += 1
            return sent

        coord._broadcast_batch = withholding  # instance attr shadows


class LaneGarbageAckBehavior(ByzantineBehavior):
    """Garbage availability acks: this process receives lane
    batches honestly (it must — an f-bounded adversary can't fake what
    it serves on fetch) but answers every one with a corrupted ack —
    wrong digest echo plus junk signature bytes. Producers key ack
    collection by echoed digest and structurally filter shares, so the
    garbage never enters a certificate; at n = 3f+1 the remaining
    self + (n-1-f) honest acks are exactly the 2f+1 quorum, so honest
    producers still certify every batch."""

    name = "lane_garbage_ack"

    def bind_lanes(self, proc: Process) -> None:
        coord = proc.lanes
        if coord is None:
            return

        def garbled(digest: bytes):
            self.stats["mutated"] += 1
            bad_digest = bytes(b ^ 0xFF for b in digest)
            return bad_digest, self.rng.randbytes(48)

        coord._make_ack = garbled  # instance attr shadows the method


class StaleEpochBehavior(ByzantineBehavior):
    """Pre-rotation replay: every proposal is disseminated
    honestly, tagged with the sender's current epoch, and recorded;
    once the host crosses an epoch boundary the recorded pre-boundary
    traffic is re-broadcast verbatim — old epoch tag and all. Honest
    receivers must drop each replay at the wire stale gate
    (``epoch_stale_rejected``) before spending signature or RBC work on
    it; a replayed coin share from the pre-rotation key set must never
    enter a post-rotation share book. With the epoch path off the
    behavior degrades to honest and its stats prove vacuity."""

    name = "stale_epoch"
    KEEP = 32  # recorded messages retained
    REPLAY = 4  # stale replays injected per fresh proposal

    def __init__(self, seed: int = 0) -> None:
        super().__init__(seed)
        self._recorded: list = []  # (epoch_at_send, BroadcastMessage)

    def disseminate(self, proc: Process, v: Vertex) -> None:
        mgr = proc.epoch_mgr
        cur = mgr.epoch if mgr is not None else 0
        msg = BroadcastMessage(
            vertex=v, round=v.round, sender=v.id.source, epoch=cur
        )
        proc.transport.broadcast(msg)
        if mgr is None:
            return
        stale = [m for e, m in self._recorded if e < cur]
        self.rng.shuffle(stale)
        for m in stale[: self.REPLAY]:
            proc.transport.broadcast(m)
            self.stats["extra_sent"] += 1
        self._recorded.append((cur, msg))
        if len(self._recorded) > self.KEEP:
            self._recorded.pop(0)


def make_behavior(kind: str, seed: int = 0) -> ByzantineBehavior:
    """Factory over :data:`ADVERSARIES` (scenario runner / bench rung)."""
    if kind == "equivocate":
        return EquivocateBehavior(seed)
    if kind == "equivocate_split":
        return EquivocateBehavior(seed, split=True)
    if kind == "withhold":
        return WithholdBehavior(seed)
    if kind == "invalid_edges":
        return InvalidEdgesBehavior(seed)
    if kind == "garbage_coin":
        return GarbageCoinBehavior(seed)
    if kind == "lane_withhold":
        return LaneWithholdBehavior(seed)
    if kind == "lane_garbage_ack":
        return LaneGarbageAckBehavior(seed)
    if kind == "stale_epoch":
        return StaleEpochBehavior(seed)
    raise ValueError(f"unknown adversary {kind!r} (choose from {ADVERSARIES})")


class ByzantineProcess(Process):
    """A Process whose wire output is driven by a ByzantineBehavior.

    Local state stays honest — the vertex inserted into this process's
    own DAG is the unforged original, and mutation happens only at the
    ``_broadcast_vertex`` seam. That is deliberate: the adversary's
    *peers* are under test, and a forged out-of-range edge inside the
    adversary's own dense mirrors would crash the adversary instead of
    probing the honest admission gates."""

    def __init__(
        self,
        cfg,
        index: int,
        transport,
        *,
        behavior: Optional[ByzantineBehavior] = None,
        **kwargs,
    ) -> None:
        # set before super().__init__: start() may propose immediately
        self.behavior = behavior if behavior is not None else ByzantineBehavior()
        super().__init__(cfg, index, transport, **kwargs)
        # bind AFTER construction (needs self.coin etc.); the first
        # wave-boundary proposal is rounds away, so nothing is missed
        self.behavior.bind(self)

    def _broadcast_vertex(self, v: Vertex) -> None:
        self.behavior.disseminate(self, v)

    def attach_lanes(self, coordinator) -> None:
        # lanes are wired after __init__ (simulator post-construction
        # pass), so lane behaviors get their own bind point here
        super().attach_lanes(coordinator)
        self.behavior.bind_lanes(self)
