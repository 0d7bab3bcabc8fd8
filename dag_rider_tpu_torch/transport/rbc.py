"""Byzantine reliable broadcast (Bracha echo/ready) over any Transport.

The port's copy of ``dag_rider_tpu/transport/rbc.py``.

The reference's broker is "reliable" by fiat (``process/transport.go:5``):
an equivocating sender can hand *different signed vertices* to different
honest processes, and nothing reconciles them. This layer closes that gap
with Bracha's protocol (Bracha 1987, "Asynchronous Byzantine agreement
protocols"), per (round, source) slot:

- VAL: the sender's vertex payload (the original broadcast).
- ECHO(slot, digest): sent once per slot, for the *first* VAL received.
- READY(slot, digest): sent on 2f+1 matching ECHOs, or amplified on f+1
  matching READYs.
- deliver: on 2f+1 matching READYs *and* a held payload with that digest.
- FETCH(slot, digest): payload retransmission request — a process that saw
  a READY quorum for a digest whose VAL it never received (it got the
  equivocator's other copy, or the VAL was dropped) asks; any process
  holding the payload re-broadcasts the original VAL message.

Guarantees (n >= 3f+1, authenticated point-to-point links):
- *Consistency*: two quorums of 2f+1 intersect in an honest process that
  echoed exactly one digest — so at most one digest per slot can reach
  READY quorum, and no two honest processes deliver different contents.
- *Totality*: if any honest process delivers, its 2f+1 READYs include f+1
  honest ones, which push every honest process past the amplification
  threshold; FETCH covers the payload.

One RbcTransport wraps the shared (or networked) inner transport per
process: the Process subscribes to *it*, it subscribes to the inner
transport, and only fully-amplified VAL messages flow upward. Sender
authenticity of control messages is the inner transport's concern (the
in-memory broker stamps are taken at face value; the gRPC transport would
pin them to the peer connection).
"""

from __future__ import annotations

from typing import Dict, Optional, Set, Tuple

from dag_rider_tpu_torch.core.types import BroadcastMessage
from dag_rider_tpu_torch.transport.base import Handler, Transport

Slot = Tuple[int, int]  # (round, source) — one broadcast instance


class RbcTransport(Transport):
    """Per-process Bracha reliable-broadcast stage."""

    #: honest senders must not tunnel unicast past this stage: totality
    #: and decided-slot catch-up both hinge on peers seeing repeat VALs
    #: (ready refresh) — see transport.base.resolve_unicast
    requires_broadcast = True

    def __init__(self, inner: Transport, index: int, n: int, f: int):
        self.inner = inner
        self.index = index
        self.n = n
        self.f = f
        self.quorum = 2 * f + 1
        self._handler: Optional[Handler] = None
        # payloads held per slot, keyed by digest (an equivocator may
        # produce several; at most one can ever reach READY quorum)
        self._val: Dict[Slot, Dict[bytes, BroadcastMessage]] = {}
        self._echoed: Set[Slot] = set()
        self._readied: Set[Slot] = set()
        self._delivered: Set[Slot] = set()
        # digest that reached READY quorum per slot (unique by consistency)
        self._decided: Dict[Slot, bytes] = {}
        self._serves: Dict[Slot, int] = {}
        # READY-refresh flood control: rate limit per slot rather than a
        # lifetime budget — an exhaustible budget could be drained by
        # replayed VALs, permanently breaking catch-up for that slot.
        self.ready_refresh_cooldown_s = 0.2
        self._ready_refresh_at: Dict[Slot, float] = {}
        self._echoes: Dict[Tuple[Slot, bytes], Set[int]] = {}
        self._readies: Dict[Tuple[Slot, bytes], Set[int]] = {}
        #: slots below this round are retired (see prune_below): their
        #: state is dropped and new frames for them are discarded, so a
        #: replayed VAL cannot regrow the books.
        self.floor = 0

    def prune_below(self, floor: int) -> int:
        """Retire per-slot Bracha state for rounds below ``floor``.

        The owning Process calls this with its GC floor
        (Process.maybe_prune; checkpoint/snapshot restore re-establishes
        it): below the floor, vertices are excluded from delivery at
        every correct process and sync windows are refused, so
        echo/ready bookkeeping for those slots is dead weight — the same
        unbounded-growth class DagState.prune_below retires. The floor
        also gates _on_inner: frames for retired slots are dropped, not
        re-admitted into fresh state.

        Liveness across DIVERGING floors (peers prune at different
        times, so a pruned peer can no longer refresh READY for a
        laggard's catch-up slot): with at most f peers pruned past a
        slot, 2f of the remaining peers' READYs reach the laggard, whose
        own amplification (f+1 READYs -> READY) completes the 2f+1
        quorum; once f+1 peers have pruned past it, those same peers
        nack the laggard's sync window and the f+1-nack quorum routes it
        to peer state transfer instead (Process._on_sync_nack) — the
        boundary is exact, no wedge gap. Returns entries removed."""
        if floor <= self.floor:
            return 0
        self.floor = floor
        removed = 0
        for d in (self._val, self._decided, self._serves, self._ready_refresh_at):
            for k in [k for k in d if k[0] < floor]:
                del d[k]
                removed += 1
        for s in (self._echoed, self._readied, self._delivered):
            for k in [k for k in s if k[0] < floor]:
                s.discard(k)
                removed += 1
        for book in (self._echoes, self._readies):
            for k in [k for k in book if k[0][0] < floor]:
                del book[k]
                removed += 1
        return removed

    # -- Transport interface ------------------------------------------------

    def subscribe(self, index: int, handler: Handler) -> None:
        if index != self.index:
            raise ValueError(
                f"RbcTransport {self.index} hosts only its own process"
            )
        if self._handler is not None:
            raise ValueError("already subscribed")
        self._handler = handler
        self.inner.subscribe(index, self._on_inner)

    def unsubscribe(self) -> None:
        """Release this slot and the inner transport's — a rebuilt
        Process (corrupt-checkpoint recovery) re-subscribes the chain."""
        self._handler = None
        unsub = getattr(self.inner, "unsubscribe", None)
        if unsub is not None:
            unsub()

    def broadcast(self, msg: BroadcastMessage) -> None:
        """r_bcast: send VAL and join the echo voting for our own vertex
        (the inner broker excludes the sender from fan-out, so the sender's
        ECHO/READY participation happens locally here). Consensus-level
        control messages (sync) ride the wire without Bracha processing."""
        self.inner.broadcast(msg)
        if msg.kind == "val" and msg.vertex is not None:
            self._on_val(msg)

    @property
    def pending(self) -> int:
        """Inner-broker backlog passthrough — sync patience reads this
        to tell a throttled pump from a real partition."""
        return int(getattr(self.inner, "pending", 0))

    # -- protocol -----------------------------------------------------------

    def _on_inner(self, msg: BroadcastMessage) -> None:
        if (
            self.floor
            and msg.kind in ("val", "echo", "ready", "fetch")
            and msg.round < self.floor
        ):
            return  # retired slot (see prune_below): drop, don't regrow
        if msg.kind == "val" and msg.vertex is not None:
            self._on_val(msg)
        elif msg.kind == "echo":
            self._on_echo(msg)
        elif msg.kind == "ready":
            self._on_ready(msg)
        elif msg.kind == "fetch":
            self._on_fetch(msg)
        elif self._handler is not None:
            # consensus-level control (sync requests) passes straight up;
            # the Process validates and handles it.
            self._handler(msg)

    def _ctrl(self, kind: str, slot: Slot, digest: bytes) -> None:
        self.inner.broadcast(
            BroadcastMessage(
                vertex=None,
                round=slot[0],
                sender=self.index,
                kind=kind,
                origin=slot[1],
                digest=digest,
            )
        )

    def _vote(
        self,
        book: Dict[Tuple[Slot, bytes], Set[int]],
        slot: Slot,
        digest: bytes,
        voter: int,
    ) -> int:
        voters = book.setdefault((slot, digest), set())
        voters.add(voter)
        return len(voters)

    def _on_val(self, msg: BroadcastMessage) -> None:
        v = msg.vertex
        # Slot authenticity: a VAL for slot (r, s) must arrive stamped by
        # s itself (FETCH retransmissions preserve the original stamps, so
        # they pass too). Without this, any Byzantine peer could front-run
        # an honest node's slot with a forged vertex and censor the honest
        # broadcast forever.
        if msg.sender != v.id.source or msg.round != v.id.round:
            return
        slot = (v.id.round, v.id.source)
        digest = v.digest()
        self._val.setdefault(slot, {}).setdefault(digest, msg)
        if slot not in self._echoed:
            self._echoed.add(slot)
            self._vote(self._echoes, slot, digest, self.index)
            self._ctrl("echo", slot, digest)
            self._maybe_ready(slot, digest)
        elif self._decided.get(slot) == digest:
            # Catch-up support: a repeat VAL for a slot we already decided
            # is a laggard being served (Process._serve_sync re-broadcasts
            # old vertices). Our Bracha instance is long done and would
            # never re-send READY, so the laggard could hold the payload
            # yet never re-reach a READY quorum. Re-sending our READY
            # (rate-limited per slot) lets 2f+1 up-to-date peers rebuild
            # that quorum — consistency is untouched because only the
            # decided digest is ever refreshed.
            import time as _time

            now = _time.monotonic()
            if (
                now - self._ready_refresh_at.get(slot, float("-inf"))
                >= self.ready_refresh_cooldown_s
            ):
                self._ready_refresh_at[slot] = now
                self._ctrl("ready", slot, digest)
        self._maybe_deliver(slot)

    def _on_echo(self, msg: BroadcastMessage) -> None:
        if msg.origin is None or msg.digest is None:
            return
        slot = (msg.round, msg.origin)
        self._vote(self._echoes, slot, msg.digest, msg.sender)
        self._maybe_ready(slot, msg.digest)

    def _on_ready(self, msg: BroadcastMessage) -> None:
        if msg.origin is None or msg.digest is None:
            return
        slot = (msg.round, msg.origin)
        n = self._vote(self._readies, slot, msg.digest, msg.sender)
        if n >= self.quorum:
            self._decided.setdefault(slot, msg.digest)
        self._maybe_ready(slot, msg.digest)
        self._maybe_deliver(slot)

    def _on_fetch(self, msg: BroadcastMessage) -> None:
        if msg.origin is None or msg.digest is None:
            return
        slot = (msg.round, msg.origin)
        held = self._val.get(slot, {}).get(msg.digest)
        # Bounded re-serving: a single response can be lost or re-corrupted
        # in flight (totality would silently fail one-shot), but serving
        # every fetch forever would let a Byzantine peer amplify traffic.
        if held is not None and self._serves.get(slot, 0) < 2 * self.n:
            self._serves[slot] = self._serves.get(slot, 0) + 1
            self.inner.broadcast(held)  # original stamps preserved

    def _maybe_ready(self, slot: Slot, digest: bytes) -> None:
        if slot in self._readied:
            return
        echoes = len(self._echoes.get((slot, digest), ()))
        readies = len(self._readies.get((slot, digest), ()))
        if echoes >= self.quorum or readies >= self.f + 1:
            self._readied.add(slot)
            n = self._vote(self._readies, slot, digest, self.index)
            if n >= self.quorum:
                self._decided.setdefault(slot, digest)
            self._ctrl("ready", slot, digest)
            self._maybe_deliver(slot)

    def _maybe_deliver(self, slot: Slot) -> None:
        if slot in self._delivered:
            return
        digest = self._decided.get(slot)
        if digest is None:
            return
        held = self._val.get(slot, {}).get(digest)
        if held is None:
            # READY quorum for a payload we never saw (equivocation or
            # drop): ask for a retransmission. Re-asked on every subsequent
            # VAL/READY for the slot, so a lost response is retried.
            self._ctrl("fetch", slot, digest)
            return
        self._delivered.add(slot)
        if self._handler is not None and held.sender != self.index:
            self._handler(held)
