"""Fault-injection transport wrapper.

The port's copy of ``dag_rider_tpu/transport/faults.py``.

The reference never injects or tolerates a single fault — ``faulty`` is only
an arithmetic parameter (SURVEY.md §5: "required to claim BFT capability at
all"). This wrapper layers Byzantine network behavior over any Transport:

- drop: lose a message to some destination,
- delay: hold a message back (delivered on ``flush_delayed``),
- duplicate: deliver twice,
- equivocate: substitute a conflicting vertex for a chosen sender.

All decisions come from a seeded RNG — runs are reproducible.

Faults are applied at DELIVERY time, per (message, destination): subscribe
captures each process's real handler and registers a wrapping handler with
the inner transport, so the wrapper needs nothing from the inner beyond
the two-method Transport interface — any broadcast/subscribe transport
composes (before that the wrapper reached into
InMemoryTransport.enqueue/subscribers and the "any Transport" claim was
false). For the in-memory default the observable schedule is unchanged:
FIFO delivery order equals enqueue order equals broadcast order, so the
seeded roll sequence — and therefore every seed-pinned chaos test —
is identical to the old broadcast-time injection.

WAN mode: pass ``topology=`` a :class:`WanTopology` and the
single uniform roll is replaced by per-link (src, dst) behavior — an RTT
matrix with jitter, per-link drop/duplicate overrides, and scheduled
:class:`Partition`\\ s that *heal*: traffic across a severed cut is held
(not lost) and released once the partition ends. The wrapper gains a
virtual clock — drive it with :meth:`advance`; ``flush_delayed`` still
means "eventual delivery NOW" and drains everything held. The legacy
single-roll path is untouched when no topology is given, so the seeded
roll sequence of existing chaos tests stays byte-identical.
"""

from __future__ import annotations

import dataclasses
import heapq
import random
from typing import Callable, Dict, List, Optional, Tuple

from dag_rider_tpu_torch.core.types import BroadcastMessage, Vertex
from dag_rider_tpu_torch.transport.base import Handler, Transport
from dag_rider_tpu_torch.transport.memory import InMemoryTransport


@dataclasses.dataclass
class FaultPlan:
    """Probabilities per (message, destination) decision."""

    drop: float = 0.0
    delay: float = 0.0
    duplicate: float = 0.0
    # source indices considered Byzantine for equivocation injection
    equivocators: tuple = ()
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class LinkPlan:
    """Per-(src, dst) link behavior for WAN mode. ``rtt_s`` is the round
    trip; one-way latency is ``rtt_s / 2`` plus uniform jitter in
    ``[0, jitter_s)``. ``drop``/``duplicate`` are per-delivery
    probabilities on this link."""

    rtt_s: float = 0.0
    jitter_s: float = 0.0
    drop: float = 0.0
    duplicate: float = 0.0


@dataclasses.dataclass(frozen=True)
class Partition:
    """A scheduled cut that heals: while ``start_s <= now < heal_s``,
    traffic between different ``groups`` is held and released at
    ``heal_s`` (asynchrony: delayed, never lost). Nodes absent from
    every group are unaffected."""

    start_s: float
    heal_s: float
    groups: Tuple[Tuple[int, ...], ...]

    def active(self, now: float) -> bool:
        return self.start_s <= now < self.heal_s

    def severed(self, src: int, dst: int) -> bool:
        gs = gd = None
        for gi, members in enumerate(self.groups):
            if src in members:
                gs = gi
            if dst in members:
                gd = gi
        return gs is not None and gd is not None and gs != gd


class WanTopology:
    """Per-link plans + partition schedule for FaultyTransport WAN mode.

    Resolution order for ``link(src, dst)``: an explicit ``links``
    override, else the intra/inter-region pair when built via
    :meth:`regions`, else ``default``.
    """

    def __init__(
        self,
        default: LinkPlan = LinkPlan(),
        links: Optional[Dict[Tuple[int, int], LinkPlan]] = None,
        partitions: Tuple[Partition, ...] = (),
    ) -> None:
        self.default = default
        self.links: Dict[Tuple[int, int], LinkPlan] = dict(links or {})
        self.partitions = tuple(partitions)
        self._region: Optional[List[int]] = None
        self._inter: Optional[LinkPlan] = None

    @classmethod
    def regions(
        cls,
        n: int,
        k: int = 2,
        *,
        intra: LinkPlan = LinkPlan(rtt_s=0.002),
        inter: LinkPlan = LinkPlan(rtt_s=0.04, jitter_s=0.01),
        partitions: Tuple[Partition, ...] = (),
    ) -> "WanTopology":
        """Round-robin region assignment (node i -> region i % k): cheap
        intra-region links, expensive inter-region ones — the classic
        geo-replicated shape."""
        topo = cls(default=intra, partitions=partitions)
        topo._region = [i % k for i in range(n)]
        topo._inter = inter
        return topo

    def link(self, src: int, dst: int) -> LinkPlan:
        lp = self.links.get((src, dst))
        if lp is not None:
            return lp
        if self._region is not None:
            r = self._region
            if (
                0 <= src < len(r)
                and 0 <= dst < len(r)
                and r[src] != r[dst]
            ):
                return self._inter or self.default
        return self.default

    def heal_time(self, src: int, dst: int, now: float) -> Optional[float]:
        """Latest heal time of any partition currently severing
        (src, dst), or None if the pair is connected at ``now``."""
        t: Optional[float] = None
        for p in self.partitions:
            if p.active(now) and p.severed(src, dst):
                t = p.heal_s if t is None else max(t, p.heal_s)
        return t


class FaultyTransport(Transport):
    """Wraps any Transport (in-memory by default), applying a FaultPlan
    to each delivery — and, with ``topology=``, per-link WAN behavior."""

    def __init__(
        self,
        plan: FaultPlan,
        inner: Optional[Transport] = None,
        topology: Optional[WanTopology] = None,
    ):
        self.inner: Transport = (
            inner if inner is not None else InMemoryTransport()
        )
        self.plan = plan
        self.topology = topology
        self.rng = random.Random(plan.seed)
        #: (dest, real handler, message) held back by a delay roll
        self.delayed: List[tuple] = []
        self.stats = {"dropped": 0, "delayed": 0, "duplicated": 0, "equivocated": 0}
        if topology is not None:
            # WAN gauges only exist in WAN mode: chaos tests snapshot the
            # legacy stats dict and its key set must not change under them
            self.stats["held_link"] = 0
            self.stats["held_partition"] = 0
        #: virtual clock + in-flight heap for WAN mode:
        #: (release time, seq, dest, handler, msg)
        self.now = 0.0
        self._held: List[tuple] = []
        self._seq = 0
        self._handlers: Dict[int, Handler] = {}
        self._batch_handlers: Dict[int, Callable] = {}
        self._mutator: Optional[Callable[[Vertex], Vertex]] = None
        # Grouped-pump passthrough: installed as an INSTANCE
        # attribute only for delay-free, topology-free plans, so the
        # Simulation's `callable(pump_grouped)` probe silently falls back
        # to per-message pumping whenever a roll could hold a message
        # back — delayed entries need their per-message handler captured,
        # which only the scalar path records.
        if (
            topology is None
            and plan.delay == 0.0
            and callable(getattr(self.inner, "pump_grouped", None))
        ):
            self.pump_grouped = self._pump_grouped

    def set_equivocation_mutator(self, fn: Callable[[Vertex], Vertex]) -> None:
        """How to corrupt an equivocator's vertex (defaults to payload swap)."""
        self._mutator = fn

    def subscribe(self, index: int, handler: Handler) -> None:
        self._handlers[index] = handler

        def wrapped(msg: BroadcastMessage) -> None:
            self._deliver(index, handler, msg)

        self.inner.subscribe(index, wrapped)

    def subscribe_many(
        self, index: int, handler: Callable[[list], None]
    ) -> None:
        """Register a batch handler: the inner's grouped pump hands VAL
        runs to a wrapper that pays the SAME per-message roll structure
        as :meth:`_deliver` (equivocation coin, one main roll, duplicate
        roll on delivery) and forwards the survivors as one batch call.
        Grouping permutes delivery order across destinations, so the
        roll->(message, destination) assignment differs from the scalar
        pump for the same seed — fault RATES are identical, seed-pinned
        schedules are per-pump. Falls back silently when the inner has
        no batch seam (the per-message path stays correct on its own)."""
        self._batch_handlers[index] = handler
        sub_many = getattr(self.inner, "subscribe_many", None)
        if not callable(sub_many):
            return

        def wrapped(msgs: list) -> None:
            self._deliver_batch(index, handler, msgs)

        sub_many(index, wrapped)

    def broadcast(self, msg: BroadcastMessage) -> None:
        self.inner.broadcast(msg)

    def _deliver(self, dest: int, handler: Handler, msg: BroadcastMessage) -> None:
        """One (message, destination) delivery through the plan. The
        roll structure per delivery — optional equivocation coin, one
        main drop/delay roll, a duplicate roll only when delivered — is
        the original broadcast-time sequence verbatim (WAN mode takes
        its own per-link branch instead of the single uniform roll)."""
        out = msg
        if (
            msg.kind == "val"
            and msg.vertex is not None
            and msg.sender in self.plan.equivocators
            and self.rng.random() < 0.5
        ):
            out = dataclasses.replace(msg, vertex=self._equivocate(msg.vertex))
            self.stats["equivocated"] += 1
        if self.topology is not None:
            self._deliver_wan(dest, handler, out)
            return
        roll = self.rng.random()
        if roll < self.plan.drop:
            self.stats["dropped"] += 1
            return
        if roll < self.plan.drop + self.plan.delay:
            self.stats["delayed"] += 1
            self.delayed.append((dest, handler, out))
            return
        handler(out)
        if self.rng.random() < self.plan.duplicate:
            self.stats["duplicated"] += 1
            handler(out)

    def _deliver_batch(
        self, dest: int, handler: Callable[[list], None], msgs: list
    ) -> None:
        """A VAL run for one destination through the plan, message by
        message: drops leave the batch, duplicates appear twice, an
        equivocation coin may substitute a conflicting vertex. Survivors
        go out as ONE batch call. A delay roll (possible only when the
        inner's grouped pump is driven directly — the Simulation never
        selects it for delay plans) parks the message with its
        per-message handler so flush_delayed replays it unchanged."""
        plan = self.plan
        rng = self.rng
        stats = self.stats
        out: list = []
        for msg in msgs:
            m = msg
            if (
                msg.vertex is not None
                and msg.sender in plan.equivocators
                and rng.random() < 0.5
            ):
                m = dataclasses.replace(
                    msg, vertex=self._equivocate(msg.vertex)
                )
                stats["equivocated"] += 1
            roll = rng.random()
            if roll < plan.drop:
                stats["dropped"] += 1
                continue
            if roll < plan.drop + plan.delay:
                stats["delayed"] += 1
                self.delayed.append((dest, self._handlers[dest], m))
                continue
            out.append(m)
            if rng.random() < plan.duplicate:
                stats["duplicated"] += 1
                out.append(m)
        if out:
            handler(out)

    def _deliver_wan(
        self, dest: int, handler: Handler, msg: BroadcastMessage
    ) -> None:
        """Per-link delivery: roll the LINK's drop, schedule at the
        link's one-way latency (+jitter), and hold severed traffic until
        the partition heals. Held messages release in timestamp order
        via :meth:`advance` (or all at once via flush_delayed)."""
        link = self.topology.link(msg.sender, dest)
        if link.drop and self.rng.random() < link.drop:
            self.stats["dropped"] += 1
            return
        latency = link.rtt_s / 2.0
        if link.jitter_s:
            latency += self.rng.uniform(0.0, link.jitter_s)
        release = self.now + latency
        heal = self.topology.heal_time(msg.sender, dest, self.now)
        if heal is not None:
            release = max(release, heal)
            self.stats["held_partition"] += 1
        copies = 1
        if link.duplicate and self.rng.random() < link.duplicate:
            self.stats["duplicated"] += 1
            copies = 2
        for _ in range(copies):
            if release <= self.now:
                handler(msg)
            else:
                if heal is None:
                    self.stats["held_link"] += 1
                heapq.heappush(
                    self._held, (release, self._seq, dest, handler, msg)
                )
                self._seq += 1

    def advance(self, dt: float) -> int:
        """Move the WAN virtual clock forward and deliver every held
        message that comes due, in release order. Returns deliveries.
        No-op without a topology (the legacy delayed list is released
        explicitly via flush_delayed, not by time)."""
        self.now += dt
        return self._release_due()

    def _release_due(self) -> int:
        done = 0
        while self._held and self._held[0][0] <= self.now:
            _, _, _dest, handler, msg = heapq.heappop(self._held)
            handler(msg)
            done += 1
        return done

    def _equivocate(self, v: Vertex) -> Vertex:
        if self._mutator is not None:
            return self._mutator(v)
        from dag_rider_tpu_torch.core.types import Block

        return dataclasses.replace(
            v, block=Block((b"equivocation-" + bytes(str(v.id), "ascii"),))
        )

    def flush_delayed(self) -> int:
        """Deliver all held-back messages (asynchrony: every message is
        eventually delivered). Straight to the captured real handlers —
        a delayed message already paid its fault rolls and must not roll
        again on the way out. In WAN mode this also fast-forwards the
        clock past every in-flight release (including partition holds) —
        the "eventually" drain; use :meth:`advance` for paced release."""
        held, self.delayed = self.delayed, []
        for _dest, handler, msg in held:
            handler(msg)
        count = len(held)
        if self._held:
            self.now = max(self.now, max(r for r, *_ in self._held))
            count += self._release_due()
        return count

    # pump passthrough so Simulation can drive us; inners without a pump
    # loop (push-style transports deliver inside broadcast) have nothing
    # to drive and nothing pending
    def pump_one(self) -> bool:
        fn = getattr(self.inner, "pump_one", None)
        return bool(fn()) if callable(fn) else False

    def pump(self, max_messages: Optional[int] = None) -> int:
        fn = getattr(self.inner, "pump", None)
        return int(fn(max_messages)) if callable(fn) else 0

    def _pump_grouped(self, max_messages: Optional[int] = None) -> int:
        """Bound to ``self.pump_grouped`` in ``__init__`` for delay-free,
        topology-free plans only: VAL runs reach :meth:`_deliver_batch`
        through the inner's batch seam, everything else flows through
        the per-message wrappers exactly as under :meth:`pump`."""
        return int(self.inner.pump_grouped(max_messages))

    @property
    def fanout_sentinel(self) -> bool:
        """Forwarded to the inner transport: fan-out expansion happens
        where the queue lives, and this wrapper intercepts at delivery
        time — after expansion — so sentinel compression is invisible to
        the fault rolls."""
        return bool(getattr(self.inner, "fanout_sentinel", False))

    @fanout_sentinel.setter
    def fanout_sentinel(self, value: bool) -> None:
        if hasattr(self.inner, "fanout_sentinel"):
            self.inner.fanout_sentinel = bool(value)

    @property
    def pending(self) -> int:
        """Undelivered backlog: the inner queue plus everything this
        wrapper is holding (delay rolls, WAN in-flight/partition holds).
        Held messages ARE pending deliveries — sync patience reads this
        to tell "throttled" from "partitioned"."""
        return (
            int(getattr(self.inner, "pending", 0))
            + len(self.delayed)
            + len(self._held)
        )
