"""In-memory broadcast broker with a deterministic pump.

The port's copy of ``dag_rider_tpu/transport/memory.py``.

Counterpart of the reference's ``Transport`` broker
(``process/transport.go:11-32``) with D12 fixed:

- one lock guards both ``subscribe`` and ``broadcast`` (the reference's
  ``Broadcast`` iterates ``subs`` lockless while ``Subscribe`` appends);
- the sender is excluded from fan-out (a process inserts its own vertex
  directly — the reference loops messages back to the sender);
- delivery is decoupled from broadcast: ``broadcast`` only enqueues, and a
  pump (:meth:`pump` / :meth:`pump_one`) drains the queue FIFO. This gives
  deterministic, replayable schedules for tests — the reference's
  channel-fanout schedule is whatever the Go runtime decides.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Deque, Dict, Optional, Tuple

from dag_rider_tpu_torch.core.types import BroadcastMessage
from dag_rider_tpu_torch.transport.base import Handler, Transport


class InMemoryTransport(Transport):
    """N processes in one OS process, zero networking — the simulation
    backend for integration tests (SURVEY.md §4 "multi-node story")."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._handlers: Dict[int, Handler] = {}
        #: optional per-destination BATCH handlers (on_messages shape)
        #: used only by :meth:`pump_grouped`
        self._batch_handlers: Dict[int, Callable] = {}
        self._queue: Deque[Tuple[int, BroadcastMessage]] = deque()
        self._fanout: list[int] = []  # sorted handler ids, cached
        #: When True, :meth:`broadcast` queues ONE ``(-1, msg, start)``
        #: sentinel per send instead of n-1 ``(dest, msg)`` pairs; pumps
        #: expand it lazily in subscriber order (sender skipped) with
        #: budget-exact splitting, so delivery order and ``max_messages``
        #: boundaries are entry-for-entry identical to eager fan-out.
        #: Requires a subscriber set that is fixed before traffic flows
        #: (expansion reads the CURRENT fan-out list) — the Simulation
        #: flips it on only after construction wires every process.
        self.fanout_sentinel = False
        self.delivered_count = 0

    def subscribe(self, index: int, handler: Handler) -> None:
        with self._lock:
            if index in self._handlers:
                raise ValueError(f"process {index} already subscribed")
            self._handlers[index] = handler
            self._fanout = sorted(self._handlers)

    def subscribe_many(
        self, index: int, handler: Callable[[list], None]
    ) -> None:
        """Register a batch handler (one call, a list of messages) for a
        destination that already has a per-message subscription.
        :meth:`pump_grouped` prefers it for VAL runs; everything else
        still flows through the per-message handler."""
        with self._lock:
            if index not in self._handlers:
                raise KeyError(f"no subscriber {index}")
            self._batch_handlers[index] = handler

    def broadcast(self, msg: BroadcastMessage) -> None:
        with self._lock:
            if self.fanout_sentinel:
                self._queue.append((-1, msg, 0))
            else:
                sender = msg.sender
                self._queue.extend(
                    (dest, msg) for dest in self._fanout if dest != sender
                )

    def _pop_expanded(self, want: int) -> list:
        """Pop up to ``want`` deliverable ``(dest, msg)`` pairs off the
        queue head (call with the lock HELD), expanding fan-out
        sentinels in subscriber order. A sentinel that straddles the
        budget boundary is split: the delivered prefix joins the batch
        and a resumed sentinel for the remaining subscribers goes back
        at the head, so chunked pumping sees the exact same per-message
        boundaries as an eagerly fanned-out queue."""
        q = self._queue
        batch: list = []
        while q and len(batch) < want:
            e = q.popleft()
            if e[0] >= 0:
                batch.append(e)
                continue
            msg, start = e[1], e[2]
            sender = msg.sender
            pairs = [
                (i, d)
                for i, d in enumerate(self._fanout[start:], start)
                if d != sender
            ]
            room = want - len(batch)
            if len(pairs) > room:
                q.appendleft((-1, msg, pairs[room][0]))
                pairs = pairs[:room]
            batch.extend((d, msg) for _, d in pairs)
        return batch

    # -- composition hooks (used by FaultyTransport / schedulers) ----------

    def subscribers(self) -> list[int]:
        with self._lock:
            return sorted(self._handlers)

    def enqueue(self, dest: int, msg: BroadcastMessage) -> None:
        """Queue a message for one destination (bypassing fan-out) — the
        seam fault-injection wrappers compose through."""
        with self._lock:
            if dest not in self._handlers:
                raise KeyError(f"no subscriber {dest}")
            self._queue.append((dest, msg))

    def drain_pending(self) -> list[Tuple[int, BroadcastMessage]]:
        """Atomically remove and return all queued (dest, msg) pairs —
        schedulers reorder these and requeue. Sentinels expand here:
        schedulers address individual copies."""
        with self._lock:
            items: list = []
            for e in self._queue:
                if e[0] >= 0:
                    items.append(e)
                else:
                    msg = e[1]
                    items.extend(
                        (d, msg)
                        for d in self._fanout[e[2] :]
                        if d != msg.sender
                    )
            self._queue.clear()
        return items

    def requeue(self, items) -> None:
        with self._lock:
            self._queue.extend(items)

    # -- pump --------------------------------------------------------------

    def pump_one(self) -> bool:
        """Deliver the oldest queued message. Returns False if idle."""
        with self._lock:
            batch = self._pop_expanded(1)
            if not batch:
                return False
            dest, msg = batch[0]
            handler = self._handlers[dest]
        handler(msg)  # outside the lock: handlers may broadcast
        self.delivered_count += 1
        return True

    def pump(self, max_messages: int | None = None) -> int:
        """Deliver until the queue drains (or ``max_messages``).

        Messages are popped in batches under ONE lock acquisition and
        delivered outside it — per-message lock round-trips were ~10% of
        the n=256 host profile. Handlers may broadcast re-entrantly
        (their sends append under the lock and are picked up by the next
        batch pop), and delivery order is unchanged: batches pop from
        the head in FIFO order.
        """
        delivered = 0
        handlers = self._handlers
        while max_messages is None or delivered < max_messages:
            want = 1024 if max_messages is None else min(
                1024, max_messages - delivered
            )
            with self._lock:
                batch = self._pop_expanded(want)
            if not batch:
                break
            done = 0
            try:
                for dest, msg in batch:
                    handlers[dest](msg)
                    done += 1
            finally:
                # A handler that raises mid-batch must lose at most the
                # ONE in-flight message (pump_one semantics): requeue the
                # undelivered tail at the head, count the delivered
                # prefix.
                if done < len(batch):
                    with self._lock:
                        self._queue.extendleft(reversed(batch[done + 1 :]))
                self.delivered_count += done
                delivered += done
        return delivered

    def _flush_groups(self, groups: Dict[int, list]) -> int:
        """Deliver pending VAL runs, one batch call per destination in
        first-appearance order; entries leave ``groups`` only once
        delivered, so on an exception the leftover dict is exactly what
        the caller must requeue."""
        count = 0
        while groups:
            dest = next(iter(groups))
            msgs = groups[dest]
            bh = self._batch_handlers.get(dest)
            if bh is not None:
                bh(msgs)
            else:
                h = self._handlers[dest]
                for m in msgs:
                    h(m)
            del groups[dest]
            count += len(msgs)
        return count

    def pump_grouped(self, max_messages: int | None = None) -> int:
        """Deliver like :meth:`pump`, but each run of consecutive VAL
        messages is handed out as ONE batch call per destination
        (:meth:`subscribe_many`), destinations in first-appearance
        order; any non-VAL message is a barrier — pending runs flush,
        then the control message is delivered singly in its exact FIFO
        queue position.

        Caller contract: grouping permutes VAL delivery order ACROSS
        destinations within a run (per-destination FIFO is always
        preserved), which is invisible exactly when VAL delivery has no
        transport side effects — processes in deferred-step vector
        mode, where delivery only queues to the inbox. The Simulation
        checks that before choosing this pump. On a raising handler the
        in-flight control message is lost (scalar pump semantics) or
        the in-flight VAL group is requeued whole (redelivery is safe:
        processes dedup), and everything not yet delivered requeues at
        the head.
        """
        delivered = 0
        handlers = self._handlers
        while max_messages is None or delivered < max_messages:
            # Unlike :meth:`pump`'s 1024 chunk, take the whole remaining
            # budget per chunk: chunk size is invisible (popped batches
            # are FIFO and re-entrant broadcasts append BEHIND the
            # pre-existing queue either way), and big chunks turn the
            # per-destination runs from slivers into real batches.
            want = 65536 if max_messages is None else min(
                65536, max_messages - delivered
            )
            # Pop-and-group under ONE lock hold: VAL copies land
            # straight in their per-destination runs (fan-out sentinels
            # append their copies without ever materializing (dest, msg)
            # pairs), and the first control message ends the chunk — it
            # is delivered singly after the pending runs flush, which is
            # exactly the barrier position it held in the queue.
            groups: Dict[int, list] = {}
            ctrl: Optional[Tuple[int, BroadcastMessage]] = None
            got = 0
            with self._lock:
                q = self._queue
                fanout = self._fanout
                while q and got < want:
                    e = q.popleft()
                    d0 = e[0]
                    if d0 >= 0:
                        msg = e[1]
                        if msg.kind != "val":
                            ctrl = e
                            got += 1
                            break
                        g = groups.get(d0)
                        if g is None:
                            g = groups[d0] = []
                        g.append(msg)
                        got += 1
                        continue
                    msg, start = e[1], e[2]
                    sender = msg.sender
                    if msg.kind != "val":
                        # control broadcast: re-materialize its copies
                        # at the head; the next iterations barrier them
                        # one by one in FIFO position
                        q.extendleft(
                            reversed(
                                [
                                    (d, msg)
                                    for d in fanout[start:]
                                    if d != sender
                                ]
                            )
                        )
                        continue
                    i = start
                    last = len(fanout)
                    room = want - got
                    while i < last and room:
                        d = fanout[i]
                        i += 1
                        if d == sender:
                            continue
                        g = groups.get(d)
                        if g is None:
                            g = groups[d] = []
                        g.append(msg)
                        got += 1
                        room -= 1
                    if i < last:
                        # budget hit mid-fan-out: resume sentinel keeps
                        # the remaining copies at the exact queue head
                        q.appendleft((-1, msg, i))
            if not got:
                break
            done = 0
            ctrl_pending = ctrl is not None
            try:
                done += self._flush_groups(groups)
                if ctrl is not None:
                    # in flight from here: lost if its handler raises
                    # (scalar pump semantics)
                    ctrl_pending = False
                    handlers[ctrl[0]](ctrl[1])
                    done += 1
            finally:
                undelivered = [
                    (d, m) for d, msgs in groups.items() for m in msgs
                ]
                if ctrl_pending:
                    # flush raised before the barrier was in flight:
                    # the control goes back AFTER the leftover runs it
                    # followed in the queue
                    undelivered.append(ctrl)
                if undelivered:
                    with self._lock:
                        self._queue.extendleft(reversed(undelivered))
                self.delivered_count += done
                delivered += done
        return delivered

    @property
    def pending(self) -> int:
        with self._lock:
            if not self.fanout_sentinel:
                return len(self._queue)
            n = 0
            for e in self._queue:
                if e[0] >= 0:
                    n += 1
                else:
                    msg = e[1]
                    n += sum(
                        1
                        for d in self._fanout[e[2] :]
                        if d != msg.sender
                    )
            return n
