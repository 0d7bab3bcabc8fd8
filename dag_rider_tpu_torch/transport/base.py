"""Transport — the pluggable broadcast boundary.

The port's copy of ``dag_rider_tpu/transport/base.py``.

The reference's only plugin seam (``process/transport.go:6-9``): a process
receives a Transport at construction and never touches the network
otherwise. We keep that seam and fix its defects (SURVEY.md D12):

- delivery is via registered per-process handlers, not bare channels;
- no delivery to the sender (a process inserts its own vertex directly);
- implementations must be race-free between ``broadcast`` and ``subscribe``.

Implementations: in-memory broker with a deterministic pump
(:mod:`dag_rider_tpu_torch.transport.memory`), fault-injection wrapper
(:mod:`dag_rider_tpu_torch.transport.faults`), and a socket transport for
multi-host deployments (:mod:`dag_rider_tpu_torch.transport.net`).
"""

from __future__ import annotations

import abc
from typing import Callable, Optional

from dag_rider_tpu_torch.core.types import BroadcastMessage

Handler = Callable[[BroadcastMessage], None]


def resolve_unicast(transport) -> Optional[Callable]:
    """Find a per-destination send seam for PROTOCOL traffic: unwrap
    ``.inner`` chains until something exposes ``enqueue(dest, msg)``
    (InMemoryTransport does; FaultyTransport composes through it —
    handlers registered with the inner broker are the fault-wrapped
    ones, so unicast sends still pay delivery-time fault rolls).

    Stops with None at any layer that declares ``requires_broadcast``
    (RbcTransport): Bracha's totality/catch-up depends on every peer
    seeing repeat VALs, so honest senders must not tunnel past it.
    A layer may also declare ``protocol_unicast = False`` to keep its
    ``enqueue`` OUT of honest protocol routing while still exposing it
    to the Byzantine adversary seam (GrpcTransport: single-copy sync
    over a real socket loses whole patience windows to send failures
    during recovery, so honest serves keep broadcast redundancy).
    (The adversary seam in consensus/adversary.py unwraps
    unconditionally — NOT honoring these contracts is the attack.)

    Returns None when the stack has no such seam; callers degrade to
    broadcast."""
    seen: set = set()
    tp = transport
    while tp is not None and id(tp) not in seen:
        seen.add(id(tp))
        if getattr(tp, "requires_broadcast", False):
            return None
        fn = getattr(tp, "enqueue", None)
        if callable(fn) and getattr(tp, "protocol_unicast", True):
            return fn
        tp = getattr(tp, "inner", None)
    return None


class Transport(abc.ABC):
    """Reliable point-to-all broadcast abstraction (r_bcast / r_deliver).

    Like the reference (``transport.go:5``), the transport itself is the
    "reliable" layer by fiat for in-process deployments; Byzantine-grade
    reliable broadcast (echo/ready amplification) layers on top — see
    :mod:`dag_rider_tpu_torch.transport.rbc`.
    """

    @abc.abstractmethod
    def broadcast(self, msg: BroadcastMessage) -> None:
        """Queue ``msg`` for delivery to every subscriber except the sender."""

    @abc.abstractmethod
    def subscribe(self, index: int, handler: Handler) -> None:
        """Register ``handler`` as process ``index``'s delivery callback."""
