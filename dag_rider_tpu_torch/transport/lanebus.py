"""In-memory lane channel for payload dissemination.

The port's copy of ``dag_rider_tpu/transport/lanebus.py``.

The consensus Transport orders metadata; dissemination lanes move the
payload bytes on a separate channel so block weight never rides the
pump. This is the in-process form of that channel, deliberately shaped
like :mod:`dag_rider_tpu_torch.transport.blobbus` — the same
``(sender, kind, value)`` triples and the same ``send`` / ``broadcast``
/ ``subscribe`` surface — so the item-1 cluster crossing swaps a wire
bus in without touching the lane coordinator above it.
:func:`encode_frame` / :func:`decode_frame` pin the wire layout that
crossing will serialize each triple with.

Two deliberate in-process choices, both load-bearing for the
``ladder.lanes`` A/B:

- **Only publishes are pool tasks.** A publish (encode + hash + sign +
  disseminate + collect acks) runs as ONE task on the shared worker
  pool; message delivery inside it is a direct handler call on the
  calling thread. The alternative — a pool task per (receiver, message)
  — costs ~n² executor round-trips per consensus round and drowns the
  win in scheduling overhead. With one task per publish, ``workers``
  concurrent publishes overlap their payload hashing (hashlib releases
  the GIL on large buffers), which is exactly the per-process worker
  lane the design names.
- **Values pass by reference and digests are memoized per object**
  (:meth:`LaneBus.digest_of`). On a real wire every receiver hashes the
  bytes it received; in-process every receiver holds the same immutable
  object, so the hub computes the digest once and shares the verdict —
  the same dedup argument the simulator already applies to signature
  verification (``Simulation`` shares verify verdicts across its n
  views). Re-slicing a concatenated frame per receiver would defeat the
  memo and silently reintroduce the n² hashing.

Handler exceptions propagate up the inline delivery chain into the
publish task and re-raise at ``Future.result()`` /
:meth:`LaneBus.flush` — a lane worker must never die silently under a
test.
"""

from __future__ import annotations

import hashlib
import struct
import threading
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

#: digest-memo capacity in payload objects (bounds the strong refs the
#: identity-keyed memo must hold to keep ``id()`` stable)
_MEMO_CAP = 4096

#: shared worker pools, one per distinct width — lane buses are created
#: per Simulation and a test session builds hundreds of them; pooling by
#: width bounds the live thread count at a handful instead of leaking
#: ``workers`` threads per sim
_POOLS: Dict[int, ThreadPoolExecutor] = {}
_POOLS_LOCK = threading.Lock()


def _pool(workers: int) -> ThreadPoolExecutor:
    with _POOLS_LOCK:
        p = _POOLS.get(workers)
        if p is None:
            p = ThreadPoolExecutor(
                max_workers=workers, thread_name_prefix=f"lane{workers}"
            )
            _POOLS[workers] = p
        return p


def encode_frame(sender: int, kind: str, payload: bytes) -> bytes:
    """blobbus wire layout, verbatim: u32 sender, u16 kind length, kind,
    payload — what the cluster bus serializes each delivery triple to."""
    k = kind.encode()
    return struct.pack("<IH", sender, len(k)) + k + payload


def decode_frame(data: bytes) -> Optional[Tuple[int, str, bytes]]:
    if len(data) < 6:
        return None
    sender, klen = struct.unpack_from("<IH", data, 0)
    if len(data) < 6 + klen:
        return None
    kind = data[6 : 6 + klen].decode()
    return sender, kind, data[6 + klen :]


class LaneEndpoint:
    """One process's handle on the lane bus (blobbus-shaped)."""

    def __init__(self, bus: "LaneBus", index: int) -> None:
        self.bus = bus
        self.index = index
        self._handler: Optional[Callable[[int, str, Any], None]] = None

    def subscribe(
        self, handler: Callable[[int, str, Any], None]
    ) -> None:
        self._handler = handler

    def send(self, peer: int, kind: str, value: Any) -> bool:
        """Unicast one delivery; False for an unknown peer or self.
        Synchronous: the peer's handler has run by the time this
        returns, so a fetch send is a complete request/response."""
        if peer == self.index:
            return False
        return self.bus._deliver(self.index, peer, kind, value)

    def broadcast(self, kind: str, value: Any) -> int:
        """Deliver to every other endpoint; returns the send count."""
        sent = 0
        for peer in range(self.bus.n):
            if peer != self.index and self.bus._deliver(
                self.index, peer, kind, value
            ):
                sent += 1
        return sent


class LaneBus:
    """The in-memory hub: n endpoints over one shared worker pool."""

    def __init__(self, n: int, workers: int = 1) -> None:
        self.n = n
        self.workers = workers
        self._pool = _pool(workers)
        self._lock = threading.Lock()
        self._endpoints: Dict[int, LaneEndpoint] = {}
        self._pending: List[Future] = []
        self._memo: "OrderedDict[int, Tuple[bytes, bytes]]" = OrderedDict()
        #: digest -> decoded payload Block (delivery-side analog of the
        #: digest memo: all n views deliver the same immutable batch, so
        #: the hub decodes it once — re-decoding per view would put n
        #: payload copies per vertex back on the consensus pump)
        self._blocks: "OrderedDict[bytes, object]" = OrderedDict()
        self.frames_sent = 0

    def endpoint(self, index: int) -> LaneEndpoint:
        with self._lock:
            ep = self._endpoints.get(index)
            if ep is None:
                ep = LaneEndpoint(self, index)
                self._endpoints[index] = ep
            return ep

    def digest_of(self, payload: bytes) -> bytes:
        """sha256 of ``payload``, memoized per object (module docstring:
        the in-process analog of n receivers hashing in parallel)."""
        key = id(payload)
        with self._lock:
            hit = self._memo.get(key)
            if hit is not None and hit[0] is payload:
                self._memo.move_to_end(key)
                return hit[1]
        digest = hashlib.sha256(payload).digest()
        with self._lock:
            self._memo[key] = (payload, digest)
            while len(self._memo) > _MEMO_CAP:
                self._memo.popitem(last=False)
        return digest

    def seed_block(self, digest: bytes, block: object) -> None:
        """Pre-seed the decoded-block memo with the publisher's original
        Block (its encoding hashes to ``digest`` by construction). Every
        view's delivery resolve then returns the very object the inline
        path would have delivered — no decode, no payload copy, anywhere
        on the consensus pump."""
        with self._lock:
            if digest not in self._blocks:
                self._blocks[digest] = block
                while len(self._blocks) > _MEMO_CAP:
                    self._blocks.popitem(last=False)

    def block_of(self, digest: bytes, body: bytes):
        """Decode ``body`` as a payload Block, memoized by digest.
        Safe to share across views: digests are verified against bodies
        before anything lands in a lane store, Blocks are immutable, and
        the inline path already delivers one shared Block object to all
        n views (the in-memory consensus transport passes vertices by
        reference)."""
        with self._lock:
            hit = self._blocks.get(digest)
            if hit is not None:
                self._blocks.move_to_end(digest)
                return hit
        from dag_rider_tpu_torch.core.types import Block

        block, _ = Block.decode(body)
        with self._lock:
            self._blocks[digest] = block
            while len(self._blocks) > _MEMO_CAP:
                self._blocks.popitem(last=False)
        return block

    def submit(self, fn: Callable, *args) -> Future:
        """Run ``fn`` (a publish) on the lane pool; joined by
        :meth:`flush` or the caller's ``Future.result()``."""
        fut = self._pool.submit(fn, *args)
        with self._lock:
            self._pending.append(fut)
        return fut

    def _deliver(self, sender: int, dest: int, kind: str, value: Any) -> bool:
        with self._lock:
            ep = self._endpoints.get(dest)
        if ep is None or ep._handler is None:
            return False
        self.frames_sent += 1
        # direct call on the calling thread — no lock held (the handler
        # may send in turn: acks answer batches, batches answer fetches)
        ep._handler(sender, kind, value)
        return True

    def flush(self) -> None:
        """Join every in-flight publish task, re-raising the first
        handler/publish exception (loop in case a joined task submitted
        another)."""
        while True:
            with self._lock:
                futs, self._pending = self._pending, []
            if not futs:
                return
            for f in futs:
                if f.cancelled():
                    # work-stolen by the publisher's materialize — the
                    # publish ran (to completion) on the caller instead
                    continue
                f.result()
