"""Over-the-wire load client: seeded traffic through the Submit door.

The in-process chaos suite drives :class:`~dag_rider_tpu_torch.mempool.Mempool`
objects directly; here the same seeded
:class:`~dag_rider_tpu_torch.mempool.loadgen.LoadGenerator` schedule crosses a
real socket — one JSON-framed unary RPC per transaction against
``/dagrider.Transport/Submit`` on the arrival's home node (client c →
node c mod n, mirroring ``ClusterLoadDriver``'s assignment).

A transaction counts as **accepted** only when some node's admission
verdict says so (``accepted`` — or ``deduped``, which means an earlier
ack already covered the identical bytes). Every accepted transaction is
appended to ``accepted.jsonl`` with its submit wall stamp — the audit's
zero-loss ledger and the join key (the payload bytes themselves) for
wire-level submit→deliver latency percentiles.

Failure handling is what a real client does: on an RPC error (the target
is dead, or mid kill -9) retry ONCE against the next node. If that also
fails, the transaction was never acknowledged, so the zero-loss audit
does not count it — exactly the at-least-once-ack contract.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Callable, List, Optional

import grpc

from dag_rider_tpu_torch.cluster.directory import ClusterSpec
from dag_rider_tpu_torch.mempool.loadgen import LoadGenerator

_SUBMIT_METHOD = "/dagrider.Transport/Submit"
_identity = lambda b: b  # noqa: E731 — bytes in, bytes out


class SubmitClient:
    """Thin per-cluster Submit stub pool with retry-next-node."""

    def __init__(
        self,
        spec: ClusterSpec,
        *,
        rpc_timeout_s: float = 2.0,
    ) -> None:
        self.spec = spec
        self.rpc_timeout_s = rpc_timeout_s
        self._channels: List[Optional[grpc.Channel]] = [None] * spec.n
        self._stubs: List[Optional[Callable]] = [None] * spec.n
        self._lock = threading.Lock()
        self.ok = 0
        self.errors = 0
        self.rejected = 0

    def _stub(self, node: int) -> Callable:
        with self._lock:
            stub = self._stubs[node]
            if stub is None:
                chan = grpc.insecure_channel(self.spec.addresses[node])
                self._channels[node] = chan
                stub = chan.unary_unary(
                    _SUBMIT_METHOD,
                    request_serializer=_identity,
                    response_deserializer=_identity,
                )
                self._stubs[node] = stub
            return stub

    def _drop_stub(self, node: int) -> None:
        with self._lock:
            chan = self._channels[node]
            self._channels[node] = None
            self._stubs[node] = None
        if chan is not None:
            chan.close()

    def submit(self, node: int, client: str, tx: bytes) -> Optional[dict]:
        """One transaction to ``node``, retrying once on the next node.
        Returns the admission verdict dict, or None when no node
        answered (the transaction is NOT acknowledged)."""
        body = json.dumps({"client": client, "txs": [tx.hex()]}).encode()
        for hop in range(2):
            target = (node + hop) % self.spec.n
            try:
                raw = self._stub(target)(body, timeout=self.rpc_timeout_s)
                if raw:
                    verdict = json.loads(raw)
                    verdict["node"] = target
                    return verdict
                # empty reply: door closed (shutdown) — treat as error
            except (grpc.RpcError, ValueError):
                pass
            # channel may be wedged on a dead incarnation; re-dial next use
            self._drop_stub(target)
        self.errors += 1
        return None

    def close(self) -> None:
        with self._lock:
            chans = [c for c in self._channels if c is not None]
            self._channels = [None] * self.spec.n
            self._stubs = [None] * self.spec.n
        for c in chans:
            c.close()


def drive_load(
    spec: ClusterSpec,
    *,
    duration_s: float,
    rate: float = 400.0,
    clients: int = 8,
    tx_bytes: int = 32,
    seed: int = 7,
    profile: str = "poisson",
    clock: Callable[[], float] = time.time,
    rpc_timeout_s: float = 2.0,
) -> dict:
    """Run the seeded open-loop schedule against the live cluster on the
    wall clock, recording every acknowledged transaction.

    Appends one JSON line per accepted transaction to
    ``spec.accepted_log``: ``{"tx": hex, "ts": submit stamp, "node": i,
    "client": c}``. Line-buffered like the node WALs, so the ledger
    survives a harness crash too. Returns the offered/accepted summary.
    """
    gen = LoadGenerator(
        clients=clients,
        rate=rate,
        tx_bytes=tx_bytes,
        seed=seed,
        profile=profile,
    )
    cli = SubmitClient(spec, rpc_timeout_s=rpc_timeout_s)
    accepted = 0
    deduped = 0
    shed = 0
    start = clock()
    with open(spec.accepted_log, "a", buffering=1) as ledger:
        while True:
            t = clock() - start
            if t >= duration_s:
                break
            for _, c, tx in gen.events_until(t):
                verdict = cli.submit(c % spec.n, f"c{c}", tx)
                if verdict is None:
                    continue
                if verdict.get("accepted") or verdict.get("deduped"):
                    stamp = clock()
                    if verdict.get("accepted"):
                        accepted += 1
                    else:
                        deduped += 1
                    ledger.write(
                        json.dumps(
                            {
                                "tx": tx.hex(),
                                "ts": stamp,
                                "node": verdict["node"],
                                "client": f"c{c}",
                            }
                        )
                        + "\n"
                    )
                else:
                    shed += int(verdict.get("shed", 0)) or 1
                    cli.rejected += 1
            # open loop: sleep to the next arrival, not on the system
            time.sleep(0.002)
    cli.close()
    return {
        "offered": gen.emitted,
        "accepted": accepted,
        "deduped": deduped,
        "shed": shed,
        "rpc_errors": cli.errors,
        "duration_s": duration_s,
    }


def read_accepted(path: str) -> List[dict]:
    """The accepted-transaction ledger (torn final line skipped)."""
    out: List[dict] = []
    try:
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                    if "tx" in rec:
                        out.append(rec)
                except ValueError:
                    continue
    except OSError:
        pass
    return out
