"""Minimal authenticated byte bus for pre-consensus protocols.

The consensus Transport (net.py) carries the framework's canonical
BroadcastMessage codec; setup-time protocols — today the joint-Feldman
DKG (crypto/dkg.py), whose traffic is commitment vectors and encrypted
scalars, not vertices — need a plain (sender, kind, payload) channel.
This is that channel: the same dependency-free generic-handler gRPC
pattern as net.py, one unary method, with the same FrameAuth MAC wrap
(direction-bound, transport/auth.py) when auth is configured.

Deliberately simpler than GrpcTransport: no retry ladder (setup tools
poll-and-retransmit at the protocol layer), no failure detector, no
pump thread — callers poll :meth:`recv`.
"""

from __future__ import annotations

import struct
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import grpc

_SERVICE = "dagrider.BlobBus"
_METHOD = f"/{_SERVICE}/Post"
_identity = lambda b: b  # noqa: E731


def _frame(sender: int, kind: str, payload: bytes) -> bytes:
    k = kind.encode()
    return struct.pack("<IH", sender, len(k)) + k + payload


def _unframe(data: bytes) -> Optional[Tuple[int, str, bytes]]:
    if len(data) < 6:
        return None
    sender, klen = struct.unpack_from("<IH", data)
    if len(data) < 6 + klen:
        return None
    try:
        kind = data[6 : 6 + klen].decode()
    except UnicodeDecodeError:
        return None
    return sender, kind, data[6 + klen :]


class BlobBus:
    """One endpoint per participant; peers maps index -> host:port."""

    def __init__(
        self,
        index: int,
        listen_addr: str,
        peers: Dict[int, str],
        *,
        auth=None,
        max_workers: int = 4,
    ):
        self.index = index
        self._peers = dict(peers)
        self._auth = auth
        self._lock = threading.Lock()
        self._inbox: Deque[Tuple[int, str, bytes]] = deque()
        self._stubs: Dict[int, object] = {}
        self._channels: Dict[int, grpc.Channel] = {}
        from concurrent import futures

        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers)
        )

        bus = self

        class _Handler(grpc.GenericRpcHandler):
            def service(self, details):
                if details.method != _METHOD:
                    return None

                def unary(request: bytes, context) -> bytes:
                    bus._on_post(request)
                    return b"\x01"

                return grpc.unary_unary_rpc_method_handler(
                    unary,
                    request_deserializer=_identity,
                    response_serializer=_identity,
                )

        self._server.add_generic_rpc_handlers((_Handler(),))
        self.bound_port = self._server.add_insecure_port(listen_addr)
        self._server.start()

    def _on_post(self, data: bytes) -> None:
        if self._auth is not None:
            from dag_rider_tpu_torch.transport.auth import TAG_BYTES

            if len(data) < TAG_BYTES:
                return
            body, tag = data[:-TAG_BYTES], data[-TAG_BYTES:]
            parsed = _unframe(body)
            if parsed is None:
                return
            # the frame's own sender stamp is the MAC'd claimed sender —
            # a DKG complaint/reveal must be attributable
            if not self._auth.check(parsed[0], body, tag):
                return
        else:
            parsed = _unframe(data)
            if parsed is None:
                return
        with self._lock:
            self._inbox.append(parsed)

    def _stub(self, peer: int):
        with self._lock:
            if peer not in self._stubs:
                chan = grpc.insecure_channel(self._peers[peer])
                self._channels[peer] = chan
                self._stubs[peer] = chan.unary_unary(
                    _METHOD,
                    request_serializer=_identity,
                    response_deserializer=_identity,
                )
            return self._stubs[peer]

    def send(self, peer: int, kind: str, payload: bytes) -> bool:
        if peer not in self._peers or peer == self.index:
            return False  # incomplete peer table: a verdict, not a crash
        body = _frame(self.index, kind, payload)
        if self._auth is not None:
            body += self._auth.tag(peer, body)
        try:
            self._stub(peer)(body, timeout=5.0)
            return True
        except grpc.RpcError:
            return False  # protocol layer retransmits

    def broadcast(self, kind: str, payload: bytes) -> int:
        ok = 0
        for peer in sorted(self._peers):
            if peer != self.index and self.send(peer, kind, payload):
                ok += 1
        return ok

    def recv(self) -> List[Tuple[int, str, bytes]]:
        with self._lock:
            out = list(self._inbox)
            self._inbox.clear()
        return out

    def wait(self, seconds: float) -> None:
        time.sleep(seconds)

    def close(self) -> None:
        self._server.stop(grace=None)
        with self._lock:
            chans = list(self._channels.values())
        for c in chans:
            c.close()
