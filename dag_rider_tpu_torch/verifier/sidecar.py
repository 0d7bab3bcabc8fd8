"""gRPC Verifier sidecar — the north star's deployment shape.

BASELINE.json's deployment ships whole-round vertex batches over gRPC to
a sidecar that batch-verifies them on the accelerator. Two halves:

- :class:`VerifierSidecarServer` — hosts any Verifier backend (normally
  :class:`~dag_rider_tpu_torch.verifier.cuda.CUDAVerifier` on the card)
  behind one unary method ``/dagrider.Verifier/VerifyBatch``;
- :class:`RemoteVerifier` — a drop-in Verifier whose ``verify_batch``
  round-trips the batch to the sidecar.

Wire format (no protobuf codegen in the image — generic byte handlers,
like transport/net.py): request = concatenated length-prefixed frames of
codec-encoded vertices; response = one byte per vertex (0x00/0x01 mask).
The mask therefore stays byte-identical across in-process CPU, in-process
card, and remote-card verifier placements. The wire is the reference
package's, so either package's client talks to either package's server.
"""

from __future__ import annotations

import random
import threading
import time
from typing import List, Optional, Sequence

import grpc

from dag_rider_tpu_torch.core import codec
from dag_rider_tpu_torch.core.types import Vertex
from dag_rider_tpu_torch.verifier.base import Verifier, VerifierUnavailableError

_METHOD = "/dagrider.Verifier/VerifyBatch"
_identity = lambda b: b  # noqa: E731


def _encode_batch(vertices: Sequence[Vertex]) -> bytes:
    return b"".join(codec.frame(codec.encode_vertex(v)) for v in vertices)


def _decode_batch(payload: bytes) -> List[Vertex]:
    out: List[Vertex] = []
    offset = 0
    while offset < len(payload):
        item = codec.read_frame(payload, offset)
        if item is None:
            raise ValueError("truncated batch frame")
        blob, offset = item
        out.append(codec.decode_vertex(blob)[0])
    return out


class _VerifyHandler(grpc.GenericRpcHandler):
    def __init__(self, backend: Verifier):
        self._backend = backend

    def service(self, handler_call_details):
        if handler_call_details.method != _METHOD:
            return None

        def unary(request: bytes, context) -> bytes:
            try:
                batch = _decode_batch(request)
            except ValueError:
                context.abort(
                    grpc.StatusCode.INVALID_ARGUMENT, "malformed batch"
                )
            mask = self._backend.verify_batch(batch)
            return bytes(1 if ok else 0 for ok in mask)

        return grpc.unary_unary_rpc_method_handler(
            unary, request_deserializer=_identity, response_serializer=_identity
        )


class VerifierSidecarServer:
    """Hosts a Verifier backend on an insecure local port (the sidecar
    lives on the same machine/pod as the consensus host; transport auth is
    a deployment concern layered via gRPC creds if needed)."""

    def __init__(
        self,
        backend: Verifier,
        listen_addr: str = "127.0.0.1:0",
        *,
        warmup: bool = True,
        prep_workers: Optional[int] = None,
    ):
        from concurrent import futures

        # Parallel host-prep engine (verifier/prep.py): an explicit
        # worker count overrides the backend's env-derived default, set
        # before warmup so the first prep builds the right pool.
        if prep_workers is not None and hasattr(backend, "prep_workers"):
            backend.prep_workers = int(prep_workers)
        # Card-backed sidecars warm up BEFORE the port opens: the kernel
        # build (nvcc), the comb tables and one all-padding dispatch at
        # the bucket, so the first VerifyBatch RPC never pays for them.
        # Host-only backends (the CPUVerifier oracle) have no warmup.
        self.warmup_compile_s = 0.0
        if hasattr(backend, "warmup"):
            if warmup:
                self.warmup_compile_s = backend.warmup()
        # one worker: device dispatches serialize anyway, and a single
        # thread keeps per-backend batching deterministic.
        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=1))
        self._server.add_generic_rpc_handlers((_VerifyHandler(backend),))
        self.bound_port = self._server.add_insecure_port(listen_addr)
        self._server.start()

    @property
    def address(self) -> str:
        return f"127.0.0.1:{self.bound_port}"

    def stop(self) -> None:
        self._server.stop(grace=None)


class RemoteVerifier(Verifier):
    """Verifier seam implementation that defers to a sidecar.

    Fail-closed **per attempt** (SURVEY.md D10: signatures before any
    state change): a transport failure — RPC error, deadline, or a
    malformed/mis-sized reply — must never admit a vertex. What happens
    after a failed attempt is configurable:

    - ``retries`` > 0 re-sends the same payload with exponential backoff
      plus seeded jitter, reconnecting the channel between attempts (a
      restarted sidecar gets a fresh connection instead of a wedged one);
    - once every attempt has failed, the default is the pre-round-9
      contract — the whole batch reads ``[False] * n``, indistinguishable
      from n invalid signatures at the mask level (the
      ``sidecar_rpc_failures`` counter is what tells the two apart in
      metrics);
    - with ``raise_on_unavailable=True`` exhaustion raises
      :class:`VerifierUnavailableError` instead, so a degradation ladder
      (verifier/resilient.py) can hand the batch to its next tier rather
      than permanently rejecting valid vertices on a sidecar blip.

    Either way no attempt ever accepts a vertex it could not check.
    """

    def __init__(
        self,
        address: str,
        *,
        timeout: float = 30.0,
        retries: int = 0,
        backoff_s: float = 0.05,
        backoff_cap_s: float = 2.0,
        jitter: float = 0.5,
        seed: int = 0,
        raise_on_unavailable: bool = False,
    ):
        self._address = address
        self._timeout = timeout
        self._retries = max(0, int(retries))
        self._backoff_s = float(backoff_s)
        self._backoff_cap_s = float(backoff_cap_s)
        self._jitter = float(jitter)
        self._rng = random.Random(seed)
        self.raise_on_unavailable = raise_on_unavailable
        self._lock = threading.Lock()
        #: transport-level failures (RPC error/timeout/bad reply) — NOT
        #: invalid signatures; surfaced as metrics counter
        #: ``sidecar_rpc_failures`` so chaos runs can tell a dead sidecar
        #: from a batch of forgeries (both read all-False at mask level)
        self.rpc_failures = 0
        #: re-sends of a payload after a failed attempt
        self.retries_total = 0
        self._connect()

    def _connect(self) -> None:
        self._channel = grpc.insecure_channel(self._address)
        self._call = self._channel.unary_unary(
            _METHOD,
            request_serializer=_identity,
            response_deserializer=_identity,
        )

    def reconnect(self) -> None:
        """Tear down and rebuild the channel — between retry attempts and
        when a health probe wants a fresh connection to a restarted
        sidecar (gRPC keeps a failed subchannel in backoff otherwise)."""
        with self._lock:
            self._channel.close()
            self._connect()

    def _invoke(self, payload: bytes) -> bytes:
        """One locked RPC attempt — the seam the chaos harness
        (verifier/faults.py) shadows to inject sidecar failures."""
        with self._lock:
            return self._call(payload, timeout=self._timeout)

    def ping(self) -> bool:
        """Health probe: round-trip an EMPTY batch (encodes to b"", the
        backend verifies nothing and answers b""). True iff the sidecar
        answered — used by the degradation ladder to promote this tier
        back after recovery. Never counts toward rpc_failures."""
        try:
            return self._invoke(b"") == b""
        except (grpc.RpcError, VerifierUnavailableError):
            return False

    def stats(self) -> dict:
        return {
            "sidecar_rpc_failures": self.rpc_failures,
            "retries": self.retries_total,
        }

    def verify_batch(self, vertices: Sequence[Vertex]) -> List[bool]:
        if not vertices:
            return []
        payload = _encode_batch(vertices)
        delay = self._backoff_s
        for attempt in range(self._retries + 1):
            try:
                mask = self._invoke(payload)
            except (grpc.RpcError, VerifierUnavailableError):
                self.rpc_failures += 1
            else:
                if len(mask) == len(vertices):
                    return [b == 1 for b in mask]
                # a mis-sized reply is a transport fault, not a verdict
                self.rpc_failures += 1
            if attempt < self._retries:
                self.retries_total += 1
                time.sleep(delay * (1.0 + self._jitter * self._rng.random()))
                delay = min(delay * 2.0, self._backoff_cap_s)
                self.reconnect()
        if self.raise_on_unavailable:
            raise VerifierUnavailableError(
                f"sidecar {self._address} unavailable after "
                f"{self._retries + 1} attempt(s)"
            )
        return [False] * len(vertices)

    def close(self) -> None:
        self._channel.close()
