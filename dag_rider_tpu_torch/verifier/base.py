"""The Verifier seam — batched vertex-signature verification.

The port's copy of ``dag_rider_tpu/verifier/base.py`` without the BLS
certificate parts: the test PKI (:class:`KeyRegistry`), the vertex signer,
the :class:`Verifier` interface and its unavailability error. Backends
(:class:`~dag_rider_tpu_torch.verifier.cpu.CPUVerifier`,
:class:`~dag_rider_tpu_torch.verifier.cuda.CUDAVerifier`) must produce
identical accept masks: consensus is a deterministic function of the masks
and the delivery schedule, so equal masks give an equal commit order.
"""

from __future__ import annotations

import abc
import dataclasses
import hashlib
from typing import List, Optional, Sequence

from dag_rider_tpu_torch.core.types import Vertex
from dag_rider_tpu_torch.crypto import ed25519


@dataclasses.dataclass(frozen=True)
class KeyRegistry:
    """source index -> Ed25519 public key (32 bytes)."""

    public_keys: tuple

    @staticmethod
    def generate(n: int, seed_prefix: bytes = b"dagrider-test-key-"):
        """Deterministic test PKI: seeds derived from the index. NOT for
        production use (seeds are guessable by construction)."""
        seeds, pubs = [], []
        for i in range(n):
            seed = hashlib.sha256(seed_prefix + str(i).encode()).digest()
            sk, pk = ed25519.generate_keypair(seed)
            seeds.append(sk)
            pubs.append(pk)
        return KeyRegistry(tuple(pubs)), seeds

    def key_of(self, source: int) -> Optional[bytes]:
        """Public key of ``source``, or None when out of range — a bad
        source yields a reject bit, never an IndexError or negative-index
        aliasing to another node's key."""
        if not 0 <= source < len(self.public_keys):
            return None
        return self.public_keys[source]

    @property
    def n(self) -> int:
        return len(self.public_keys)


class VertexSigner:
    """Signs this process's own vertices; the key expansion is done once."""

    def __init__(self, seed: bytes):
        self._a, self._prefix, self._A_enc = ed25519.expand_seed(seed)

    @property
    def public_key(self) -> bytes:
        return self._A_enc

    def sign_vertex(self, v: Vertex) -> Vertex:
        sig = ed25519.sign_expanded(
            self._a, self._prefix, self._A_enc, v.signing_bytes()
        )
        return dataclasses.replace(v, signature=sig)


class VerifierUnavailableError(RuntimeError):
    """A verifier backend could not be reached or could not complete an
    attempt (no device, failed launch) — as opposed to a verdict: no
    statement about signature validity is implied."""


class Verifier(abc.ABC):
    """Batched vertex-signature verification."""

    @abc.abstractmethod
    def verify_batch(self, vertices: Sequence[Vertex]) -> List[bool]:
        """Accept mask, same order as input. A pure function of (vertex
        bytes, registry), so every backend agrees bit for bit."""

    def verify_rounds(
        self, rounds: Sequence[Sequence[Vertex]]
    ) -> List[List[bool]]:
        """Accept masks for several rounds' batches; device backends merge
        the rounds into one padded dispatch."""
        return [self.verify_batch(r) for r in rounds]
