"""The Verifier seam — batched vertex-signature verification.

The port's copy of ``dag_rider_tpu/verifier/base.py``: the test PKI
(:class:`KeyRegistry`, with the BLS certificate keys of
:meth:`KeyRegistry.generate_with_cert`), the vertex signer, the BLS
certificate signer (:class:`CertSigner`), the :class:`Verifier` interface
and its unavailability error. Backends
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
from dag_rider_tpu_torch.crypto import bls12381 as bls, ed25519


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

    #: source index -> BLS12-381 G2 public key (affine fp2 tuple) for the
    #: aggregated round-certificate path. Empty when the deployment has no
    #: certificate keys.
    bls_public_keys: tuple = ()

    def bls_key_of(self, source: int):
        """BLS certificate public key of ``source`` — total, like
        :meth:`key_of`."""
        if not 0 <= source < len(self.bls_public_keys):
            return None
        return self.bls_public_keys[source]

    @staticmethod
    def generate_with_cert(
        n: int, seed_prefix: bytes = b"dagrider-test-key-"
    ):
        """The :meth:`generate` test PKI plus per-process BLS certificate
        keys. Returns (registry, ed25519 seeds, bls secret keys); the
        BLS secrets are what :class:`CertSigner` wraps."""
        reg, seeds = KeyRegistry.generate(n, seed_prefix)
        sks, pks = [], []
        for i in range(n):
            sk = (
                int.from_bytes(
                    hashlib.sha256(
                        seed_prefix + b"|bls|" + str(i).encode()
                    ).digest(),
                    "big",
                )
                % bls.R
            )
            sks.append(sk)
            pks.append(bls.pk_of(sk))
        reg = dataclasses.replace(reg, bls_public_keys=tuple(pks))
        return reg, seeds, sks


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


class CertSigner:
    """BLS-signs this process's own vertex digests for the aggregated
    round-certificate path. Separate from :class:`VertexSigner` on
    purpose: the ed25519 vertex signature stays the per-vertex oracle; the
    BLS signature only ever feeds certificate aggregation."""

    def __init__(self, sk: int):
        self._sk = sk

    def sign_digest(self, digest: bytes) -> bytes:
        return bls.sign(self._sk, digest)

    def sign_digests(self, digests: Sequence[bytes]) -> List[bytes]:
        """Round-batched share signing through ``bls12381.sign_many``, on
        the lane DAGRIDER_CERT_SIGN names; byte-identical to mapping
        :meth:`sign_digest`."""
        return bls.sign_many([self._sk] * len(digests), digests)

    #: domain tag for lane availability acks — keeps an ack share from
    #: ever being replayable as a vertex cert share: both are BLS
    #: signatures under the same key, but a cert share signs a raw vertex
    #: digest while an ack signs the tagged batch digest
    LANE_ACK_DOMAIN = b"dagrider-lane-ack-v1|"

    def sign_availability(self, digest: bytes) -> bytes:
        """Sign a lane-batch availability ack: the attestation that this
        process holds the payload bytes hashing to ``digest``."""
        return bls.sign(self._sk, self.LANE_ACK_DOMAIN + digest)


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
