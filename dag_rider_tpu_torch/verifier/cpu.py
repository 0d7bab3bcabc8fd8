"""CPU Verifier backend — the host RFC 8032 oracle."""

from __future__ import annotations

from typing import List, Sequence

from dag_rider_tpu_torch.core.types import Vertex
from dag_rider_tpu_torch.crypto import ed25519
from dag_rider_tpu_torch.verifier.base import KeyRegistry, Verifier


class CPUVerifier(Verifier):
    """Pure-host RFC 8032 verification, one vertex at a time."""

    def __init__(self, registry: KeyRegistry):
        self.registry = registry

    def verify_batch(self, vertices: Sequence[Vertex]) -> List[bool]:
        items = []
        for v in vertices:
            pk = self.registry.key_of(v.source)
            # missing key / missing signature degrade to items that
            # ed25519.verify rejects by length
            items.append((pk or b"", v.signing_bytes(), v.signature or b""))
        return ed25519.verify_batch(items)


class NullVerifier(Verifier):
    """Accept-everything backend — reproduces the reference's (absent)
    authentication for differential runs against reference semantics."""

    def verify_batch(self, vertices: Sequence[Vertex]) -> List[bool]:
        return [True] * len(vertices)
