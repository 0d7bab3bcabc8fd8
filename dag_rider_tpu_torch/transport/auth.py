"""Pairwise-MAC frame authentication for networked transports.

Bracha reliable broadcast is proven under *authenticated point-to-point
links* (see transport/rbc.py): process j must not be able to inject an
ECHO/READY/FETCH/sync frame that appears to come from process i. The
reference has no networking at all; a transport that accepts any payload
on ``Deliver`` and trusts ``msg.sender`` lets a single Byzantine peer
forge a READY quorum over a network and void the 2f+1 intersection
argument.

The authenticated-links primitive is a MAC per ordered pair, NOT a
transferable signature: votes are only ever *consumed* by their direct
receiver (quorum counting is local), so nothing needs third-party
verifiability, and a pairwise HMAC-SHA256 costs ~1 us per frame where the
host Ed25519 costs ~9 ms — per-frame signatures would dominate the whole
consensus host path. Vertex payloads themselves stay Ed25519-signed by
their author (the Verifier seam), which is the transferable part the
protocol actually relies on.

Keys come from a dealer (``FrameAuth.derive``) — the same trust model the
threshold-BLS coin already uses (crypto/threshold.py ``ThresholdKeys``):
``k_ij = HMAC(master, "pair" || min(i,j) || max(i,j))``, each node holding
only its own row. The pair key is symmetric (k_ij == k_ji), so the MAC'd
data binds the *direction* — ``sender || receiver || payload`` — making the
primitive self-contained against reflection (bouncing i's frame back at i)
rather than relying on downstream per-kind sender checks. Replayed frames
in the same direction still verify (the MAC covers content, not
freshness); that is safe here because every consumer is idempotent or
rate-limited: Bracha votes land in per-(slot, digest) *sets*, and sync
serves are cooldown-throttled (Process._serve_sync).
"""

from __future__ import annotations

import hashlib
import hmac
import struct
from typing import Dict, List

TAG_BYTES = 32
# v2: the MAC'd data grew direction bytes (sender || receiver). The domain
# bump makes the wire incompatibility with v1 binaries explicit and
# greppable — mixed-version frames fail auth either way (rolling upgrades
# must replace the whole committee), but a version tag beats a silent
# net_auth_rejects storm that reads like an attack.
_DOMAIN = b"dagrider-frame-v2"


def _pair_key(master: bytes, i: int, j: int) -> bytes:
    lo, hi = (i, j) if i < j else (j, i)
    return hmac.new(
        master, b"pair" + struct.pack("<II", lo, hi), hashlib.sha256
    ).digest()


class FrameAuth:
    """One node's MAC state: its index plus the key for every peer."""

    def __init__(self, index: int, keys: Dict[int, bytes]):
        self.index = index
        self._keys = dict(keys)

    @staticmethod
    def derive(master: bytes, n: int) -> List["FrameAuth"]:
        """Dealer: one FrameAuth per node from a shared master secret."""
        return [
            FrameAuth(
                i,
                {j: _pair_key(master, i, j) for j in range(n) if j != i},
            )
            for i in range(n)
        ]

    @staticmethod
    def for_node(master: bytes, index: int, n: int) -> "FrameAuth":
        """One node's row (what a deployment config hands each process)."""
        return FrameAuth(
            index,
            {j: _pair_key(master, index, j) for j in range(n) if j != index},
        )

    def tag(self, peer: int, payload: bytes) -> bytes:
        """MAC for a frame this node sends to ``peer``.

        The direction (sender=self, receiver=peer) is bound into the MAC'd
        data so the symmetric pair key cannot be used to reflect a frame
        back at its author or redirect it to a third party.
        """
        return hmac.new(
            self._keys[peer],
            _DOMAIN + struct.pack("<II", self.index, peer) + payload,
            hashlib.sha256,
        ).digest()

    def check(self, claimed_sender: int, payload: bytes, tag: bytes) -> bool:
        """Verify a received frame against the claimed sender's pair key,
        with this node bound as the receiver. Constant-time compare;
        unknown senders fail closed."""
        key = self._keys.get(claimed_sender)
        if key is None or len(tag) != TAG_BYTES:
            return False
        want = hmac.new(
            key,
            _DOMAIN + struct.pack("<II", claimed_sender, self.index) + payload,
            hashlib.sha256,
        ).digest()
        return hmac.compare_digest(want, tag)
