"""Vertex / block data model.

The port's copy of ``dag_rider_tpu/core/types.py``.

Counterpart of the reference's data model
(``process/process.go:14-31``): a vertex is identified by ``(round, source)``,
carries a client block payload, strong edges to round-1 vertices and weak
edges to vertices in rounds < round-1.

Differences from the reference, by design:

- Sources are 0-based ints in [0, n).
- Vertices are immutable (frozen dataclasses) and carry an optional Ed25519
  signature + threshold-coin share — the reference has no authentication at
  all (SURVEY.md D10) and a stubbed coin (D9).
- A canonical byte encoding (``signing_bytes``) exists so vertices can be
  signed/verified and checkpointed; the reference has no serialization
  (SURVEY.md §5 "checkpoint/resume: absent").
"""

from __future__ import annotations

import dataclasses
import hashlib
import struct
from typing import NamedTuple, Optional, Tuple


class VertexID(NamedTuple):
    """Unique vertex identity: (round, source).

    Mirrors ``vertexID`` (reference ``process/process.go:19-24``). A correct
    process creates at most one vertex per round, so this pair is unique.
    Ordered lexicographically (round first) — this ordering is the
    deterministic tiebreak used by total-order delivery.

    A NamedTuple, not a frozen dataclass: ids are constructed and hashed
    millions of times per consensus run (proposal frontiers alone build
    n ids per proposal × n processes), and tuple __new__/__hash__ run in
    C — the frozen-dataclass version's __init__ + precomputed-hash dance
    was ~3 us per id and the single hottest allocation site of the
    n=256 host profile.

    Being a NamedTuple, a VertexID hashes and compares equal to the bare
    tuple ``(round, source)`` — INTENTIONAL: hot paths
    may probe dicts/sets keyed by VertexID with plain tuples (skipping
    even the NamedTuple constructor) and membership answers must agree.
    Do not "fix" this by overriding __eq__/__hash__; code must not rely
    on the two being distinguishable.
    """

    round: int
    source: int

    def encode(self) -> bytes:
        return struct.pack("<II", self.round, self.source)


@dataclasses.dataclass(frozen=True)
class Block:
    """A client payload block (reference ``process/process.go:14-17``).

    The reference's block is an empty struct; ours carries real transaction
    bytes so end-to-end delivery is observable.
    """

    transactions: Tuple[bytes, ...] = ()

    def encode(self) -> bytes:
        out = [struct.pack("<I", len(self.transactions))]
        for tx in self.transactions:
            out.append(struct.pack("<I", len(tx)))
            out.append(tx)
        return b"".join(out)

    @staticmethod
    def decode(data: bytes, offset: int = 0) -> Tuple["Block", int]:
        (count,) = struct.unpack_from("<I", data, offset)
        offset += 4
        txs = []
        for _ in range(count):
            (ln,) = struct.unpack_from("<I", data, offset)
            offset += 4
            txs.append(data[offset : offset + ln])
            offset += ln
        return Block(tuple(txs)), offset


@dataclasses.dataclass(frozen=True)
class LaneRef:
    """A certified lane-batch reference.

    Stands in for a payload :class:`Block` on the consensus path when
    dissemination lanes are on: ``digest`` is the sha256 of the encoded
    payload block, ``signers`` the 2f+1 sources whose availability acks
    back the batch (sorted), and ``agg_sig`` the compressed G1 sum of
    their domain-separated BLS ack shares (empty in unsigned
    deployments — the keyless simulator). ``count``/``nbytes`` restate
    the payload shape so admission and accounting never need the bytes.

    The ref rides the existing wire unchanged, as the single
    magic-prefixed pseudo-transaction of a Block (see
    :func:`dag_rider_tpu_torch.core.codec.encode_lane_ref`) — vertex identity,
    signing, and the cert path all see an ordinary small block.
    """

    producer: int
    seq: int
    digest: bytes
    count: int
    nbytes: int
    signers: Tuple[int, ...] = ()
    agg_sig: bytes = b""


@dataclasses.dataclass(frozen=True)
class EpochOp:
    """One reconfiguration request, ordered through consensus
    as the magic-prefixed pseudo-transaction of an ordinary block (see
    :func:`dag_rider_tpu_torch.core.codec.encode_epoch_op`).

    ``kind`` is "join" | "leave" | "rotate"; ``target`` the node index
    joining or leaving (0 for a pure key rotation); ``nonce`` a
    submitter-chosen tag so identical requests stay distinguishable in
    the ordered log; ``payload`` carries opaque operator material (e.g.
    a joiner's identity seed), folded into the epoch seed derivation so
    rotated keys commit to it.
    """

    kind: str
    target: int = 0
    nonce: int = 0
    payload: bytes = b""


@dataclasses.dataclass(frozen=True)
class Vertex:
    """A DAG vertex (reference ``process/process.go:26-31``).

    strong_edges point to round-1 vertices (>= 2f+1 of them for a valid
    vertex); weak_edges point to otherwise-unreachable vertices in rounds
    < round-1, providing the fairness/inclusion guarantee (Alg. 2 lines
    29-31, quoted at reference ``process.go:300-302``).
    """

    id: VertexID
    block: Block = Block()
    strong_edges: Tuple[VertexID, ...] = ()
    weak_edges: Tuple[VertexID, ...] = ()
    signature: Optional[bytes] = None
    coin_share: Optional[bytes] = None
    #: BLS signature over digest() for the aggregated round-certificate
    #: path. Like ``signature``, an attestation OF the content
    #: — excluded from signing_bytes/digest (both enumerate fields
    #: explicitly), so attaching it never perturbs the vertex identity
    #: the per-vertex oracle path verifies.
    cert_sig: Optional[bytes] = None

    @property
    def round(self) -> int:
        return self.id.round

    @property
    def source(self) -> int:
        return self.id.source

    def signing_bytes(self) -> bytes:
        """Canonical encoding of everything a source attests to.

        Excludes the signature itself. Edges are sorted so the encoding is
        independent of construction order. Memoized: the encoding of an
        immutable vertex is hit once per verify *and* once per digest, and
        re-serializing ~2f+1 edges dominated the verifier's host prep at
        n=256.
        """
        cached = self.__dict__.get("_signing_bytes")
        if cached is not None:
            return cached
        out = [b"dagrider-vertex-v1", self.id.encode(), self.block.encode()]
        for label, edges in ((b"S", self.strong_edges), (b"W", self.weak_edges)):
            out.append(label)
            out.append(struct.pack("<I", len(edges)))
            # VertexID is a NamedTuple: plain tuple comparison IS the
            # canonical (round, source) order, and it sorts in C
            for e in sorted(edges):
                out.append(e.encode())
        out.append(b"C")
        share = self.coin_share or b""
        out.append(struct.pack("<I", len(share)))
        out.append(share)
        enc = b"".join(out)
        object.__setattr__(self, "_signing_bytes", enc)
        return enc

    def digest(self) -> bytes:
        """SHA-512 digest of the canonical encoding (what gets signed).
        Memoized alongside :meth:`signing_bytes`."""
        cached = self.__dict__.get("_digest")
        if cached is not None:
            return cached
        d = hashlib.sha512(self.signing_bytes()).digest()
        object.__setattr__(self, "_digest", d)
        return d

    def edge_arrays(self):
        """Edges as four int32 numpy arrays
        ``(strong_rounds, strong_sources, weak_rounds, weak_sources)``.

        Memoized: admission gates and dense-mirror inserts check every
        edge of every vertex; per-edge attribute access over ~2f+1
        VertexIDs was the hottest slice of the 64-node host profile, and
        one fancy-index over these arrays replaces it."""
        cached = self.__dict__.get("_edge_arrays")
        if cached is not None:
            return cached
        import numpy as np

        # int64: wire rounds/sources are u32, which OVERFLOWS int32 —
        # a crafted vertex with round >= 2^31 must reach the admission
        # gate's range checks as a value, not as an OverflowError on the
        # network path (found by the snapshot corruption fuzz). The gate
        # bounds everything to [0, n) x [0, vr) before any index use.
        se, we = self.strong_edges, self.weak_edges
        arrs = (
            np.fromiter((e.round for e in se), np.int64, len(se)),
            np.fromiter((e.source for e in se), np.int64, len(se)),
            np.fromiter((e.round for e in we), np.int64, len(we)),
            np.fromiter((e.source for e in we), np.int64, len(we)),
        )
        object.__setattr__(self, "_edge_arrays", arrs)
        return arrs


@dataclasses.dataclass(frozen=True)
class RoundCertificate:
    """One aggregated attestation for a whole DAG round.

    Assembled by the round's designated aggregator once it has directly
    verified a quorum of the round's vertices: ``signers`` lists the
    source indices covered (sorted, >= 2f+1 of them), ``digests`` the
    matching vertex digests (parallel to ``signers``), and ``agg_sig``
    the compressed G1 sum of the per-vertex BLS ``cert_sig`` values.
    A receiver checks the whole round with ONE aggregate pairing —
    e(agg, -G2) * prod e(H(digest_i), pk_i) == 1 — instead of one
    ed25519 verify per vertex.
    """

    round: int
    signers: Tuple[int, ...]
    digests: Tuple[bytes, ...]
    agg_sig: bytes

    def signing_key(self) -> tuple:
        """Hashable identity of what the certificate claims — the memo
        key for sharing one verification verdict across an in-process
        cluster (the registry identity is added by the verifier)."""
        return (self.round, self.signers, self.digests, self.agg_sig)


@dataclasses.dataclass(frozen=True)
class SpanCertificate:
    """A cert-of-certs covering ``k`` consecutive round certificates
   .

    ``signers[i]`` / ``digests[i]`` restate what the round
    ``first_round + i`` certificate claimed, and ``agg_sig`` is the
    compressed G1 sum of those rounds' certificate aggregates — so ONE
    combined multi-pairing proves every (digest, pk) pair across the
    span was signed, and a catch-up consumer pays 1/k of the per-round
    pairing count. Deliberately slim: no embedded per-round signatures
    (they would be unverified claims a receiver could only trust by
    re-doing the per-round work the span exists to avoid).

    Spans are an overlay on the certificate path, never a liveness
    dependency: round certificates keep flowing per-round, and a
    receiver that already settled a covered round just ignores the span
    for that round.
    """

    first_round: int
    signers: Tuple[Tuple[int, ...], ...]
    digests: Tuple[Tuple[bytes, ...], ...]
    agg_sig: bytes

    @property
    def last_round(self) -> int:
        return self.first_round + len(self.signers) - 1

    def signing_key(self) -> tuple:
        """Hashable identity of the span's combined claim — the memo key
        for the COMBINED verdict only (a passing span check does not
        imply each component round certificate is individually valid,
        so per-round verdicts are never derived from it)."""
        return ("span", self.first_round, self.signers, self.digests,
                self.agg_sig)


@dataclasses.dataclass(frozen=True)
class BroadcastMessage:
    """The unit the Transport carries (reference ``bcastMsg``,
    ``process/transport.go:11-18``): a vertex plus the round/sender stamps.

    The reference *trusts* these stamps (D10, ``process.go:159-162``); here
    they are cross-checked against the signed vertex id on receipt.

    ``kind`` extends the wire beyond the reference's single message type:
    "val" is a vertex payload (the only kind a Process consumes); "echo" /
    "ready" / "fetch" are the Bracha reliable-broadcast control messages of
    :mod:`dag_rider_tpu_torch.transport.rbc`, which carry ``origin`` (the source
    index of the vertex being amplified) and ``digest`` instead of a
    payload.
    """

    vertex: Optional[Vertex]
    round: int
    sender: int
    kind: str = "val"
    origin: Optional[int] = None
    digest: Optional[bytes] = None
    #: aggregated round certificate, only for kind == "cert"
    cert: Optional[RoundCertificate] = None
    #: cert-of-certs, only for kind == "cert_span"
    span: Optional[SpanCertificate] = None
    #: reconfiguration epoch the sender was in. 0 is the
    #: genesis epoch and the only value static-membership deployments
    #: ever see; the codec emits the epoch wire section only when > 0,
    #: so pre-epoch bytes decode unchanged.
    epoch: int = 0
