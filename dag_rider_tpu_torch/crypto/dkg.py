"""Joint-Feldman distributed key generation for the threshold-BLS coin.

The port's copy of ``dag_rider_tpu/crypto/dkg.py``.

Replaces :meth:`ThresholdKeys.generate`'s trusted dealer — the exact gap
its docstring names ("a real deployment runs a DKG so nobody ever holds
the group secret", crypto/threshold.py) and the PKI the reference's TODO
asks for ("PKI and a threshold signature scheme with a threshold of
(f+1)-of-n", process/process.go:388). The output is drop-in
:class:`~dag_rider_tpu_torch.crypto.threshold.ThresholdKeys` material: Shamir
x-coordinates are ``index + 1`` and the group public key lives in G2,
matching ``threshold.aggregate`` / ``batch_verify_shares`` unchanged.

Protocol (t-of-n, classic joint-Feldman):

1. **Deal.** Every participant d samples a degree-(t-1) polynomial
   ``f_d`` over Z_r, broadcasts Feldman commitments
   ``C_{d,k} = g2^{a_{d,k}}`` and sends each participant j the share
   ``s_{d,j} = f_d(j+1)`` over a *private* channel (here: XOR-pad +
   HMAC under a pairwise key from ECDH over the committee's Ed25519
   identities — :func:`channel_key` — so the consensus transport's
   plaintext gRPC never sees a share).
2. **Verify / complain.** j checks every received share against the
   dealer's commitments: ``g2^{s_{d,j}} == sum_k (j+1)^k * C_{d,k}``
   (evaluated in the exponent). Failures produce a public complaint.
3. **Reveal / disqualify.** A complained-against dealer must reveal the
   complained share publicly; everyone re-checks it against the
   commitments. Invalid or missing reveals disqualify the dealer.
   (Revealing a genuinely valid share only de-privatizes that one
   share — the standard Feldman trade for a one-round complaint fix.)
4. **Finalize.** With Q the qualified dealer set:
   ``share_sk_j = sum_{d in Q} s_{d,j}``,
   ``share_pk_i = prod_{d in Q} eval_d(i+1)``,
   ``group_pk = prod_{d in Q} C_{d,0}``. The group secret
   ``sum_{d in Q} a_{d,0}`` is never materialized anywhere.

Security model notes: Feldman commitments leak ``g2^{a_{d,0}}`` (fine
for BLS — the group pk is public anyway); bias via adaptive
disqualification (Gennaro et al.) is out of scope for a coin whose only
requirement is unpredictability-before-f+1-shares, which survives any
qualified set containing one honest dealer.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import struct
from typing import Dict, List, Optional, Sequence, Set, Tuple

from dag_rider_tpu_torch.crypto import bls12381 as bls
from dag_rider_tpu_torch.crypto import ed25519 as ed
from dag_rider_tpu_torch.crypto.threshold import ThresholdKeys

_SCALAR_BYTES = 32
_G2_BYTES = 4 * 48  # bls.g2_serialize: x.c1||x.c0||y.c1||y.c0, 48B BE each
_CHAN_DOMAIN = b"dagrider-dkg-chan-v1|"
_PAD_DOMAIN = b"dagrider-dkg-pad-v1|"
_TAG_DOMAIN = b"dagrider-dkg-tag-v1|"
TAG_BYTES = 32


# ---------------------------------------------------------------------------
# G2 wire format (commitments): the key-file format bls12381 already
# defines (g2_serialize — uncompressed, range/curve/subgroup-validated on
# read via the unreduced [r]P == O ladder), with two DKG-specific policy
# differences at the boundary: junk returns None instead of raising
# (Byzantine input is an expected verdict, not an exception), and the
# identity encoding is refused (an identity commitment is either a
# zero-polynomial dealer — a useless no-op contribution — or malformed).
# ---------------------------------------------------------------------------


def g2_encode(p) -> bytes:
    if p is None:
        raise ValueError("cannot encode the identity commitment")
    return bls.g2_serialize(p)


def g2_decode(data: bytes):
    """None on anything malformed: wrong length, out-of-range
    coordinates, off the twist, outside the r-order subgroup (an
    adversarial small-subgroup commitment would corrupt everyone's
    derived share_pks undetectably), or the identity encoding."""
    try:
        p = bls.g2_deserialize(data)
    except ValueError:
        return None
    return p  # g2_deserialize returns None only for the identity


# ---------------------------------------------------------------------------
# Private pairwise channels from the committee's Ed25519 identities
# ---------------------------------------------------------------------------


def channel_key(my_seed: bytes, peer_pk: bytes) -> Optional[bytes]:
    """Symmetric pairwise key: SHA-512(DH point)[:32] with
    DH = [a_i]A_j = [a_i a_j]B over edwards25519 (clamped scalars are
    multiples of 8, so small-subgroup components vanish). k_ij == k_ji
    because scalar multiplication commutes through the shared base."""
    a, _, _ = ed.expand_seed(my_seed)
    pt = ed.point_decompress(peer_pk)
    if pt is None or not ed.on_curve(pt):
        return None
    shared = ed.scalar_mult(a, pt)
    return hashlib.sha512(
        _CHAN_DOMAIN + ed.point_compress(shared)
    ).digest()[:32]


def _share_nonce(dealer: int, recipient: int) -> bytes:
    return dealer.to_bytes(4, "little") + recipient.to_bytes(4, "little")


def encrypt_share(key: bytes, dealer: int, recipient: int, s: int) -> bytes:
    """One-shot XOR-pad + MAC. The (dealer, recipient) pair encrypts
    exactly one scalar per DKG run, so the deterministic nonce never
    repeats under a key; the MAC binds the direction."""
    nonce = _share_nonce(dealer, recipient)
    pad = hashlib.sha512(_PAD_DOMAIN + key + nonce).digest()[:_SCALAR_BYTES]
    ct = bytes(
        a ^ b for a, b in zip(s.to_bytes(_SCALAR_BYTES, "little"), pad)
    )
    tag = hmac.new(key, _TAG_DOMAIN + nonce + ct, hashlib.sha256).digest()
    return ct + tag


def decrypt_share(
    key: bytes, dealer: int, recipient: int, blob: bytes
) -> Optional[int]:
    if len(blob) != _SCALAR_BYTES + TAG_BYTES:
        return None
    ct, tag = blob[:_SCALAR_BYTES], blob[_SCALAR_BYTES:]
    nonce = _share_nonce(dealer, recipient)
    want = hmac.new(key, _TAG_DOMAIN + nonce + ct, hashlib.sha256).digest()
    if not hmac.compare_digest(want, tag):
        return None
    pad = hashlib.sha512(_PAD_DOMAIN + key + nonce).digest()[:_SCALAR_BYTES]
    return int.from_bytes(bytes(a ^ b for a, b in zip(ct, pad)), "little")


# ---------------------------------------------------------------------------
# The per-participant state machine (transport-agnostic)
# ---------------------------------------------------------------------------


def _eval_commitments(commits: Sequence, x: int):
    """prod_k [x^k] C_k — the dealer's polynomial at x, in the exponent."""
    xs = 1
    scalars = []
    for _ in commits:
        scalars.append(xs)
        xs = xs * x % bls.R
    return bls.g2_msm(scalars, list(commits))


class DkgSession:
    """One participant's joint-Feldman run.

    Drive it: broadcast :meth:`commitment_blob`, send each j its
    :meth:`share_blob_for`; feed peers' traffic to :meth:`on_commitments`
    / :meth:`on_share`; after the dealing round, broadcast
    :meth:`complaints`; answer complaints against yourself with
    :meth:`reveal_blob`; feed reveals to :meth:`on_reveal`; then
    :meth:`finalize`. Message authenticity (who sent what) is the
    transport's job — gRPC deployments wrap frames in FrameAuth exactly
    like consensus traffic; share *confidentiality* is handled here.
    """

    def __init__(
        self,
        index: int,
        n: int,
        threshold: int,
        identity_seed: bytes,
        identity_pks: Sequence[bytes],
        *,
        rng: Optional[bytes] = None,
    ):
        if not 1 <= threshold <= n:
            raise ValueError("need 1 <= threshold <= n")
        if len(identity_pks) != n:
            raise ValueError("need one identity pk per participant")
        self.index = index
        self.n = n
        self.t = threshold
        self._seed = identity_seed
        self._ids = list(identity_pks)
        # Polynomial coefficients: rng is for tests only; deployments use
        # os.urandom. (The coefficients themselves necessarily live for
        # the whole session — reveal_blob re-evaluates the polynomial —
        # so there is no secret-scrubbing story here beyond process
        # lifetime.)
        material = rng if rng is not None else os.urandom(64)
        self._coeffs = [
            int.from_bytes(
                hashlib.sha512(
                    b"dkg-coeff|" + material + k.to_bytes(4, "little")
                ).digest(),
                "little",
            )
            % bls.R
            for k in range(threshold)
        ]
        self.commits = [bls.pk_of(a) for a in self._coeffs]
        #: dealer -> validated commitment vector
        self.peer_commits: Dict[int, List] = {self.index: self.commits}
        #: dealer -> decrypted share for me
        self.shares: Dict[int, int] = {
            self.index: self._poly_at(self.index + 1)
        }
        #: dealers I complained about (bad/missing/undecryptable share)
        self._my_complaints: Set[int] = set()
        #: (dealer, complainer) pairs still awaiting a valid reveal
        self._open_complaints: Set[Tuple[int, int]] = set()
        #: frames that outraced their dealer's commitments, stashed
        #: judgement-free until on_commitments replays them
        self._pending_shares: Dict[int, int] = {}
        self._pending_reveals: Dict[Tuple[int, int], bytes] = {}
        self.disqualified: Set[int] = set()

    # -- dealing ----------------------------------------------------------

    def _poly_at(self, x: int) -> int:
        acc = 0
        for c in reversed(self._coeffs):
            acc = (acc * x + c) % bls.R
        return acc

    def commitment_blob(self) -> bytes:
        return b"".join(g2_encode(c) for c in self.commits)

    def share_blob_for(self, j: int) -> Optional[bytes]:
        """Encrypted share for participant j (None if j's identity key is
        malformed — j will complain and this dealer must reveal)."""
        if j == self.index:
            return None
        key = channel_key(self._seed, self._ids[j])
        if key is None:
            return None
        return encrypt_share(key, self.index, j, self._poly_at(j + 1))

    # -- receiving --------------------------------------------------------

    def on_commitments(self, dealer: int, blob: bytes) -> bool:
        """Validate + store dealer's commitment vector. Malformed vectors
        disqualify immediately (commitments are broadcast, so everyone
        reaches the same verdict). Shares/reveals that arrived BEFORE the
        commitments (separate frames race over a real network) were
        stashed judgement-free and are re-judged now."""
        if dealer == self.index or dealer in self.peer_commits:
            return dealer in self.peer_commits
        if len(blob) != self.t * _G2_BYTES:
            self.disqualified.add(dealer)
            return False
        commits = []
        for k in range(self.t):
            p = g2_decode(blob[k * _G2_BYTES : (k + 1) * _G2_BYTES])
            if p is None:
                self.disqualified.add(dealer)
                return False
            commits.append(p)
        self.peer_commits[dealer] = commits
        s = self._pending_shares.pop(dealer, None)
        if s is not None and dealer not in self.shares:
            if self._share_ok(dealer, self.index + 1, s):
                self.shares[dealer] = s
                self._my_complaints.discard(dealer)
            else:
                self._my_complaints.add(dealer)
        for (d, complainer), blob_r in list(self._pending_reveals.items()):
            if d == dealer:
                del self._pending_reveals[(d, complainer)]
                self.on_reveal(d, complainer, blob_r)
        return True

    def _share_ok(self, dealer: int, x: int, s: int) -> bool:
        commits = self.peer_commits.get(dealer)
        if commits is None:
            return False
        return bls.pk_of(s) == _eval_commitments(commits, x)

    def on_share(self, dealer: int, blob: bytes) -> bool:
        """Decrypt + verify my share from dealer against its commitments.

        A share whose dealer's commitments have not arrived yet cannot
        be judged: it is stashed (no complaint, no verdict) and re-judged
        when the commitments land — the two frames race over a real
        network, and misjudging the ordering as dealer fault would force
        a needless public reveal (or, before a fix, a divergent
        disqualification)."""
        if dealer == self.index or dealer in self.shares:
            return dealer in self.shares
        key = channel_key(self._seed, self._ids[dealer])
        s = (
            decrypt_share(key, dealer, self.index, blob)
            if key is not None
            else None
        )
        if s is None:
            self._my_complaints.add(dealer)
            return False
        if dealer not in self.peer_commits:
            self._pending_shares[dealer] = s
            return False
        if not self._share_ok(dealer, self.index + 1, s):
            self._my_complaints.add(dealer)
            return False
        self.shares[dealer] = s
        # A share can verify on a retransmit after an earlier failure
        # (e.g. commitments arrived late): clear the provisional
        # complaint, or the dealer would be forced into a needless
        # public reveal of this node's share.
        self._my_complaints.discard(dealer)
        return True

    # -- complaints -------------------------------------------------------

    def complaints(self) -> List[int]:
        """Dealers to publicly complain about: bad shares seen so far plus
        dealers whose share (or commitments) never arrived. Call once the
        dealing round is over (caller-level timeout)."""
        missing = {
            d
            for d in range(self.n)
            if d != self.index
            and (d not in self.shares or d not in self.peer_commits)
        }
        self._my_complaints |= missing
        return sorted(self._my_complaints)

    def on_complaint(self, complainer: int, dealer: int) -> None:
        if complainer == dealer or not 0 <= dealer < self.n:
            return
        if dealer in self.disqualified:
            return
        self._open_complaints.add((dealer, complainer))

    def reveal_blob(self, complainer: int) -> bytes:
        """Public reveal of complainer's share (this dealer answering a
        complaint against itself)."""
        return self._poly_at(complainer + 1).to_bytes(
            _SCALAR_BYTES, "little"
        )

    def on_reveal(self, dealer: int, complainer: int, blob: bytes) -> None:
        """A revealed share settles the complaint: valid -> complaint
        cleared (and the complainer adopts it as its share if it was the
        one complaining); invalid -> dealer disqualified. A reveal that
        outraces the dealer's commitments is stashed judgement-free and
        replayed by on_commitments."""
        if (dealer, complainer) not in self._open_complaints:
            return
        if len(blob) != _SCALAR_BYTES:
            self.disqualified.add(dealer)
            return
        if dealer not in self.peer_commits:
            self._pending_reveals[(dealer, complainer)] = bytes(blob)
            return
        s = int.from_bytes(blob, "little")
        if self._share_ok(dealer, complainer + 1, s):
            self._open_complaints.discard((dealer, complainer))
            if complainer == self.index and dealer not in self.shares:
                self.shares[dealer] = s
                self._my_complaints.discard(dealer)
        else:
            self.disqualified.add(dealer)

    # -- output -----------------------------------------------------------

    def finalize(self) -> "DkgResult":
        """Close the run: unanswered complaints disqualify, and the
        qualified dealers' contributions combine into ThresholdKeys-shaped
        output (share_sks holds only MY share; the rest are None)."""
        for dealer, _ in list(self._open_complaints):
            self.disqualified.add(dealer)
        qualified = sorted(
            d
            for d in self.peer_commits
            if d not in self.disqualified
            and (d == self.index or d in self.shares)
        )
        if len(qualified) < self.t:
            raise RuntimeError(
                f"DKG failed: only {len(qualified)} qualified dealers "
                f"(< threshold {self.t})"
            )
        share_sk = sum(self.shares[d] for d in qualified) % bls.R
        # Commitments are homomorphic in the coefficients: summing the
        # qualified vectors coefficient-wise once, then evaluating the
        # combined polynomial per participant, replaces n*|Q| t-term
        # MSMs with |Q|*t adds + n MSMs (identical output, ~|Q|x less
        # work at committee scale).
        combined = [None] * self.t
        for d in qualified:
            for k, c in enumerate(self.peer_commits[d]):
                combined[k] = bls.g2_add(combined[k], c)
        group_pk = combined[0]
        share_pks = [
            _eval_commitments(combined, i + 1) for i in range(self.n)
        ]
        return DkgResult(
            index=self.index,
            threshold=self.t,
            qualified=tuple(qualified),
            share_sk=share_sk,
            share_pks=tuple(share_pks),
            group_pk=group_pk,
        )


class DkgResult:
    """One participant's DKG output, adaptable to ThresholdKeys."""

    def __init__(self, index, threshold, qualified, share_sk, share_pks, group_pk):
        self.index = index
        self.threshold = threshold
        self.qualified = qualified
        self.share_sk = share_sk
        self.share_pks = share_pks
        self.group_pk = group_pk

    def to_keys(self) -> ThresholdKeys:
        """ThresholdKeys view for the existing coin machinery: share_sks
        carries only this participant's secret (None elsewhere) — exactly
        the dealerless property."""
        sks: List[Optional[int]] = [None] * len(self.share_pks)
        sks[self.index] = self.share_sk
        return ThresholdKeys(
            self.threshold, self.group_pk, self.share_pks, sks
        )


# ---------------------------------------------------------------------------
# In-process runner (the message flow, honestly executed — the gRPC
# runner in node.py routes these same blobs over the network)
# ---------------------------------------------------------------------------


def run_dkg(
    n: int,
    threshold: int,
    identity_seeds: Sequence[bytes],
    *,
    byzantine: Optional[Dict[int, str]] = None,
) -> List[DkgResult]:
    """Full joint-Feldman round among n in-process participants.

    ``byzantine`` maps dealer index -> fault: "bad_share" (corrupt every
    outgoing share; the reveal is also bad, so disqualification follows),
    "silent" (deal nothing). Returns each honest participant's result;
    Byzantine participants get no result (None placeholders are skipped).
    """
    byzantine = byzantine or {}
    pks = [ed.generate_keypair(s)[1] for s in identity_seeds]
    sessions = [
        DkgSession(i, n, threshold, identity_seeds[i], pks)
        for i in range(n)
    ]
    # deal: broadcast commitments, direct-send shares
    for d, sess in enumerate(sessions):
        fault = byzantine.get(d)
        if fault == "silent":
            continue
        cblob = sess.commitment_blob()
        for j, other in enumerate(sessions):
            if j == d:
                continue
            other.on_commitments(d, cblob)
        for j, other in enumerate(sessions):
            if j == d:
                continue
            blob = sess.share_blob_for(j)
            if fault == "bad_share":
                blob = bytes(len(blob))  # MAC fails -> undecryptable
            other.on_share(d, blob)
    # complain: broadcast
    all_complaints = {i: sess.complaints() for i, sess in enumerate(sessions)}
    for complainer, dealers in all_complaints.items():
        for dealer in dealers:
            for sess in sessions:
                sess.on_complaint(complainer, dealer)
    # reveal: each complained-against dealer answers publicly
    for complainer, dealers in all_complaints.items():
        for dealer in dealers:
            fault = byzantine.get(dealer)
            if fault == "silent":
                continue  # no reveal -> finalize() disqualifies
            blob = sessions[dealer].reveal_blob(complainer)
            if fault == "bad_share":
                blob = bytes(_SCALAR_BYTES)
            for sess in sessions:
                sess.on_reveal(dealer, complainer, blob)
    return [
        sessions[i].finalize() for i in range(n) if i not in byzantine
    ]


# ---------------------------------------------------------------------------
# Epoch resharing entry
# ---------------------------------------------------------------------------


def run_resharing(
    n: int,
    threshold: int,
    epoch_seed: bytes,
    *,
    byzantine: Optional[Dict[int, str]] = None,
) -> List[DkgResult]:
    """Joint-Feldman resharing for an epoch boundary: every input —
    identity seeds AND each dealer's polynomial material — is derived
    from ``epoch_seed``, so any two processes that committed the same
    reconfiguration transcript run byte-identical protocol flows and
    finalize the same group key. This is what lets the in-process epoch
    manager rotate keys without a wire round-trip: the "randomness" is
    the committed transcript digest, which the adversary cannot bias
    after the fact any more than it can bias the ordered log itself
    (the networked deployment path swaps in per-node ``os.urandom``
    material over :func:`run_dkg_networked` unchanged).
    """
    byzantine = byzantine or {}
    identity_seeds = [
        hashlib.sha512(
            b"dkg-reshare-id|" + epoch_seed + i.to_bytes(4, "little")
        ).digest()[:32]
        for i in range(n)
    ]
    pks = [ed.generate_keypair(s)[1] for s in identity_seeds]
    sessions = [
        DkgSession(
            i,
            n,
            threshold,
            identity_seeds[i],
            pks,
            rng=hashlib.sha512(
                b"dkg-reshare-coeff|" + epoch_seed + i.to_bytes(4, "little")
            ).digest(),
        )
        for i in range(n)
    ]
    for d, sess in enumerate(sessions):
        fault = byzantine.get(d)
        if fault == "silent":
            continue
        cblob = sess.commitment_blob()
        for j, other in enumerate(sessions):
            if j == d:
                continue
            other.on_commitments(d, cblob)
        for j, other in enumerate(sessions):
            if j == d:
                continue
            blob = sess.share_blob_for(j)
            if fault == "bad_share":
                blob = bytes(len(blob))
            other.on_share(d, blob)
    all_complaints = {i: sess.complaints() for i, sess in enumerate(sessions)}
    for complainer, dealers in all_complaints.items():
        for dealer in dealers:
            for sess in sessions:
                sess.on_complaint(complainer, dealer)
    for complainer, dealers in all_complaints.items():
        for dealer in dealers:
            fault = byzantine.get(dealer)
            if fault == "silent":
                continue
            blob = sessions[dealer].reveal_blob(complainer)
            if fault == "bad_share":
                blob = bytes(_SCALAR_BYTES)
            for sess in sessions:
                sess.on_reveal(dealer, complainer, blob)
    return [
        sessions[i].finalize() for i in range(n) if i not in byzantine
    ]


# ---------------------------------------------------------------------------
# Networked runner (gRPC BlobBus — the deployment path)
# ---------------------------------------------------------------------------


def run_dkg_networked(
    bus,
    n: int,
    threshold: int,
    identity_seed: bytes,
    identity_pks: Sequence[bytes],
    *,
    phase_timeout_s: float = 15.0,
    poll_s: float = 0.05,
) -> "DkgResult":
    """One participant's joint-Feldman run over a
    :class:`~dag_rider_tpu_torch.transport.blobbus.BlobBus` (or anything with
    its send/broadcast/recv surface).

    Four timed phases — deal, complain, reveal, confirm — each barriered
    on either hearing from every peer or the phase timeout, so silent or
    partitioned dealers cost one timeout, not a deadlock, and end up
    disqualified exactly as in the in-process runner. Retransmits the
    deal once mid-phase to ride out one-shot send failures (the bus has
    no retry of its own).

    The CONFIRM phase makes key divergence a detected abort, not a
    silent fork: timeout-based views can legitimately differ (a dealer
    that crashed after reaching half the committee is qualified on one
    side, complained-about on the other), so every participant
    broadcasts a digest of its (qualified, group_pk, share_pks) and
    requires every peer's digest to match — any mismatch or missing
    confirmation raises, and the operators rerun the ceremony. A
    Byzantine participant can therefore abort the run (deny the
    ceremony) but never split it into two working committees with
    different group keys."""
    import time as _t

    me = bus.index
    sess = DkgSession(me, n, threshold, identity_seed, identity_pks)
    others = [j for j in range(n) if j != me]

    def _deal() -> None:
        bus.broadcast("dkg_commit", sess.commitment_blob())
        for j in others:
            blob = sess.share_blob_for(j)
            if blob is not None:
                bus.send(j, "dkg_share", blob)

    complaints_from: Dict[int, List[int]] = {}
    confirms: Dict[int, bytes] = {}

    def _pump() -> None:
        for sender, kind, payload in bus.recv():
            if not 0 <= sender < n or sender == me:
                continue
            if kind == "dkg_commit":
                sess.on_commitments(sender, payload)
            elif kind == "dkg_share":
                sess.on_share(sender, payload)
            elif kind == "dkg_confirm":
                confirms.setdefault(sender, payload)
            elif kind == "dkg_complaint":
                dealers = [
                    d
                    for d in payload
                    if d < n  # one byte per dealer index (n <= 255 here)
                ]
                complaints_from[sender] = dealers
                for d in dealers:
                    sess.on_complaint(sender, d)
            elif kind == "dkg_reveal":
                if len(payload) >= 4:
                    (complainer,) = struct.unpack_from("<I", payload)
                    sess.on_reveal(sender, complainer, payload[4:])

    def _phase(done, timeout: float, *, mid=None) -> None:
        deadline = _t.monotonic() + timeout
        fired_mid = False
        while _t.monotonic() < deadline:
            _pump()
            if done():
                return
            if mid is not None and not fired_mid and (
                deadline - _t.monotonic() < timeout / 2
            ):
                fired_mid = True
                mid()
            bus.wait(poll_s)
        _pump()

    if n > 255:
        raise ValueError("networked DKG complaint frame packs byte indices")
    # phase 1: deal, and hear everyone's deal
    _deal()
    _phase(
        lambda: all(
            d in sess.peer_commits and d in sess.shares for d in others
        ),
        phase_timeout_s,
        mid=_deal,  # one retransmit halfway through the window
    )
    # phase 2: broadcast complaints (always — peers barrier on hearing
    # from everyone), hear everyone's. The broadcast must ALSO be fed to
    # our own session: _pump filters sender == me, and on_reveal only
    # accepts reveals for complaints registered via on_complaint — a
    # complainer that skipped self-registration would reject the very
    # reveal it waited for (one false complaint aborted
    # every networked ceremony while the in-process runner — which
    # delivers to all sessions including the sender's — passed).
    my_complaints = sess.complaints()
    for d in my_complaints:
        sess.on_complaint(me, d)
    bus.broadcast("dkg_complaint", bytes(my_complaints))
    _phase(
        lambda: all(j in complaints_from for j in others),
        phase_timeout_s,
    )

    # phase 3: answer complaints against me; wait until every open
    # complaint against OTHER dealers is settled (valid reveal clears
    # the entry; invalid reveal marks the dealer disqualified) or the
    # window closes. Driven off the session's own _open_complaints —
    # the authoritative set — not a complaints_from snapshot, which a
    # duplicate/forged complaint frame can overwrite racily.
    def _reveal(complainer: int) -> None:
        # the complaint may be about MISSING commitments (the complainer
        # started late and lost the deal broadcast): re-broadcast them
        # first so the reveal that follows can actually be judged
        bus.broadcast("dkg_commit", sess.commitment_blob())
        blob = sess.reveal_blob(complainer)
        bus.broadcast(
            "dkg_reveal", struct.pack("<I", complainer) + blob
        )
        # self-feed, or our own open (me, complainer) entry would
        # never clear and finalize() would self-disqualify us
        sess.on_reveal(me, complainer, blob)

    for dealer, complainer in list(sess._open_complaints):
        if dealer == me:
            _reveal(complainer)

    def _reveals_settled() -> bool:
        return all(
            d in sess.disqualified
            for d, _ in sess._open_complaints
            if d != me
        )

    _phase(_reveals_settled, phase_timeout_s)
    # answer complaints that arrived during phase 3 before closing (a
    # residual race here means divergent views — caught by CONFIRM)
    for dealer, complainer in list(sess._open_complaints):
        if dealer == me:
            _reveal(complainer)
    result = sess.finalize()
    # phase 4: confirm — everyone must have derived the same key set
    digest = hashlib.sha256(
        b"dkg-confirm|"
        + bytes(result.qualified)
        # g2_serialize, not g2_encode: the digest must never raise, and
        # it encodes a (negligible-probability) identity as zeros
        + bls.g2_serialize(result.group_pk)
        + b"".join(bls.g2_serialize(pk) for pk in result.share_pks)
    ).digest()
    bus.broadcast("dkg_confirm", digest)
    _phase(lambda: all(j in confirms for j in others), phase_timeout_s)
    bad = [
        j
        for j in others
        if confirms.get(j) != digest
    ]
    if bad:
        raise RuntimeError(
            "DKG confirmation failed: participants "
            f"{bad} missing or diverged — rerun the ceremony"
        )
    return result
