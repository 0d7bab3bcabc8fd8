"""Aggregated round-certificate verification.

The port's copy of the round-certificate half of
``dag_rider_tpu/verifier/cert.py``. The round's designated aggregator sums
the quorum's per-vertex BLS signatures into one 48-byte G1 point (through
the MSM seam: the card with ``msm="device"``, the mesh with
``msm="sharded"`` (``parallel/msm.py``), the host group law with
``msm="host"``), and every receiver checks the whole round with ONE
aggregate pairing

    e(agg, -G2) * prod_i e(H(digest_i), pk_i) == 1

through the pairing seam: ``pair="device"`` (the default) runs the Miller
product on the card (:mod:`ops.bls_pairing`) and the final exponentiation
on the host; ``pair="host"`` runs
:func:`crypto.bls12381.multi_pairing_check` (precomputed per-key Miller
lines, shared squarings, one final exponentiation), the oracle. The
verdicts are the same. Consecutive round certificates fold into a span
certificate (cert-of-certs), checked with one combined product.

Soundness note: per-producer signatures over DISTINCT messages (each
process signs its own vertex digest) are what make the aggregate binding —
any common-message scheme would let the aggregator attribute vertices to
processes that never signed them.

Verdicts are memoized by certificate content: in an in-process cluster the
aggregator's own pre-gossip self-check makes every receiver's verdict a
dict hit, so the cluster pays each aggregate pairing once.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

from dag_rider_tpu_torch import config
from dag_rider_tpu_torch.core.types import RoundCertificate, SpanCertificate
from dag_rider_tpu_torch.crypto import bls12381 as bls
from dag_rider_tpu_torch.ops import bls_msm, bls_pairing
from dag_rider_tpu_torch.verifier.base import KeyRegistry

#: memoized verdicts kept per verifier (bounded like the crypto-layer
#: precompute caches)
_VERDICT_CACHE_MAX = 4096


def _resolve_msm(msm: Optional[str]) -> str:
    """The certificate MSM backend: ``msm``, else DAGRIDER_CERT_MSM when
    the environment sets it, else "device" (the port's default; the
    registry's "host" default is the reference's)."""
    if msm is None:
        in_env = config.env_is_set("DAGRIDER_CERT_MSM")
        msm = config.env_choice("DAGRIDER_CERT_MSM") if in_env else "device"
    if msm not in ("host", "device", "sharded"):
        raise ValueError(
            f'cert MSM must be "host", "device" or "sharded", got {msm!r}'
        )
    return msm


def _resolve_pair(pair: Optional[str]) -> str:
    """The aggregate-pairing backend: ``pair``, else DAGRIDER_CERT_PAIR
    when the environment sets it, else "device" (the port's default, as
    for the MSM; the registry's "host" default is the reference's)."""
    if pair is None:
        in_env = config.env_is_set("DAGRIDER_CERT_PAIR")
        pair = config.env_choice("DAGRIDER_CERT_PAIR") if in_env else "device"
    if pair not in ("host", "device"):
        raise ValueError(f'cert pairing must be "host" or "device", got {pair!r}')
    return pair


class CertVerifier:
    """Validates :class:`RoundCertificate`\\ s against a key registry and
    aggregates signature shares for the assembling side.

    Args:
        registry: the cluster PKI; must carry ``bls_public_keys``.
        quorum: minimum signer count a certificate must cover (2f+1).
        msm: "device" (the G1 MSM of ``ops.bls_msm``), "sharded"
            (``parallel.msm.ShardedMSM`` over every card, or 8 CPU entries
            when ``device`` is "cpu") or "host" (the group law, the oracle,
            only when asked for); bit-identical aggregates. None reads
            DAGRIDER_CERT_MSM when it is set and is "device" otherwise.
        device: where a "device" or "sharded" MSM and a "device" pairing
            run: ``cuda`` unless the caller passes ``"cpu"`` (the plain
            torch path).
            Raises at construction when CUDA is asked for and there is no
            card.
        pair: "device" (the Miller product on ``device``, the final
            exponentiation on the host) or "host" (the host multi-pairing,
            the oracle); None reads DAGRIDER_CERT_PAIR when it is set and
            is "device" otherwise. The same verdicts.
    """

    def __init__(
        self,
        registry: KeyRegistry,
        quorum: int,
        msm: Optional[str] = None,
        device=None,
        pair: Optional[str] = None,
    ) -> None:
        if not registry.bls_public_keys:
            raise ValueError(
                "CertVerifier needs a registry with BLS certificate keys "
                "(KeyRegistry.generate_with_cert)"
            )
        msm = _resolve_msm(msm)
        self.pair = _resolve_pair(pair)
        self.registry = registry
        self.quorum = int(quorum)
        self.msm = msm
        on_device = msm != "host" or self.pair == "device"
        self.device = bls_msm.resolve_device(device) if on_device else None
        self._sharded = None  # the ShardedMSM of msm="sharded", built at first use
        self._verdicts: dict = {}
        #: Optional callback fired once per certificate, on its FIRST
        #: successful verification (memo hits stay silent — the event
        #: already fired): "a round-certificate quorum just formed".
        self.on_certified: Optional[Callable[[RoundCertificate], None]] = None
        self.stats = {
            "certs_checked": 0,
            "certs_valid": 0,
            "certs_invalid": 0,
            "verdict_hits": 0,
            "pairing_checks": 0,
        }

    # -- aggregation (the assembling side) ------------------------------

    def _sum_points(self, points: Sequence[tuple]) -> Optional[tuple]:
        if self.msm == "device":
            return bls_msm.sum_points(points, device=self.device)
        if self.msm == "sharded":
            if self._sharded is None:
                from dag_rider_tpu_torch.parallel.mesh import make_mesh
                from dag_rider_tpu_torch.parallel.msm import ShardedMSM

                self._sharded = ShardedMSM(make_mesh(device=self.device.type))
            return self._sharded.sum_points(points)
        return bls.g1_sum(points)

    def aggregate(self, sigs: Sequence[bytes]) -> Optional[bytes]:
        """Compressed G1 sum of per-vertex certificate signatures, or
        None when any share is malformed (the aggregator only ever feeds
        shares it produced or directly verified vertices for, so None
        here means local corruption, not a protocol event)."""
        points = []
        for s in sigs:
            pt = bls.g1_decompress(s)
            if pt is None:
                return None
            points.append(pt)
        acc = self._sum_points(points)
        return bls.g1_compress(acc)

    def make_certificate(
        self, rnd: int, entries: Sequence[Tuple[int, bytes, bytes]]
    ) -> Optional[RoundCertificate]:
        """Assemble a certificate from (source, digest, cert_sig)
        triples of directly verified round-``rnd`` vertices. Returns None
        below quorum or on a malformed share."""
        if len(entries) < self.quorum:
            return None
        entries = sorted(entries)
        agg = self.aggregate([sig for _, _, sig in entries])
        if agg is None:
            return None
        return RoundCertificate(
            round=rnd,
            signers=tuple(src for src, _, _ in entries),
            digests=tuple(d for _, d, _ in entries),
            agg_sig=agg,
        )

    # -- verification (the receiving side) ------------------------------

    def _structurally_valid(self, cert: RoundCertificate) -> bool:
        s = cert.signers
        if len(s) < self.quorum or len(s) != len(cert.digests):
            return False
        # strictly increasing => sorted, unique, and a stable wire form
        if any(b <= a for a, b in zip(s, s[1:])):
            return False
        return 0 <= s[0] and s[-1] < self.registry.n

    def verify_certificate(self, cert: RoundCertificate) -> bool:
        """One aggregate check for the whole round. False for ANY defect
        — bad bitmap, unknown signer, forged aggregate, substituted
        digests — never an exception: like the per-vertex seam, a bad
        input yields a reject bit."""
        self.stats["certs_checked"] += 1
        key = cert.signing_key()
        hit = self._verdicts.get(key)
        if hit is not None:
            self.stats["verdict_hits"] += 1
            return hit
        ok = self._check(cert)
        if len(self._verdicts) >= _VERDICT_CACHE_MAX:
            self._verdicts.clear()
        self._verdicts[key] = ok
        self.stats["certs_valid" if ok else "certs_invalid"] += 1
        if ok and self.on_certified is not None:
            self.on_certified(cert)
        return ok

    def _pairing_check(self, pairs: Sequence[tuple]) -> bool:
        """Route one product check through the pairing seam; the counter
        is the number of pairing products paid."""
        self.stats["pairing_checks"] += 1
        if self.pair == "device":
            return bls_pairing.multi_pairing_check(pairs, self.device)
        return bls.multi_pairing_check(pairs)

    def _cert_pairs(self, cert: RoundCertificate) -> Optional[List[tuple]]:
        """The certificate's product-check pair list
        ``[(agg, -G2)] + [(H(d_i), pk_i) ...]``, or None for any
        structural defect (bad bitmap, unknown signer, bad point)."""
        if not self._structurally_valid(cert):
            return None
        agg = bls.g1_decompress(cert.agg_sig)
        if agg is None:
            return None
        pairs: List[tuple] = [(agg, bls.g2_neg(bls.G2_GEN))]
        for src, digest in zip(cert.signers, cert.digests):
            pk = self.registry.bls_key_of(src)
            if pk is None:
                return None
            pairs.append((bls.hash_to_g1(digest), pk))
        return pairs

    def _check(self, cert: RoundCertificate) -> bool:
        pairs = self._cert_pairs(cert)
        if pairs is None:
            return False
        return self._pairing_check(pairs)

    def verify_many(self, certs: Sequence[RoundCertificate]) -> List[bool]:
        """Batched receiver-side verification: every pending certificate's
        pair list merges into ONE combined product check.

        A combined pass is sound for *admission* — by aggregate
        unforgeability every claimed (digest, pk) pair across the batch
        was signed — but it does NOT prove each component certificate
        individually well-formed (offsetting defects cancel in the
        product), so only the combined verdict is memoized, keyed by the
        sorted member identities. Per-cert verdicts come from
        :meth:`verify_certificate` on the localization path when the
        combined check fails."""
        verdicts: List[Optional[bool]] = []
        fresh: List[int] = []
        for i, cert in enumerate(certs):
            hit = self._verdicts.get(cert.signing_key())
            if hit is not None:
                self.stats["certs_checked"] += 1
                self.stats["verdict_hits"] += 1
                verdicts.append(hit)
            else:
                verdicts.append(None)
                fresh.append(i)
        if len(fresh) < 2:
            for i in fresh:
                verdicts[i] = self.verify_certificate(certs[i])
            return [bool(v) for v in verdicts]
        combined_key = ("many",) + tuple(
            sorted(certs[i].signing_key() for i in fresh)
        )
        if self._verdicts.get(combined_key):
            # combined verdicts are only ever memoized True
            for i in fresh:
                self.stats["certs_checked"] += 1
                self.stats["verdict_hits"] += 1
                verdicts[i] = True
            return [bool(v) for v in verdicts]
        pair_lists = [self._cert_pairs(certs[i]) for i in fresh]
        if all(pl is not None for pl in pair_lists):
            all_pairs: List[tuple] = []
            for pl in pair_lists:
                all_pairs.extend(pl)  # type: ignore[arg-type]
            if self._pairing_check(all_pairs):
                if len(self._verdicts) >= _VERDICT_CACHE_MAX:
                    self._verdicts.clear()
                self._verdicts[combined_key] = True
                for i in fresh:
                    self.stats["certs_checked"] += 1
                    self.stats["certs_valid"] += 1
                    verdicts[i] = True
                    if self.on_certified is not None:
                        self.on_certified(certs[i])
                return [bool(v) for v in verdicts]
        # a structural defect or a failed combined product: localize with
        # individual (memoized) checks — identical verdicts to the oracle
        for i in fresh:
            verdicts[i] = self.verify_certificate(certs[i])
        return [bool(v) for v in verdicts]

    # -- cert-of-certs ----------------------------------------------------

    def make_span(
        self, first_round: int, certs: Sequence[RoundCertificate]
    ) -> Optional[SpanCertificate]:
        """Fold consecutive VERIFIED round certificates into one
        cert-of-certs: the span aggregate is the G1 sum of the round
        aggregates (through the same MSM seam as share aggregation), so
        one combined pairing covers every (digest, pk) pair in the span.
        Returns None unless the certs cover exactly ``first_round,
        first_round + 1, ...`` gap-free."""
        if not certs:
            return None
        rounds = [c.round for c in certs]
        if rounds != list(range(first_round, first_round + len(certs))):
            return None
        points = []
        for c in certs:
            pt = bls.g1_decompress(c.agg_sig)
            if pt is None:
                return None
            points.append(pt)
        agg = bls.g1_compress(self._sum_points(points))
        return SpanCertificate(
            first_round=first_round,
            signers=tuple(c.signers for c in certs),
            digests=tuple(c.digests for c in certs),
            agg_sig=agg,
        )

    def _span_structurally_valid(self, span: SpanCertificate) -> bool:
        k = len(span.signers)
        if k < 1 or len(span.digests) != k or span.first_round < 1:
            return False
        for s, d in zip(span.signers, span.digests):
            if len(s) < self.quorum or len(s) != len(d):
                return False
            if any(b <= a for a, b in zip(s, s[1:])):
                return False
            if s[0] < 0 or s[-1] >= self.registry.n:
                return False
        return True

    def verify_span(self, span: SpanCertificate) -> bool:
        """ONE combined product check for the whole span — the
        steady-state consumer pays 1/k pairing checks per round. False
        for any defect, never an exception; the verdict is memoized
        under the span's own tagged key (never folded back into
        per-round verdicts — see :meth:`verify_many` on why)."""
        self.stats["certs_checked"] += 1
        key = span.signing_key()
        hit = self._verdicts.get(key)
        if hit is not None:
            self.stats["verdict_hits"] += 1
            return hit
        ok = self._span_check(span)
        if len(self._verdicts) >= _VERDICT_CACHE_MAX:
            self._verdicts.clear()
        self._verdicts[key] = ok
        self.stats["certs_valid" if ok else "certs_invalid"] += 1
        return ok

    def _span_check(self, span: SpanCertificate) -> bool:
        if not self._span_structurally_valid(span):
            return False
        agg = bls.g1_decompress(span.agg_sig)
        if agg is None:
            return False
        pairs: List[tuple] = [(agg, bls.g2_neg(bls.G2_GEN))]
        for signers, digests in zip(span.signers, span.digests):
            for src, digest in zip(signers, digests):
                pk = self.registry.bls_key_of(src)
                if pk is None:
                    return False
                pairs.append((bls.hash_to_g1(digest), pk))
        return self._pairing_check(pairs)
