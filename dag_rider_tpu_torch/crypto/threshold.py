"""(f+1)-of-n threshold-BLS — the real common coin.

The port's copy of ``dag_rider_tpu/crypto/threshold.py``: the same keys,
shares, coefficients and group signatures, byte for byte. Only the
``msm=`` backend differs: ``ops.bls_msm.msm`` runs the combination on the
card.

Exactly the design the reference's TODO names ("PKI and a threshold
signature scheme with a threshold of (f+1)-of-n",
``process/process.go:388``), built on :mod:`dag_rider_tpu_torch.crypto.bls12381`:

- a trusted dealer (or DKG, out of scope) Shamir-shares a group secret
  over Z_r; process i holds share sk_i = poly(i+1);
- for wave w, each process signs the wave tag with its share and
  piggybacks the 48-byte share signature on its round(w,4) vertex;
- any f+1 valid shares Lagrange-interpolate (in the exponent — a G1
  multi-scalar multiplication, the device's work on this path) to the
  unique group signature sigma_w;
- leader(w) = H(sigma_w) mod n. Agreement: sigma_w is unique regardless
  of which f+1 shares combined. Unpredictability: fewer than f+1 shares
  reveal nothing (Shamir). Fairness: H(sigma_w) is uniform.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

from dag_rider_tpu_torch.crypto import bls12381 as bls

_COIN_DOMAIN = b"dagrider-threshold-coin-v1|"


def wave_tag(wave: int) -> bytes:
    return _COIN_DOMAIN + wave.to_bytes(8, "little")


class ThresholdKeys:
    """Dealer-generated key material for one committee.

    share_sks[i] is private to process i; group_pk and share_pks are the
    public PKI every process (and any external verifier) holds.
    """

    def __init__(
        self,
        threshold: int,
        group_pk,
        share_pks: Sequence,
        share_sks: Sequence[int],
    ):
        self.threshold = threshold
        self.group_pk = group_pk
        self.share_pks = tuple(share_pks)
        self.share_sks = tuple(share_sks)

    @staticmethod
    def generate(
        n: int, threshold: int, seed: bytes = b"dagrider-coin-dealer"
    ) -> "ThresholdKeys":
        """Deterministic dealer (seeded — tests / simulations only; a real
        deployment runs a DKG so nobody ever holds the group secret)."""
        if not 1 <= threshold <= n:
            raise ValueError("need 1 <= threshold <= n")
        coeffs = []
        for j in range(threshold):
            h = hashlib.sha512(seed + b"|coeff|" + str(j).encode()).digest()
            coeffs.append(int.from_bytes(h, "little") % bls.R)
        def poly(x: int) -> int:
            acc = 0
            for c in reversed(coeffs):
                acc = (acc * x + c) % bls.R
            return acc

        share_sks = [poly(i + 1) for i in range(n)]
        share_pks = [bls.pk_of(sk) for sk in share_sks]
        return ThresholdKeys(
            threshold, bls.pk_of(coeffs[0]), share_pks, share_sks
        )


def sign_share(share_sk: int, wave: int) -> bytes:
    """Process-local share signature for wave w (48 bytes)."""
    return bls.sign(share_sk, wave_tag(wave))


def verify_share(share_pk, wave: int, share: bytes) -> bool:
    """Pairing check of one share against that process's share pk."""
    return bls.verify(share_pk, wave_tag(wave), share)


def lagrange_at_zero(indices: Sequence[int]) -> List[int]:
    """Coefficients lambda_i for interpolation at x=0 over Z_r; indices
    are the Shamir x-coordinates (process index + 1)."""
    lams = []
    for i in indices:
        num, den = 1, 1
        for j in indices:
            if j == i:
                continue
            num = num * j % bls.R
            den = den * (j - i) % bls.R
        lams.append(num * pow(den, bls.R - 2, bls.R) % bls.R)
    return lams


def aggregate(
    shares: Dict[int, bytes], threshold: int, *, msm=None
) -> Optional[bytes]:
    """Combine >= threshold shares {source -> 48B sig} into the group
    signature. Returns None if fewer than threshold decode.

    The combination sigma = sum_i lambda_i * sigma_i is a G1 MSM; `msm`
    may override the backend (host double-and-add by default, the card
    via ops.bls_msm.msm when supplied).
    """
    decoded: List[Tuple[int, tuple]] = []
    for src in sorted(shares):
        pt = bls.g1_decompress(shares[src])
        if pt is not None:
            decoded.append((src, pt))
        if len(decoded) == threshold:
            break
    if len(decoded) < threshold:
        return None
    xs = [src + 1 for src, _ in decoded]
    lams = lagrange_at_zero(xs)
    points = [pt for _, pt in decoded]
    if msm is not None:
        sigma = msm(lams, points)
    else:
        sigma = bls.g1_msm(lams, points)
    return bls.g1_compress(sigma)


_RLC_DOMAIN = b"dagrider-coin-rlc-v1|"
_RLC_BITS = 64  # soundness 2^-64 per adversarial attempt


def _rlc_coeffs(wave: int, items: Sequence[Tuple[int, bytes]]) -> List[int]:
    """Fiat-Shamir 64-bit batch coefficients, bound to the whole share set
    (so no share's coefficient is predictable before all shares are fixed
    — an adversary cannot craft cancelling errors)."""
    h = hashlib.sha512()
    h.update(_RLC_DOMAIN)
    h.update(wave.to_bytes(8, "little"))
    for src, sh in items:
        h.update(src.to_bytes(4, "little"))
        h.update(sh)
    root = h.digest()
    out = []
    for src, _ in items:
        d = hashlib.sha512(root + src.to_bytes(4, "little")).digest()
        out.append(int.from_bytes(d[: _RLC_BITS // 8], "little") | 1)
    return out


def batch_verify_shares(
    share_pks: Sequence,
    wave: int,
    shares: Dict[int, bytes],
    *,
    msm=None,
) -> Dict[int, bytes]:
    """The subset of ``shares`` that individually verify — at batched cost.

    Replaces one pairing *per share* (seconds each in the host tower;
    minutes at committee scale) with:

    1. one random-linear-combination check over the whole set
       (2 Miller loops + two small-scalar MSMs): all-honest sets pass
       with exactly one pairing-product evaluation;
    2. on failure, single-bad-share localization from the failed check's
       own GT defect plus one x-weighted defect: with errors
       e_i = sigma_i - [sk_i]H, the RLC product gives
       v_c = e(-sum c_i e_i, g2) and x-scaled coefficients give
       v2 = e(-sum c_i x_i e_i, g2); one bad index j makes
       v2 == v_c^(x_j), found by an incremental GT power scan (Fp12
       muls, microseconds) — only one extra pairing product total;
    3. bisection over RLC checks for the multi-bad case, O(bad * log n)
       pairing products.

    Soundness: the RLC coefficients are 64-bit Fiat-Shamir outputs bound
    to the full share set, so a set with any invalid share passes with
    probability <= 2^-63 (coefficients are forced odd).
    """
    h_pt = bls.hash_to_g1(wave_tag(wave))
    neg_g2 = bls.g2_neg(bls.G2_GEN)
    decoded: List[Tuple[int, tuple]] = []
    for src in sorted(shares):
        pt = bls.g1_decompress(shares[src])
        if pt is not None:
            decoded.append((src, pt))
    if not decoded:
        return {}

    def rlc_product(
        subset: List[Tuple[int, tuple]], weights: Optional[List[int]] = None
    ) -> tuple:
        """GT defect of the subset under (optionally x-scaled) Fiat-Shamir
        coefficients: FP12_ONE iff every share in the subset verifies."""
        cs = _rlc_coeffs(wave, [(s, shares[s]) for s, _ in subset])
        if weights is not None:
            cs = [c * w for c, w in zip(cs, weights)]
        pts = [pt for _, pt in subset]
        sig_comb = msm(cs, pts) if msm is not None else bls.g1_msm(cs, pts)
        pk_comb = bls.g2_msm(cs, [share_pks[s] for s, _ in subset])
        return bls.pairing_product([(sig_comb, neg_g2), (h_pt, pk_comb)])

    def rlc_holds(subset: List[Tuple[int, tuple]]) -> bool:
        return rlc_product(subset) == bls.FP12_ONE

    v_c = rlc_product(decoded)
    if v_c == bls.FP12_ONE:
        return {s: shares[s] for s, _ in decoded}

    # One-bad-share localization from the defect we already have: with
    # errors e_i = sigma_i - [sk_i]H, v_c = e(-sum c_i e_i, g2); weighting
    # the same coefficients by x_i = src_i + 1 gives
    # v2 = e(-sum c_i x_i e_i, g2). A single bad index j makes
    # v2 == v_c^(x_j) — found by an incremental GT power scan.
    xs = [s + 1 for s, _ in decoded]
    v2 = rlc_product(decoded, weights=xs)
    by_x = {x: s for x, (s, _) in zip(xs, decoded)}
    power = v_c  # v_c^x at loop head
    bad_src = None
    for x in range(1, max(xs) + 1):
        if x in by_x and power == v2:
            bad_src = by_x[x]
            break
        power = bls.fp12_mul(power, v_c)
    if bad_src is not None:
        rest = [(s, pt) for s, pt in decoded if s != bad_src]
        if not rest:
            return {}
        if rlc_holds(rest):
            return {s: shares[s] for s, _ in rest}

    # Multiple bad shares: bisect. Precondition of _failed: the subset's
    # RLC check is already known False (the full set failed above), so
    # split immediately instead of re-paying that pairing product.
    def filt_failed(subset: List[Tuple[int, tuple]]) -> List[Tuple[int, tuple]]:
        if len(subset) == 1:
            return []
        mid = len(subset) // 2
        out: List[Tuple[int, tuple]] = []
        for part in (subset[:mid], subset[mid:]):
            if rlc_holds(part):
                out.extend(part)
            else:
                out.extend(filt_failed(part))
        return out

    return {s: shares[s] for s, _ in filt_failed(decoded)}


def verify_group(group_pk, wave: int, sigma: bytes) -> bool:
    return bls.verify(group_pk, wave_tag(wave), sigma)


def leader_from_sigma(sigma: bytes, n: int) -> int:
    """H(sigma) mod n — uniform because sigma is a uniform group element
    determined before any adversary sees f+1 shares."""
    return int.from_bytes(hashlib.sha512(sigma).digest(), "little") % n
