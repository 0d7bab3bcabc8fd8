"""Common-coin (wave leader election) implementations.

The port's copy of ``dag_rider_tpu/consensus/coin.py``. ``ThresholdCoin``
combines shares with the G1 MSM of ``ops.bls_msm`` on the card unless the
caller asks for the host group law (``msm="host"``, the oracle).

The reference's ``chooseLeader`` is a stub that always returns 1
(``process/process.go:386-392``) with a TODO naming the real design: "PKI
and a threshold signature scheme with a threshold of (f+1)-of-n"
(``process.go:388``). The coin must satisfy agreement, termination,
unpredictability and fairness (``process.go:386-387``).

Three implementations:

- :class:`FixedCoin` — the reference stub's semantics (constant leader),
  kept for differential testing against the reference's intent; predictable,
  breaks liveness against an adaptive adversary (SURVEY.md D9).
- :class:`RoundRobinCoin` — deterministic wave-indexed rotation. Fair and
  live against *static* adversaries; still predictable. Default for tests.
- ``ThresholdCoin`` (:mod:`dag_rider_tpu_torch.crypto.threshold`) — the real
  (f+1)-of-n threshold-BLS coin; shares are piggybacked on round(w,4)
  vertices so the coin is revealed only once the wave is complete.
"""

from __future__ import annotations

import abc
import functools
from typing import Optional


class CommonCoin(abc.ABC):
    """Leader-election oracle for waves.

    ``observe_share`` feeds coin shares extracted from delivered vertices;
    ``ready`` says whether wave w's coin can be evaluated; ``choose_leader``
    returns the elected source index (must be identical at every correct
    process — the agreement property).
    """

    @abc.abstractmethod
    def ready(self, wave: int) -> bool: ...

    @abc.abstractmethod
    def choose_leader(self, wave: int) -> int: ...

    def my_share(self, wave: int) -> Optional[bytes]:
        """Share this process contributes for wave ``wave`` (piggybacked on
        its round(w,4) vertex). None for share-less coins."""
        return None

    def observe_share(self, wave: int, source: int, share: bytes) -> None:
        """Ingest another process's share. No-op for share-less coins."""

    def prune_below(self, wave: int) -> None:
        """Drop per-wave state below ``wave`` (the GC floor's wave) —
        no-op for stateless coins. Called by Process.maybe_prune so the
        coin's books follow the same bounded window as the DAG and the
        RBC stage."""

    def rotate(self, keys, from_wave: int) -> None:
        """Install rotated threshold keys effective for waves >=
        ``from_wave`` (an epoch boundary) — no-op for keyless
        coins, whose leader schedule is wave-indexed and survives any
        membership epoch unchanged."""


class FixedCoin(CommonCoin):
    """Constant leader — reference-stub semantics (``process.go:390-392``),
    with the constant made explicit instead of hardcoded."""

    def __init__(self, leader: int = 0):
        self._leader = leader

    def ready(self, wave: int) -> bool:
        return True

    def choose_leader(self, wave: int) -> int:
        return self._leader


class RoundRobinCoin(CommonCoin):
    """Wave-indexed rotation: leader(w) = w mod n. Deterministic and fair
    (every source leads infinitely often); not unpredictable."""

    def __init__(self, n: int):
        self.n = n

    def ready(self, wave: int) -> bool:
        return True

    def choose_leader(self, wave: int) -> int:
        return wave % self.n


def _resolve_msm(msm, device):
    """The ``msm=`` backend handed to ``crypto.threshold``: None for the
    host group law, else a callable. ``device`` is read only by
    "device". Any other value, None included, raises ValueError, as
    ``CertVerifier`` does."""
    if msm == "host":
        return None
    if msm == "device":
        from dag_rider_tpu_torch.ops import bls_msm

        return functools.partial(bls_msm.msm, device=bls_msm.resolve_device(device))
    if callable(msm):
        return msm
    raise ValueError(f'coin MSM must be "device", "host" or a callable, got {msm!r}')


class ThresholdCoin(CommonCoin):
    """(f+1)-of-n threshold-BLS coin (crypto/threshold.py) — the design
    the reference's TODO names (``process.go:388``).

    Shares arrive piggybacked on round(w,4) vertices via
    ``observe_share``; the coin becomes ready once f+1 shares combine into
    a group signature that passes the pairing check. Aggregation is lazy
    and cached; if a combination fails (a Byzantine share slipped in),
    shares are verified individually, the bad ones discarded, and the
    remainder re-combined — so one corrupt share cannot stall the coin.

    ``msm``: "device" (the default: ``ops.bls_msm.msm`` on ``device``,
    which is ``cuda`` unless the caller passes ``"cpu"`` for the plain
    torch path; raises at construction when there is no card), "host"
    (the host group law, the oracle), or a callable ``(scalars, points) ->
    point`` used as it is. Any other value, None included, raises
    ValueError: ``CertVerifier`` takes the same spellings.
    """

    def __init__(self, keys, index: int, n: int, *, msm="device", device=None):
        from dag_rider_tpu_torch.crypto import threshold as th

        self._th = th
        self.keys = keys
        self.index = index
        self.n = n
        self._msm = _resolve_msm(msm, device)
        #: epoch key schedule: (first_wave, keys) entries,
        #: ascending. ``keys`` above always aliases the newest entry;
        #: :meth:`_keys_for` resolves the keys a given wave signs and
        #: verifies under, so a boundary rotation never invalidates
        #: shares already piggybacked for pre-boundary waves.
        self._schedule: list = [(1, keys)]
        self._shares: dict = {}
        self._sigma: dict = {}
        self._tried_at: dict = {}
        #: shares discarded by the batched bad-share filter, cumulative —
        #: under SUSTAINED pollution (a garbage-share adversary feeding
        #: junk every wave, consensus/adversary.py) this counts the
        #: recovery work wave after wave; the single-bad-share case is
        #: just its first increment
        self.filtered = 0

    def _keys_for(self, wave: int):
        """The key set wave ``wave`` operates under: the newest schedule
        entry whose first_wave is <= wave."""
        keys = self._schedule[0][1]
        for first, k in self._schedule:
            if first > wave:
                break
            keys = k
        return keys

    def rotate(self, keys, from_wave: int) -> None:
        """Install rotated keys for waves >= ``from_wave`` and make them
        the default for share signing. Aggregation state for pending
        waves is reset — any share that arrived early for a post-boundary
        wave must be re-judged under the keys that wave now verifies
        against (stale-epoch shares fail the pairing filter and are
        discarded, not trusted)."""
        if self._schedule[-1][0] >= from_wave:
            self._schedule = [
                (f, k) for f, k in self._schedule if f < from_wave
            ]
        self._schedule.append((from_wave, keys))
        self.keys = keys
        for w in [w for w in self._sigma if w >= from_wave]:
            del self._sigma[w]
        for w in [w for w in self._tried_at if w >= from_wave]:
            del self._tried_at[w]

    def my_share(self, wave: int):
        keys = self._keys_for(wave)
        sk = keys.share_sks[self.index]
        if sk is None:
            return None
        return self._th.sign_share(sk, wave)

    def observe_share(self, wave: int, source: int, share: bytes) -> None:
        if not isinstance(share, (bytes, bytearray)) or len(share) != 48:
            return
        self._shares.setdefault(wave, {}).setdefault(source, bytes(share))

    def _try_aggregate(self, wave: int) -> None:
        if wave in self._sigma:
            return
        keys = self._keys_for(wave)
        shares = self._shares.get(wave, {})
        if len(shares) < keys.threshold:
            return
        have = frozenset(shares)
        if self._tried_at.get(wave) == have:
            return  # no new shares since the last failed attempt
        self._tried_at[wave] = have
        sigma = self._th.aggregate(shares, keys.threshold, msm=self._msm)
        if sigma is not None and self._th.verify_group(
            keys.group_pk, wave, sigma
        ):
            self._sigma[wave] = sigma
            return
        # Byzantine share in the first combination: batched filter (RLC +
        # GT-defect localization — one pairing product for the honest
        # remainder instead of one pairing per share).
        good = self._th.batch_verify_shares(
            keys.share_pks, wave, shares, msm=self._msm
        )
        self.filtered += len(shares) - len(good)
        self._shares[wave] = good
        if len(good) >= keys.threshold:
            sigma = self._th.aggregate(good, keys.threshold, msm=self._msm)
            if sigma is not None:
                self._sigma[wave] = sigma

    def prune_below(self, wave: int) -> None:
        """Retire share/sigma/attempt books for waves below ``wave``.
        Safe: the retro leader chain only walks waves above the decided
        cursor, and the GC floor sits gc_depth rounds below it."""
        for d in (self._shares, self._sigma, self._tried_at):
            for w in [w for w in d if w < wave]:
                del d[w]
        # retire key-schedule entries wholly below the floor, keeping
        # the entry in force AT the floor wave (still needed to verify
        # shares for every surviving wave)
        while len(self._schedule) > 1 and self._schedule[1][0] <= wave:
            self._schedule.pop(0)

    def ready(self, wave: int) -> bool:
        self._try_aggregate(wave)
        return wave in self._sigma

    def choose_leader(self, wave: int) -> int:
        if not self.ready(wave):
            raise RuntimeError(f"coin for wave {wave} not ready")
        return self._th.leader_from_sigma(self._sigma[wave], self.n)
