"""The port's joint-Feldman DKG against the JAX package's, exactly.

``run_dkg`` draws each dealer's polynomial from ``os.urandom``; the tests
replace it with one seeded stream, restarted before each package's run,
so both packages deal the same polynomials. Then ``run_dkg`` (honest, a
bad-share dealer, a silent dealer, too few qualified), a false complaint
answered by a reveal, ``run_resharing`` and ``derive_epoch_keys(...,
"dkg", i)`` must give the same qualified set, secret shares, share public
keys and group key in both packages, and the keys must drive the port's
threshold coin machinery. ``run_dkg_networked`` runs over a small
in-memory bus with ``BlobBus``'s surface (send, broadcast, recv, wait),
one thread a participant. These are host modules: the tolerance is zero.
"""

import hashlib
import os
import threading
import types

import pytest

from dag_rider_tpu.crypto import dkg as jdkg, ed25519 as jed
from dag_rider_tpu.epoch.manager import EpochTransition as JTransition
from dag_rider_tpu.epoch.manager import derive_epoch_keys as jderive
from dag_rider_tpu_torch.crypto import bls12381 as bls, dkg as tdkg, ed25519 as ted
from dag_rider_tpu_torch.crypto import threshold as th
from dag_rider_tpu_torch.epoch.manager import EpochTransition as TTransition
from dag_rider_tpu_torch.epoch.manager import derive_epoch_keys as tderive

JAX = types.SimpleNamespace(dkg=jdkg, ed=jed)
PORT = types.SimpleNamespace(dkg=tdkg, ed=ted)


def seeds(n):
    return [bytes([i]) * 32 for i in range(n)]


@pytest.fixture
def seeded_urandom(monkeypatch):
    """A function that restarts a seeded ``os.urandom`` stream."""

    def restart(tag: bytes = b"dkg"):
        counter = [0]

        def urandom(k: int) -> bytes:
            out = b""
            while len(out) < k:
                out += hashlib.sha256(tag + counter[0].to_bytes(8, "little")).digest()
                counter[0] += 1
            return out[:k]

        monkeypatch.setattr(os, "urandom", urandom)

    return restart


def outcome(results):
    return [(r.index, r.threshold, r.qualified, r.share_sk, r.share_pks, r.group_pk)
            for r in results]


@pytest.mark.parametrize("n,t,byzantine", [
    (4, 2, None), (4, 2, {1: "bad_share"}), (4, 2, {2: "silent"}),
    (7, 3, {0: "bad_share", 5: "silent"}),
])
def test_run_dkg_equals_jax(n, t, byzantine, seeded_urandom):
    seeded_urandom()
    want = jdkg.run_dkg(n, t, seeds(n), byzantine=byzantine)
    seeded_urandom()
    got = tdkg.run_dkg(n, t, seeds(n), byzantine=byzantine)
    assert outcome(got) == outcome(want)
    bad = set(byzantine or ())
    assert all(set(r.qualified) == set(range(n)) - bad for r in got)
    for r in got:
        assert bls.pk_of(r.share_sk) == r.share_pks[r.index]
    # t shares drive the threshold coin's aggregate and verify
    shares = {r.index: th.sign_share(r.share_sk, 7) for r in got[:t]}
    sigma = th.aggregate(shares, t)
    assert sigma is not None and th.verify_group(got[0].group_pk, 7, sigma)


def test_too_few_qualified_raises_in_both():
    for pkg in (JAX, PORT):
        with pytest.raises(RuntimeError, match="qualified"):
            pkg.dkg.run_dkg(3, 3, seeds(3), byzantine={0: "silent"})


def _false_complaint(pkg):
    """``tests/test_dkg.py:test_false_complaint_reveals_but_keeps_dealer``."""
    n, t = 4, 2
    pks = [pkg.ed.generate_keypair(s)[1] for s in seeds(n)]
    sessions = [pkg.dkg.DkgSession(i, n, t, seeds(n)[i], pks) for i in range(n)]
    for d, s in enumerate(sessions):
        cb = s.commitment_blob()
        for j, o in enumerate(sessions):
            if j != d:
                o.on_commitments(d, cb)
                o.on_share(d, s.share_blob_for(j))
    for s in sessions:
        s.on_complaint(3, 0)
    reveal = sessions[0].reveal_blob(3)
    for s in sessions:
        s.on_reveal(0, 3, reveal)
    return [s.finalize() for s in sessions]


def test_false_complaint_equals_jax(seeded_urandom):
    seeded_urandom()
    want = _false_complaint(JAX)
    seeded_urandom()
    got = _false_complaint(PORT)
    assert outcome(got) == outcome(want)
    assert all(0 in r.qualified for r in got)


@pytest.mark.parametrize("n,t,seed,byzantine", [
    (4, 2, b"epoch-1", None), (4, 2, b"epoch-2", {3: "bad_share"}), (7, 3, b"epoch-3", None),
])
def test_run_resharing_equals_jax(n, t, seed, byzantine):
    got = tdkg.run_resharing(n, t, seed, byzantine=byzantine)
    assert outcome(got) == outcome(jdkg.run_resharing(n, t, seed, byzantine=byzantine))
    assert len({r.group_pk for r in got}) == 1


def test_derive_epoch_keys_dkg_equals_jax():
    seed = hashlib.sha256(b"transition").digest()
    views = []
    for i in range(4):
        got = tderive(TTransition(1, 4, seed, ()), 4, 2, "dkg", i)
        want = jderive(JTransition(1, 4, seed, ()), 4, 2, "dkg", i)
        assert (got.threshold, got.group_pk, got.share_pks, got.share_sks) == (
            want.threshold, want.group_pk, want.share_pks, want.share_sks)
        assert got.share_sks[i] is not None
        assert all(sk is None for j, sk in enumerate(got.share_sks) if j != i)
        views.append(got)
    assert len({(k.group_pk, k.share_pks) for k in views}) == 1


class MemoryBus:
    """``BlobBus``'s surface over in-process queues."""

    def __init__(self, index, hub):
        self.index = index
        self.hub = hub
        self.inbox = []
        self.lock = threading.Lock()

    def send(self, peer, kind, payload):
        if peer == self.index or peer not in self.hub:
            return False
        dest = self.hub[peer]
        with dest.lock:
            dest.inbox.append((self.index, kind, bytes(payload)))
        return True

    def broadcast(self, kind, payload):
        return sum(self.send(p, kind, payload) for p in sorted(self.hub) if p != self.index)

    def recv(self):
        with self.lock:
            out, self.inbox = self.inbox, []
        return out

    def wait(self, seconds):
        threading.Event().wait(seconds)

    def close(self):
        pass


@pytest.mark.parametrize("silent", [None, 3])
def test_run_dkg_networked_over_a_memory_bus(silent):
    n, t = 4, 2
    hub = {}
    for i in range(n):
        if i != silent:
            hub[i] = MemoryBus(i, hub)
    pks = [ted.generate_keypair(s)[1] for s in seeds(n)]
    results, errors = {}, []

    def run(i):
        try:
            results[i] = tdkg.run_dkg_networked(hub[i], n, t, seeds(n)[i], pks,
                                                phase_timeout_s=2.0 if silent else 20.0,
                                                poll_s=0.005)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append((i, e))

    threads = [threading.Thread(target=run, args=(i,)) for i in hub]
    for th_ in threads:
        th_.start()
    for th_ in threads:
        th_.join(timeout=120)
    if silent is not None:
        # the confirm phase hears nothing from the silent peer: a detected
        # abort in every live participant, never two group keys
        assert sorted(i for i, _ in errors) == sorted(hub)
        assert all("confirmation failed" in str(e) for _, e in errors)
        return
    assert not errors, errors
    r0 = results[0]
    assert r0.qualified == tuple(range(n))
    assert all(r.group_pk == r0.group_pk and r.share_pks == r0.share_pks
               for r in results.values())
    shares = {r.index: th.sign_share(r.share_sk, 11) for r in list(results.values())[:t]}
    sigma = th.aggregate(shares, t)
    assert sigma and th.verify_group(r0.group_pk, 11, sigma)
