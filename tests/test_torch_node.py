"""The port's committee node, held to the reference's.

Every recipe of ``tests/test_node.py`` runs unchanged against the port's
``node.py`` (``tests/torch_replay.py``): keygen round trip, a live 4-node
gRPC committee with checkpoints, restart from a checkpoint, churn, a
committee through a verifier sidecar, the ``gc_depth`` plumbing. Then
what the port's node adds or must keep: its key files are the
reference's bytes for a seed, and the declared seams of ``node.py``
behave as declared. ``"device"`` and ``"sharded"`` verifiers and
``coin_msm: "device"`` build on the card and raise on a machine without
one (never a CPU stand-in, with or without the ladder's floor);
``coin_msm: "host"`` (the default) builds the host group law's coin; the
``verify_fallback``/``verify_retry`` knobs wire the ladder as the
reference wires it; ``net_batch`` puts the transport in batch mode, and a
live 4-node committee with it delivers and agrees.
"""

import json

import pytest
import torch

from dag_rider_tpu import node as ref_node
from dag_rider_tpu_torch import node as node_mod
from dag_rider_tpu_torch.consensus.coin import RoundRobinCoin, ThresholdCoin
from dag_rider_tpu_torch.verifier.cpu import CPUVerifier
from dag_rider_tpu_torch.verifier.resilient import ResilientVerifier
from dag_rider_tpu_torch.verifier.sidecar import RemoteVerifier
from torch_replay import replay

REPLAYED = replay("test_node.py", globals())


def test_every_reference_recipe_is_replayed():
    assert REPLAYED == [
        "test_keygen_roundtrip",
        "test_g2_serialize_identity_and_roundtrip",
        "test_four_node_cluster_delivers_and_checkpoints",
        "test_node_restart_from_checkpoint_catches_up",
        "test_churn_restored_logs_stay_prefix_consistent",
        "test_node_through_remote_verifier_sidecar",
        "test_node_config_plumbs_gc_depth",
    ]


@pytest.mark.parametrize("n,t,seed", [(4, 2, "a"), (7, 3, "dagrider-cluster-5")])
def test_generate_keys_gives_the_references_bytes(n, t, seed):
    blob = node_mod.generate_keys(n, t, seed)
    assert json.dumps(blob, sort_keys=True) == json.dumps(
        ref_node.generate_keys(n, t, seed), sort_keys=True)
    reg, seeds, coin_keys = node_mod.load_keys(blob)
    ref_reg, ref_seeds, ref_coin = ref_node.load_keys(blob)
    assert reg.public_keys == ref_reg.public_keys and seeds == ref_seeds
    assert coin_keys.share_sks == ref_coin.share_sks


def _keys(tmp_path, n=4):
    path = tmp_path / "keys.json"
    node_mod._dump_secret_file(str(path), node_mod.generate_keys(n, n // 3 + 1, "seams"))
    return str(path)


def _cfg(keys, **kw):
    cfg = {"index": 0, "n": 4, "listen": "127.0.0.1:0", "peers": {}, "keys": keys,
           "rbc": False, "verifier": "none", "coin": "round_robin"}
    cfg.update(kw)
    return cfg


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the machine without a card")
@pytest.mark.parametrize("kw", [
    {"verifier": "device"},
    {"verifier": "device", "verify_fallback": "cpu"},
    {"verifier": "sharded"},
    {"verifier": "sharded", "verify_fallback": "cpu"},
    {"coin": "threshold_bls", "coin_msm": "device"},
], ids=["device", "device-ladder", "sharded", "sharded-ladder", "coin-msm-device"])
def test_card_kinds_raise_without_a_card(tmp_path, kw):
    from dag_rider_tpu_torch.verifier.base import VerifierUnavailableError

    with pytest.raises((VerifierUnavailableError, RuntimeError), match="CUDA"):
        node_mod.Node(_cfg(_keys(tmp_path), **kw))


def test_coin_msm_host_builds_the_host_coin(tmp_path):
    keys = _keys(tmp_path)
    for kw in ({}, {"coin_msm": "host"}):
        nd = node_mod.Node(_cfg(keys, coin="threshold_bls", **kw))
        try:
            coin = nd.process.coin
            assert isinstance(coin, ThresholdCoin) and coin._msm is None
            wave_shares = {j: coin._th.sign_share(coin.keys.share_sks[j], 5) for j in range(4)}
            for j, share in wave_shares.items():
                coin.observe_share(5, j, share)
            assert coin.ready(5)
            sigma = coin._th.aggregate(wave_shares, coin.keys.threshold)
            assert coin.choose_leader(5) == coin._th.leader_from_sigma(sigma, 4)
        finally:
            nd.net.close()
    with pytest.raises(ValueError, match="coin_msm"):
        node_mod.Node(_cfg(keys, coin="threshold_bls", coin_msm="mesh"))
    nd = node_mod.Node(_cfg(keys))
    try:
        assert isinstance(nd.process.coin, RoundRobinCoin)
    finally:
        nd.net.close()


def test_verify_fallback_and_retry_wire_the_ladder(tmp_path, monkeypatch):
    keys = _keys(tmp_path)
    monkeypatch.delenv("DAGRIDER_VERIFY_FALLBACK", raising=False)
    monkeypatch.delenv("DAGRIDER_VERIFY_RETRY", raising=False)
    remote = {"verifier": "remote", "verifier_address": "127.0.0.1:1"}
    nd = node_mod.Node(_cfg(keys, **remote))
    try:
        assert isinstance(nd.process.verifier, RemoteVerifier)
        assert nd.process.verifier._retries == 1  # DAGRIDER_VERIFY_RETRY unset
    finally:
        nd.net.close()
    nd = node_mod.Node(_cfg(keys, verify_fallback="cpu", verify_retry=2, **remote))
    try:
        ladder = nd.process.verifier
        assert isinstance(ladder, ResilientVerifier)
        assert isinstance(ladder.tiers[0], RemoteVerifier) and ladder.tiers[0]._retries == 2
        assert isinstance(ladder.tiers[1], CPUVerifier)
    finally:
        nd.net.close()
    monkeypatch.setenv("DAGRIDER_VERIFY_FALLBACK", "cpu")
    monkeypatch.setenv("DAGRIDER_VERIFY_RETRY", "3")
    nd = node_mod.Node(_cfg(keys, **remote))
    try:
        assert isinstance(nd.process.verifier, ResilientVerifier)
        assert nd.process.verifier.tiers[0]._retries == 3
    finally:
        nd.net.close()
    with pytest.raises(ValueError, match="verify_fallback"):
        node_mod.Node(_cfg(keys, verify_fallback="device", **remote))
    with pytest.raises(ValueError, match="verifier_address"):
        node_mod.Node(_cfg(keys, verifier="remote"))
    with pytest.raises(ValueError, match="unknown verifier"):
        node_mod.Node(_cfg(keys, verifier="cuda"))


def test_sync_patience_is_a_node_config_key(tmp_path):
    """``sync_patience`` reaches the node's ``Process`` (a socket committee
    of 16 needs thousands of quiescent ticks where the simulator's 8
    suffice); unset, the node keeps the reference node's 8."""
    keys = _keys(tmp_path)
    for kw, want in (({}, 8), ({"sync_patience": 5000}, 5000), ({"sync_patience": "40"}, 40)):
        nd = node_mod.Node(_cfg(keys, **kw))
        try:
            assert nd.process.cfg.sync_patience == want
        finally:
            nd.net.close()
    ref = ref_node.Node(_cfg(keys))
    try:
        assert ref.process.cfg.sync_patience == 8
    finally:
        ref.net.close()


def test_net_batch_is_a_node_config_key(tmp_path):
    """``net_batch`` puts the node's gRPC transport in batch mode with
    ``NET_BATCH_BYTES`` a batch; unset or false, the transport sends one
    RPC a frame as the reference's does."""
    keys = _keys(tmp_path)
    for kw, want in (({}, 0), ({"net_batch": False}, 0),
                     ({"net_batch": True}, node_mod.NET_BATCH_BYTES)):
        nd = node_mod.Node(_cfg(keys, **kw))
        try:
            assert nd.net._batch_bytes == want
            assert (nd.net._outbox is None) == (want == 0)
        finally:
            nd.net.close()


def test_a_batched_four_node_committee_delivers_and_agrees(tmp_path):
    """The reference's live 4-node committee (RBC, threshold coin, empty
    proposals) with ``net_batch`` on: every node delivers n vertices and
    the logs agree, in fewer RPCs than frames (the pump flushes)."""
    import time

    from dag_rider_tpu_torch.core.types import Block as TBlock

    keys = _keys(tmp_path)
    n = 4
    nodes = [node_mod.Node(_cfg(keys, index=i, rbc=True, coin="threshold_bls",
                                propose_empty=True, submit_interval_s=0, net_batch=True))
             for i in range(n)]
    addrs = {i: f"127.0.0.1:{nd.net.bound_port}" for i, nd in enumerate(nodes)}
    for i, nd in enumerate(nodes):
        nd.net._peers.update({j: a for j, a in addrs.items() if j != i})
    broadcasts = []
    inner = nodes[0].net.broadcast
    nodes[0].net.broadcast = lambda msg: (broadcasts.append(msg.kind), inner(msg))
    try:
        for nd in nodes:
            nd.start()
        for nd in nodes:
            for k in range(10):
                nd.submit(TBlock((f"n{nd.process.index}-b{k}".encode(),)))
        deadline = time.time() + 60
        while time.time() < deadline and not all(len(nd.delivered) >= n for nd in nodes):
            time.sleep(0.05)
    finally:
        for nd in nodes:
            nd.stop()
    logs = [[(v.id.round, v.id.source, v.digest()) for v in nd.delivered] for nd in nodes]
    k = min(len(log) for log in logs)
    assert k >= n and all(log[:k] == logs[0][:k] for log in logs)
    frames = (n - 1) * len(broadcasts)  # node 0's frames: one a peer a broadcast
    sends = nodes[0].process.metrics.counters["net_sends"]
    assert 0 < sends < frames and {"val", "echo", "ready"} <= set(broadcasts)
