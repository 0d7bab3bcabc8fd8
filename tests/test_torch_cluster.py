"""The port's multi-process cluster harness, held to the reference's.

Every recipe of ``tests/test_cluster.py`` runs unchanged against the
port's ``cluster/`` (``tests/torch_replay.py``): the workspace layout,
the WAL, delivery-log and hint parsing with torn tails, the rejoin
embedding, the post-hoc audit over synthetic logs, and the kill -9
rejoin of 4 OS processes of ``python -m dag_rider_tpu_torch.cluster.runner``
over UDS. Then both packages read the same files: the audit reports,
commit-prefix digests, delivery logs and WALs the two harnesses derive
from one workspace are equal, and the seeded fault plan and the cluster
directory are the reference's. Last, the port's declared seam here, which
closes a duplicate-commit window the reference harness leaves open (its
kill -9 recipe audits a duplicate in some runs, as the port's copy did
before the seam): a restored checkpoint can hold, in its mempool and its
proposal queue, a transaction the previous incarnation proposed and the
cluster committed; the node jumps past that commit by state transfer and
batches the transaction again. The port's runner drops from both what its
delivery log or its hint shows committed, from the pool through the one
method the port's mempool adds, ``Mempool.drop_committed``.
"""

import json
import os

import pytest

from dag_rider_tpu.cluster import audit as ref_audit
from dag_rider_tpu.cluster import runner as ref_runner
from dag_rider_tpu.cluster import supervisor as ref_supervisor
from dag_rider_tpu.cluster.directory import build_cluster as ref_build_cluster
from dag_rider_tpu_torch.cluster import audit, runner, supervisor
from dag_rider_tpu_torch.cluster.directory import ClusterSpec, build_cluster
from torch_replay import replay

REPLAYED = replay("test_cluster.py", globals())


def test_every_reference_recipe_is_replayed():
    assert len(REPLAYED) == 14 and "test_cluster_kill9_rejoin_zero_loss" in REPLAYED


def test_kill9_rejoin_through_the_ports_runner_processes(tmp_path, monkeypatch):
    """The kill -9 recipe in the fast tier, with every command line the
    supervisor starts recorded: each is an OS process of the port's
    runner (four at boot, one restart)."""
    argvs = []
    real = supervisor.subprocess.Popen

    def popen(args, *a, **kw):
        argvs.append(list(args))
        return real(args, *a, **kw)

    monkeypatch.setattr(supervisor.subprocess, "Popen", popen)
    test_cluster_kill9_rejoin_zero_loss(tmp_path)  # noqa: F821 (bound by replay)
    assert len(argvs) == 5
    assert all(a[1:3] == ["-m", "dag_rider_tpu_torch.cluster.runner"] for a in argvs)


@pytest.mark.parametrize("seed", [0, 5, 11])
def test_seeded_kill_plan_is_the_references(seed):
    for n in (4, 7):
        assert supervisor.seeded_kill_plan(seed, n) == ref_supervisor.seeded_kill_plan(seed, n)


def test_cluster_directory_is_the_references(tmp_path):
    port = build_cluster(str(tmp_path / "port"), 4, transport="uds", seed=3)
    ref = ref_build_cluster(str(tmp_path / "ref"), 4, transport="uds", seed=3)

    def shape(spec):
        root = spec.root
        blob = json.loads(json.dumps(spec.to_json()).replace(root, "<root>"))
        cfgs = [json.loads(open(nf.config).read().replace(root, "<root>"))
                for nf in spec.nodes]
        return blob, cfgs, json.load(open(os.path.join(root, "keys.json")))

    assert shape(port) == shape(ref)
    assert ClusterSpec.load(port.root).to_json() == port.to_json()


def _canonical(k):
    return {"ts": 10.0 + k, "r": k + 1, "s": k % 4, "d": bytes([k + 1]).hex() * 4,
            "tx": [bytes([0xA0 + k]).hex()]}


@pytest.mark.parametrize("case", ["clean", "lost", "divergent", "rejoiner", "torn"])
def test_audit_reports_equal_the_references(tmp_path, case):
    """One synthetic workspace, audited by both packages: the reports, the
    commit-prefix digests and the parsed logs and WALs are equal."""
    spec = ClusterSpec(root=str(tmp_path), n=4, transport="uds",
                       addresses=["unix:/dev/null"] * 4, seed=0,
                       accepted_log=str(tmp_path / "accepted.jsonl"))
    from dag_rider_tpu_torch.cluster.directory import NodeFiles

    logs = [[_canonical(k) for k in range(6)] for _ in range(4)]
    accepted = [bytes([0xA0 + k]) for k in range(6)]
    restarted = ()
    if case == "lost":
        accepted.append(b"\xee")
    elif case == "divergent":
        logs[3][2] = dict(logs[3][2], d="ff" * 4)
    elif case == "rejoiner":
        logs[2] = logs[2][:2] + logs[2][4:]
        restarted = (2,)
    for i in range(4):
        nf = NodeFiles.for_node(spec.root, i)
        os.makedirs(nf.flight_dir, exist_ok=True)
        spec.nodes.append(nf)
        with open(nf.delivery_log, "w") as fh:
            fh.writelines(json.dumps(rec) + "\n" for rec in logs[i])
            if case == "torn" and i == 1:
                fh.write('{"ts": 99.0, "r": 9')
        with open(nf.final_report, "w") as fh:
            json.dump({"index": i, "decided_wave": 2, "retained": []}, fh)
        with open(nf.submits_wal, "w") as fh:
            fh.writelines(tx.hex() + "\n" for tx in accepted[i::4])
            if case == "torn":
                fh.write("abc")
    with open(spec.accepted_log, "w") as fh:
        fh.writelines(json.dumps({"tx": tx.hex(), "ts": 9.0 + k, "node": k % 4,
                                  "client": "c0"}) + "\n" for k, tx in enumerate(accepted))
    got = audit.audit_cluster(spec, restarted=restarted)
    want = ref_audit.audit_cluster(spec, restarted=restarted)
    assert got == want
    assert got["ok"] == (case in ("clean", "rejoiner", "torn"))
    assert audit.commit_prefix_digest(spec) == ref_audit.commit_prefix_digest(spec)
    for nf in spec.nodes:
        assert audit.read_delivery_log(nf.delivery_log) == ref_audit.read_delivery_log(
            nf.delivery_log)
        assert runner.read_delivered_txs(nf.delivery_log) == ref_runner.read_delivered_txs(
            nf.delivery_log)
        assert runner.read_wal(nf.submits_wal) == ref_runner.read_wal(nf.submits_wal)


def test_a_restarted_runner_drops_what_the_cluster_committed(tmp_path):
    """A transaction of the restored mempool or proposal queue that the
    hint shows committed leaves them at the restart; the reference keeps
    it and would propose it a second time."""
    from dag_rider_tpu.cluster import runner as ref_runner_mod
    from dag_rider_tpu.core.types import Block as JBlock
    from dag_rider_tpu_torch.core.types import Block

    spec = build_cluster(str(tmp_path / "clu"), 4, transport="uds", seed=2)
    nf = spec.nodes[3]
    committed, pending = b"committed-tx", b"pending-tx"
    with open(nf.submits_wal, "w") as fh:
        fh.write(committed.hex() + "\n" + pending.hex() + "\n")
    with open(nf.delivered_hint, "w") as fh:
        fh.write(committed.hex() + "\n")
    kept, queued = {}, {}
    for mod, block in ((runner, Block), (ref_runner_mod, JBlock)):
        r = mod.NodeRunner(json.load(open(nf.config)))
        try:
            r.node.submit(block((committed,)), client="c0")
            r.node.submit(block((pending,)), client="c0")
            r._reinject()
            kept[mod.__name__.split(".")[0]] = {e.tx for e in r.node.mempool.pool.pending()}
            # the restored proposal queue, as a checkpoint brings it back
            r.node.process.blocks_to_propose.extend(
                [block((committed, pending)), block((committed,))])
            if mod is runner:  # the reference has no such step
                r._drop_committed_blocks()
            queued[mod.__name__.split(".")[0]] = [
                b.transactions for b in r.node.process.blocks_to_propose]
        finally:
            r.node.net.close()
            for fh in (r._wal, r._dlog, r._events):
                fh.close()
    assert kept == {"dag_rider_tpu_torch": {pending}, "dag_rider_tpu": {committed, pending}}
    assert queued == {"dag_rider_tpu_torch": [(pending,)],
                      "dag_rider_tpu": [(committed, pending), (committed,)]}


def test_mempool_drop_committed_takes_out_only_what_committed():
    """The mempool's one removal seam: the committed payloads leave the pool
    and their latency books, the rest stay and are still batched."""
    from dag_rider_tpu_torch.config import MempoolConfig
    from dag_rider_tpu_torch.mempool import Mempool

    mp = Mempool(MempoolConfig(batch_bytes=1 << 16, batch_deadline_ms=0.0))
    txs = [bytes([i]) * 8 for i in range(6)]
    mp.submit(txs, client="c0", now=0.0)
    assert mp.drop_committed({txs[1], txs[4], b"never-seen"}) == 2
    assert [e.tx for e in mp.pool.pending()] == [txs[i] for i in (0, 2, 3, 5)]
    assert set(mp._inflight) == {txs[i] for i in (0, 2, 3, 5)}
    assert mp.drop_committed(set()) == 0
    blocks = mp.build_blocks(now=1.0, force=True)
    assert [tx for b in blocks for tx in b.transactions] == [txs[i] for i in (0, 2, 3, 5)]
