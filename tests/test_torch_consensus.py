"""The port's consensus host modules vs the JAX package's, exactly.

``dag_rider_tpu_torch`` carries copies of the JAX package's host layer
(``config``, ``core``, ``transport``, ``consensus/dag_state.py``, the numpy
twin ``leader_reach_np``). Each is held here against its original on the
same inputs, and every comparison is exact: bytes, bits and counts.

- ``DagState`` on the Figure-1 fixture (``tests/fixtures.py``): the same
  ``path`` answers for every pair of vertices, strong and hybrid, and the
  same ``strong_stack`` arrays;
- ``leader_reach_np`` on seeded random stacks, and against the JAX
  package's jitted ``leader_reach``;
- the wire codec: equal bytes both ways, and each package decodes the
  other's bytes;
- ``Config``: the same fields, defaults, knob registry and validation
  errors;
- Bracha RBC: the recipes of ``tests/test_rbc.py`` (honest delivery,
  equivocation with fetch recovery, the consensus pipeline over RBC).
"""

import dataclasses
import random

import numpy as np
import pytest

import fixtures
from dag_rider_tpu import config as jconfig
from dag_rider_tpu.consensus.dag_state import DagState as JDagState
from dag_rider_tpu.consensus.simulator import Simulation as JSimulation
from dag_rider_tpu.core import codec as jcodec, types as JT
from dag_rider_tpu.ops import dag_kernels as jdk
from dag_rider_tpu.transport.memory import InMemoryTransport as JBroker
from dag_rider_tpu.transport.rbc import RbcTransport as JRbc
from dag_rider_tpu_torch import config as tconfig
from dag_rider_tpu_torch.consensus.dag_state import DagState as TDagState
from dag_rider_tpu_torch.consensus.simulator import Simulation as TSimulation
from dag_rider_tpu_torch.core import codec as tcodec, types as TT
from dag_rider_tpu_torch.ops import dag_kernels as tdk
from dag_rider_tpu_torch.transport.memory import InMemoryTransport as TBroker
from dag_rider_tpu_torch.transport.rbc import RbcTransport as TRbc


def figure1(T):
    """The Figure-1 fixture built from ``T``'s types (either package)."""
    out = []
    for r in range(fixtures.ROUNDS):
        for i in range(fixtures.N):
            out.append(
                T.Vertex(
                    id=T.VertexID(r, i),
                    block=T.Block((f"tx-{r}-{i}".encode(),)),
                    strong_edges=tuple(
                        T.VertexID(r - 1, j) for j in fixtures.STRONG.get((r, i), ())
                    ),
                    weak_edges=tuple(
                        T.VertexID(r2, j) for r2, j in fixtures.WEAK.get((r, i), ())
                    ),
                )
            )
    return out


def fig1_states():
    states = []
    for T, DagState, config in ((JT, JDagState, jconfig), (TT, TDagState, tconfig)):
        st = DagState(config.Config(n=fixtures.N))
        for v in figure1(T):
            if v.round > 0:
                st.insert(v)
        states.append(st)
    return states


# --- DagState ---------------------------------------------------------------------


def test_figure1_vertices_have_equal_digests():
    assert [v.digest() for v in figure1(JT)] == [v.digest() for v in figure1(TT)]
    assert [v.digest() for v in figure1(JT)] == [v.digest() for v in fixtures.figure1_vertices()]


@pytest.mark.parametrize("strong_only", [True, False], ids=["strong", "hybrid"])
def test_dag_state_path_answers_equal(strong_only):
    js, ts = fig1_states()
    ids = [(r, i) for r in range(fixtures.ROUNDS) for i in range(fixtures.N)]
    want = [js.path(JT.VertexID(*a), JT.VertexID(*b), strong_only) for a in ids for b in ids]
    got = [ts.path(TT.VertexID(*a), TT.VertexID(*b), strong_only) for a in ids for b in ids]
    assert got == want
    assert any(want) and not all(want)


def test_dag_state_strong_stack_and_snapshot_equal():
    js, ts = fig1_states()
    for hi in range(1, fixtures.ROUNDS):
        for lo in range(hi):
            np.testing.assert_array_equal(ts.strong_stack(hi, lo), js.strong_stack(hi, lo))
    for a, b in zip(ts.dense_snapshot(), js.dense_snapshot()):
        np.testing.assert_array_equal(a, b)
    assert ts.max_round == js.max_round
    assert [ts.round_size(r) for r in range(fixtures.ROUNDS)] == [
        js.round_size(r) for r in range(fixtures.ROUNDS)
    ]
    assert ts.quorum_frontier(3) == js.quorum_frontier(3)


# --- leader_reach_np ---------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_leader_reach_np_equal_on_random_stacks(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(4, 17))
    k = int(rng.integers(1, 6))
    stack = rng.random((k, n, n)) < 0.4
    for hi in range(n):
        got = tdk.leader_reach_np(stack, hi)
        assert got.dtype == bool
        np.testing.assert_array_equal(got, jdk.leader_reach_np(stack, hi))
    # and the JAX package's jitted kernels: the full chain product, row by row
    got = np.stack([tdk.leader_reach_np(stack, hi) for hi in range(n)])
    np.testing.assert_array_equal(got, np.asarray(jdk.reach_chain(stack)))
    for hi in (0, n - 1):
        np.testing.assert_array_equal(got[hi], np.asarray(jdk.leader_reach(stack, hi)))


# --- codec --------------------------------------------------------------------------


def _messages(T):
    rng = random.Random(7)
    cert = T.RoundCertificate(
        round=5, signers=(0, 2, 3), digests=tuple(rng.randbytes(64) for _ in range(3)),
        agg_sig=rng.randbytes(48),
    )
    span = T.SpanCertificate(
        first_round=5, signers=((0, 2, 3), (1, 2, 3)),
        digests=(tuple(rng.randbytes(64) for _ in range(3)),
                 tuple(rng.randbytes(64) for _ in range(3))),
        agg_sig=rng.randbytes(48),
    )
    verts = [
        T.Vertex(id=T.VertexID(0, 1)),
        T.Vertex(
            id=T.VertexID(6, 2),
            block=T.Block((b"", rng.randbytes(33), rng.randbytes(300))),
            strong_edges=(T.VertexID(5, 0), T.VertexID(5, 1), T.VertexID(5, 3)),
            weak_edges=(T.VertexID(2, 3),),
            signature=rng.randbytes(64),
            coin_share=rng.randbytes(48),
            cert_sig=rng.randbytes(48),
        ),
    ]
    msgs = []
    for epoch in (0, 3):
        msgs += [
            T.BroadcastMessage(vertex=verts[1], round=6, sender=2, epoch=epoch),
            T.BroadcastMessage(vertex=None, round=6, sender=1, kind="echo", origin=2,
                               digest=verts[1].digest(), epoch=epoch),
            T.BroadcastMessage(vertex=None, round=6, sender=3, kind="ready", origin=2,
                               digest=verts[1].digest(), epoch=epoch),
            T.BroadcastMessage(vertex=None, round=6, sender=0, kind="fetch", origin=2,
                               digest=verts[1].digest(), epoch=epoch),
            T.BroadcastMessage(vertex=verts[0], round=0, sender=1, kind="sync", epoch=epoch),
            T.BroadcastMessage(vertex=None, round=9, sender=1, kind="sync_nack", epoch=epoch),
            T.BroadcastMessage(vertex=None, round=5, sender=0, kind="cert", cert=cert,
                               epoch=epoch),
            T.BroadcastMessage(vertex=None, round=5, sender=0, kind="cert", epoch=epoch),
            T.BroadcastMessage(vertex=None, round=6, sender=0, kind="cert_span", span=span,
                               epoch=epoch),
        ]
    ops = [T.EpochOp("join", 5, 1, b"seed"), T.EpochOp("rotate"), T.EpochOp("leave", 2, 9)]
    lane = T.LaneRef(producer=1, seq=4, digest=rng.randbytes(32), count=3, nbytes=900,
                     signers=(0, 1, 3), agg_sig=rng.randbytes(48))
    return verts, msgs, cert, span, ops, lane


def test_codec_bytes_equal_both_ways():
    jv, jm, jc, js, jo, jl = _messages(JT)
    tv, tm, tc, ts, to, tl = _messages(TT)
    for a, b in zip(jv, tv):
        jb = jcodec.encode_vertex(a)
        assert tcodec.encode_vertex(b) == jb
        dec, off = tcodec.decode_vertex(jb)
        assert off == len(jb) and dec == b and dec.digest() == a.digest()
        assert jcodec.decode_vertex(tcodec.encode_vertex(b))[0] == a
    for a, b in zip(jm, tm):
        jb = jcodec.encode_message(a)
        assert tcodec.encode_message(b) == jb
        dec, off = tcodec.decode_message(jb)
        assert off == len(jb) and dec == b
    assert tcodec.encode_many(tm) == jcodec.encode_many(jm)
    assert tcodec.decode_many(jcodec.encode_many(jm)) == tm
    assert tcodec.encode_certificate(tc) == jcodec.encode_certificate(jc)
    assert tcodec.encode_span_certificate(ts) == jcodec.encode_span_certificate(js)
    for a, b in zip(jo, to):
        jb = jcodec.encode_epoch_op(a)
        assert tcodec.encode_epoch_op(b) == jb
        assert tcodec.decode_epoch_op(jb) == b
        assert tcodec.epoch_op_of(jb) == b
    assert tcodec.EPOCH_MAGIC == jcodec.EPOCH_MAGIC
    jb = jcodec.encode_lane_ref(jl)
    assert tcodec.encode_lane_ref(tl) == jb and tcodec.decode_lane_ref(jb) == tl
    payload = jcodec.encode_many(jm)
    assert tcodec.frame(payload) == jcodec.frame(payload)
    assert tcodec.read_frame(jcodec.frame(payload)) == jcodec.read_frame(jcodec.frame(payload))


# --- Config ----------------------------------------------------------------------------


def _fields(cls):
    return [
        (f.name, f.default if f.default is not dataclasses.MISSING else f.default_factory())
        for f in dataclasses.fields(cls)
    ]


@pytest.mark.parametrize("name", ["Config", "MempoolConfig"])
def test_config_fields_and_defaults_equal(name):
    jcls, tcls = getattr(jconfig, name), getattr(tconfig, name)
    assert _fields(tcls) == _fields(jcls)
    # and every field once resolved (env-backed defaults included)
    assert dataclasses.asdict(tcls()) == dataclasses.asdict(jcls())


def test_config_accepts_every_jax_field_with_equal_values():
    fields = {
        "n": 7, "f": 2, "wave_length": 4, "coin": "threshold_bls", "propose_empty": False,
        "max_rounds": 32, "sync_patience": 3, "gc_depth": 24, "pump": "scalar",
        "cert": "agg", "cert_span": 2, "wave_pipeline": True, "eager_deliver": True,
        "epoch": True, "epoch_waves": 3, "epoch_rotate": "seed",
    }
    j, t = jconfig.Config(**fields), tconfig.Config(**fields)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.quorum == j.quorum and t.wave_round(3, 2) == j.wave_round(3, 2)
    assert [t.wave_of_round(r) for r in range(1, 20)] == [j.wave_of_round(r) for r in range(1, 20)]


def test_knob_registry_equal():
    assert list(tconfig.KNOBS) == list(jconfig.KNOBS)
    for name, jk in jconfig.KNOBS.items():
        tk = tconfig.KNOBS[name]
        assert (tk.kind, tk.default, tk.choices) == (jk.kind, jk.default, jk.choices), name
    with pytest.raises(KeyError):
        tconfig.env_int("DAGRIDER_NOT_A_KNOB")


@pytest.mark.parametrize("bad", [
    {"n": 0}, {"n": 4, "f": 2}, {"wave_length": 0}, {"coin": "nope"},
    {"signature_scheme": "rsa"}, {"verifier_backend": "gpu"}, {"pump": "turbo"},
    {"cert": "on"}, {"cert_patience": 0}, {"cert_span": -1}, {"gc_depth": 1},
    {"lane_workers": 0}, {"lane_batch_bytes": 0}, {"epoch_waves": 0}, {"epoch_gc": -1},
    {"epoch_rotate": "vote"},
])
def test_config_validation_errors_equal(bad):
    with pytest.raises(ValueError) as je:
        jconfig.Config(**bad)
    with pytest.raises(ValueError) as te:
        tconfig.Config(**bad)
    assert str(te.value) == str(je.value)


def test_config_env_knob_read_by_both(monkeypatch):
    monkeypatch.setenv("DAGRIDER_PUMP", "scalar")
    assert tconfig.Config().pump == jconfig.Config().pump == "scalar"
    monkeypatch.setenv("DAGRIDER_PUMP", "warp")
    for config in (jconfig, tconfig):
        with pytest.raises(ValueError, match="DAGRIDER_PUMP"):
            config.Config()


# --- Bracha RBC (the recipes of tests/test_rbc.py) ------------------------------------


def _rbc_cluster(Broker, Rbc, n=4, f=1):
    broker = Broker()
    rbcs, sinks = [], []
    for i in range(n):
        rbc = Rbc(broker, i, n, f)
        sink = []
        rbc.subscribe(i, sink.append)
        rbcs.append(rbc)
        sinks.append(sink)
    return broker, rbcs, sinks


def _rbc_vertex(T, payload):
    return T.Vertex(
        id=T.VertexID(1, 0), block=T.Block((payload,)),
        strong_edges=(T.VertexID(0, 0), T.VertexID(0, 1), T.VertexID(0, 2)),
    )


def _honest(T, Broker, Rbc):
    broker, rbcs, sinks = _rbc_cluster(Broker, Rbc)
    rbcs[0].broadcast(T.BroadcastMessage(vertex=_rbc_vertex(T, b"tx"), round=1, sender=0))
    broker.pump()
    return sinks


def _equivocation(T, Broker, Rbc):
    broker, rbcs, sinks = _rbc_cluster(Broker, Rbc)
    va, vb = _rbc_vertex(T, b"A"), _rbc_vertex(T, b"B")
    broker.enqueue(1, T.BroadcastMessage(vertex=va, round=1, sender=0))
    for dest in (2, 3):
        broker.enqueue(dest, T.BroadcastMessage(vertex=vb, round=1, sender=0))
    broker.broadcast(T.BroadcastMessage(vertex=None, round=1, sender=0, kind="echo",
                                        origin=0, digest=vb.digest()))
    broker.pump()
    return sinks


@pytest.mark.parametrize("recipe", [_honest, _equivocation], ids=["honest", "equivocation"])
def test_rbc_recipes_deliver_equal_messages(recipe):
    want = recipe(JT, JBroker, JRbc)
    got = recipe(TT, TBroker, TRbc)
    as_bytes = lambda sinks, codec: [[codec.encode_message(m) for m in s] for s in sinks]  # noqa: E731
    assert as_bytes(got, tcodec) == as_bytes(want, jcodec)
    assert any(got)


def test_rbc_consensus_pipeline_equal():
    logs = []
    for config, Simulation in ((jconfig, JSimulation), (tconfig, TSimulation)):
        sim = Simulation(config.Config(n=4, coin="round_robin", propose_empty=False), rbc=True)
        sim.submit_blocks(per_process=6)
        sim.run(max_messages=30_000)
        sim.check_agreement()
        assert sum(p.metrics.counters["msgs_ignored_kind"] for p in sim.processes) == 0
        logs.append((
            [[(v.id.round, v.id.source, v.digest()) for v in d] for d in sim.deliveries],
            [p.decided_wave for p in sim.processes],
        ))
    assert logs[1] == logs[0]
    assert any(logs[0][0]) and max(logs[0][1]) >= 1
