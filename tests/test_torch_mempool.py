"""The port's mempool front door against the JAX package's, exactly.

The same seeded load goes through ``mempool.loadgen`` of both packages:
``smoke()`` at n = 4, and virtual-clock ``ClusterLoadDriver`` runs over a
``FaultyTransport`` (delay and duplicate faults) and under overload (the
pool sheds). The report, the zero-loss audit, the submission log and
every view's delivered transactions must be equal, and the port's
``replay`` of the submission log must give the JAX ``replay``'s logs.
These are host modules, so the tolerance is zero. The recipes are those
of ``tests/test_mempool.py``, with the wall-clock sync cooldowns pinned
to 0 and the drain run without a wall budget, so nothing reads the wall
clock.
"""

import types

import pytest

from dag_rider_tpu.config import Config as JConfig, MempoolConfig as JMempoolConfig
from dag_rider_tpu.consensus.simulator import Simulation as JSimulation
from dag_rider_tpu.mempool import loadgen as jload
from dag_rider_tpu.transport import faults as jfaults
from dag_rider_tpu_torch.config import Config as TConfig, MempoolConfig as TMempoolConfig
from dag_rider_tpu_torch.consensus.simulator import Simulation as TSimulation
from dag_rider_tpu_torch.mempool import loadgen as tload
from dag_rider_tpu_torch.transport import faults as tfaults

JAX = types.SimpleNamespace(Config=JConfig, MempoolConfig=JMempoolConfig,
                            Simulation=JSimulation, load=jload, faults=jfaults)
PORT = types.SimpleNamespace(Config=TConfig, MempoolConfig=TMempoolConfig,
                             Simulation=TSimulation, load=tload, faults=tfaults)

SIM_CFG = dict(coin="round_robin", propose_empty=True, gc_depth=24,
               sync_request_cooldown_s=0.0, sync_serve_cooldown_s=0.0)

#: (name, transport fault plan or None, load generator, mempool config, seconds)
RECIPES = {
    "chaos": (dict(delay=0.05, duplicate=0.05, seed=2),
              dict(clients=8, rate=4000.0, seed=2, profile="burst"),
              dict(cap=512, batch_bytes=256, batch_deadline_ms=20.0), 1.0),
    "overload": (None,
                 dict(clients=8, rate=20_000.0, seed=3, profile="burst"),
                 dict(cap=256, batch_bytes=256, batch_deadline_ms=20.0, max_batch_txs=64), 1.0),
    "poisson_n7": (dict(delay=0.02, duplicate=0.02, seed=5),
                   dict(clients=14, rate=3000.0, seed=11, profile="poisson"),
                   dict(cap=4096, batch_bytes=256, batch_deadline_ms=20.0), 0.6),
}


def _drive(pkg, name, n):
    plan, gen_kw, mcfg_kw, seconds = RECIPES[name]
    transport = pkg.faults.FaultyTransport(pkg.faults.FaultPlan(**plan)) if plan else None
    sim = pkg.Simulation(pkg.Config(n=n, **SIM_CFG), transport=transport)
    drv = pkg.load.ClusterLoadDriver(sim, pkg.load.LoadGenerator(tx_bytes=32, **gen_kw),
                                     mcfg=pkg.MempoolConfig(**mcfg_kw))
    rep = drv.run(seconds, drain_s=None)
    sim.check_agreement()
    return sim, drv, rep


def _log(drv):
    return [(c, i, b.transactions) for c, i, b in drv.submission_log]


def _views(sim):
    return [[(v.id.round, v.id.source, v.block.transactions) for v in d] for d in sim.deliveries]


@pytest.mark.parametrize("seed,profile", [(7, "burst"), (4, "poisson"), (9, "uniform")])
def test_smoke_equals_jax(seed, profile):
    kw = dict(n=4, seconds=1.0, rate=2000.0, seed=seed, profile=profile)
    assert tload.smoke(**kw) == jload.smoke(**kw)


@pytest.mark.parametrize("name,n", [("chaos", 4), ("overload", 4), ("poisson_n7", 7)])
def test_cluster_load_equals_jax(name, n):
    jsim, jdrv, jrep = _drive(JAX, name, n)
    tsim, tdrv, trep = _drive(PORT, name, n)
    assert trep == jrep
    assert trep["audit"]["lost"] == 0 and trep["audit"]["duplicates"] == 0
    assert trep["committed_tx"] > 0
    if name == "overload":
        assert trep["shed_tx"] > 0
    else:
        assert tsim.transport.stats["delayed"] > 0
        assert dict(tsim.transport.stats) == dict(jsim.transport.stats)
    assert _log(tdrv) == _log(jdrv)
    assert tdrv.accepted == jdrv.accepted
    for view in range(n):
        assert tdrv.delivered_txs(view) == jdrv.delivered_txs(view)
    assert _views(tsim) == _views(jsim)
    assert [mp.stats() for mp in tdrv.mempools] == [mp.stats() for mp in jdrv.mempools]

    # the legacy one-block path fed the same schedule: equal across packages
    jre = JSimulation(JConfig(n=n, **SIM_CFG))
    tre = TSimulation(TConfig(n=n, **SIM_CFG))
    jload.replay(jre, jdrv.submission_log)
    tload.replay(tre, tdrv.submission_log)
    tre.check_agreement()
    assert any(tre.deliveries)
    assert _views(tre) == _views(jre)
