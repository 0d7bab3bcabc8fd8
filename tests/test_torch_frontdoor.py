"""The host layer as a whole: a mempool-fronted cluster with dissemination lanes
and DKG key rotation, the port's ``Simulation`` against the JAX one.

n = 4, the threshold-BLS coin, ``lanes=True`` (256-byte batch floor, so
the mempool's 512-byte blocks take the lanes), ``epoch=True`` with
``epoch_rotate="dkg"`` and 4-wave epochs, one committed ``rotate`` op,
client load through ``ClusterLoadDriver`` on the virtual clock, the
wall-clock sync cooldowns pinned to 0 and the drain run without a wall
budget. The port's coins combine through the plain torch MSM on the CPU
(``device="cpu"``), the JAX package's on the host; both share one
oracle's books (``chip_smoke.shared_coin_factory``), so each wave is
combined once. Every view's ``(round, source, digest)`` log, the
delivered transactions, the load report, each process's decided wave,
epoch and group key must be equal, every process must have rotated its
keys through the resharing, and the audit must show no loss and no
duplicate.
"""

import sys
import types
from pathlib import Path

from dag_rider_tpu.config import Config as JConfig, MempoolConfig as JMempoolConfig
from dag_rider_tpu.consensus.coin import ThresholdCoin as JCoin
from dag_rider_tpu.consensus.simulator import Simulation as JSimulation
from dag_rider_tpu.core import codec as jcodec
from dag_rider_tpu.core.types import Block as JBlock, EpochOp as JEpochOp
from dag_rider_tpu.crypto import threshold as jth
from dag_rider_tpu.mempool import loadgen as jload
from dag_rider_tpu_torch.config import Config as TConfig, MempoolConfig as TMempoolConfig
from dag_rider_tpu_torch.consensus.coin import ThresholdCoin as TCoin
from dag_rider_tpu_torch.consensus.simulator import Simulation as TSimulation
from dag_rider_tpu_torch.core import codec as tcodec
from dag_rider_tpu_torch.core.types import Block as TBlock, EpochOp as TEpochOp
from dag_rider_tpu_torch.crypto import threshold as tth
from dag_rider_tpu_torch.mempool import loadgen as tload

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import shared_coin_factory  # noqa: E402

JAX = types.SimpleNamespace(Config=JConfig, MempoolConfig=JMempoolConfig, Simulation=JSimulation,
                            Coin=JCoin, codec=jcodec, Block=JBlock, EpochOp=JEpochOp, th=jth,
                            load=jload, coin_kw={}, sim_kw={})
PORT = types.SimpleNamespace(Config=TConfig, MempoolConfig=TMempoolConfig, Simulation=TSimulation,
                             Coin=TCoin, codec=tcodec, Block=TBlock, EpochOp=TEpochOp, th=tth,
                             load=tload, coin_kw=dict(device="cpu"), sim_kw=dict(device="cpu"))
N = 4


def run(pkg):
    cfg = pkg.Config(n=N, coin="threshold_bls", propose_empty=True, gc_depth=24, lanes=True,
                     lane_batch_bytes=256, epoch=True, epoch_waves=4, epoch_rotate="dkg",
                     sync_request_cooldown_s=0.0, sync_serve_cooldown_s=0.0)
    keys = pkg.th.ThresholdKeys.generate(N, cfg.f + 1, seed=b"front-door")
    make, oracle = shared_coin_factory(pkg.Coin, keys, N, **pkg.coin_kw)
    sim = pkg.Simulation(cfg, coin_factory=make, **pkg.sim_kw)
    op = pkg.codec.encode_epoch_op(pkg.EpochOp("rotate", 0, 9, b""))
    sim.processes[0].submit(pkg.Block((op,)))
    drv = pkg.load.ClusterLoadDriver(
        sim, pkg.load.LoadGenerator(clients=8, rate=2000.0, tx_bytes=64, seed=12),
        mcfg=pkg.MempoolConfig(cap=4096, batch_bytes=512, batch_deadline_ms=20.0), dt=0.02)
    rep = drv.run(0.1, drain_s=None)  # 5 load cycles: 8 waves, the boundary at wave 4
    sim.check_agreement()
    return sim, drv, rep, oracle


def test_front_door_lanes_dkg_equal_jax():
    jsim, jdrv, jrep, joracle = run(JAX)
    tsim, tdrv, trep, toracle = run(PORT)
    logs = [[(v.id.round, v.id.source, v.digest()) for v in d] for d in tsim.deliveries]
    assert logs == [[(v.id.round, v.id.source, v.digest()) for v in d] for d in jsim.deliveries]
    assert trep == jrep
    assert trep["audit"]["lost"] == 0 and trep["audit"]["duplicates"] == 0
    assert trep["committed_tx"] > 0
    for view in range(N):
        assert tdrv.delivered_txs(view) == jdrv.delivered_txs(view)
    assert toracle._sigma == joracle._sigma and toracle._sigma
    for tp, jp in zip(tsim.processes, jsim.processes):
        assert (tp.decided_wave, tp.epoch_mgr.epoch) == (jp.decided_wave, jp.epoch_mgr.epoch)
        assert tp.metrics.counters["epoch_rotations"] >= 1
        assert tp.coin.keys.group_pk == jp.coin.keys.group_pk
        assert tp.lanes is not None
    assert len({p.coin.keys.group_pk for p in tsim.processes}) == 1
    certified = sum(p.metrics.counters.get("lane_batches_certified", 0) for p in tsim.processes)
    assert certified > 0
