"""The port's dissemination lanes against the JAX package's, exactly.

The identity matrix of ``tests/test_lanes.py`` at n = 4 and 7: each
recipe runs a cluster with lanes on in both packages and with lanes off
in the port, scalar and vector pumps. Per honest view, the commit order
``(round, source)`` and the SHA-256 of the delivered transaction bytes
(length-prefixed) must be equal across packages, and the port's lanes-on
run must equal its lanes-off run. The lane path must really have run
(certified or degraded batches) and the inline run must deliver
something. These are host modules, so the tolerance is zero.
"""

import hashlib
import types

import pytest

from dag_rider_tpu.config import Config as JConfig
from dag_rider_tpu.consensus.adversary import ByzantineProcess as JByz, make_behavior as jmake
from dag_rider_tpu.consensus.process import Process as JProcess
from dag_rider_tpu.consensus.simulator import Simulation as JSimulation
from dag_rider_tpu_torch.config import Config as TConfig
from dag_rider_tpu_torch.consensus.adversary import ByzantineProcess as TByz, make_behavior as tmake
from dag_rider_tpu_torch.consensus.process import Process as TProcess
from dag_rider_tpu_torch.consensus.simulator import Simulation as TSimulation

JAX = types.SimpleNamespace(Config=JConfig, Simulation=JSimulation, Process=JProcess,
                            Byz=JByz, make=jmake)
PORT = types.SimpleNamespace(Config=TConfig, Simulation=TSimulation, Process=TProcess,
                             Byz=TByz, make=tmake)

MATRIX = [
    (4, 11, None),
    (4, 12, "equivocate"),
    (4, 13, "withhold"),
    (7, 21, None),
    (7, 23, "lane_withhold"),
]


def run_cluster(pkg, n, seed, adversary, pump, lanes, cycles=30):
    """``tests/test_lanes.py``'s ``_run_cluster`` over either package, at
    30 cycles (the reference's 14 leave the withholding run one delivery)."""
    cfg = pkg.Config(n=n, coin="round_robin", propose_empty=True, pump=pump, lanes=lanes,
                     lane_batch_bytes=256, sync_request_cooldown_s=0.0,
                     sync_serve_cooldown_s=0.0, sync_patience=1)
    nbyz = cfg.f if adversary else 0
    behaviors = {i: pkg.make(adversary, seed=seed + 1000 + i) for i in range(nbyz)}

    def factory(pcfg, i, ptp, **kwargs):
        if i in behaviors:
            return pkg.Byz(pcfg, i, ptp, behavior=behaviors[i], **kwargs)
        return pkg.Process(pcfg, i, ptp, **kwargs)

    sim = pkg.Simulation(cfg, process_factory=factory if behaviors else None)
    sim.submit_blocks(2, tx_bytes=600)  # above the 256-byte lane floor
    for _ in range(cycles):
        sim.run(max_messages=n * (n - 1))
    return sim, nbyz


def fingerprint(sim, nbyz):
    """Per honest view: the commit order and the digest of the delivered
    transaction bytes (``tests/test_lanes.py:_delivery_fingerprint``)."""
    orders, digests = [], []
    for d in sim.deliveries[nbyz:]:
        orders.append([(v.id.round, v.id.source) for v in d])
        h = hashlib.sha256()
        for v in d:
            for tx in v.block.transactions:
                h.update(len(tx).to_bytes(4, "little"))
                h.update(tx)
        digests.append(h.hexdigest())
    return orders, digests


@pytest.mark.parametrize("pump", ["scalar", "vector"])
@pytest.mark.parametrize("n,seed,adversary", MATRIX)
def test_lanes_equal_jax_and_inline(n, seed, adversary, pump):
    jsim, nbyz = run_cluster(JAX, n, seed, adversary, pump, True)
    tsim, _ = run_cluster(PORT, n, seed, adversary, pump, True)
    inline, _ = run_cluster(PORT, n, seed, adversary, pump, False)
    got = fingerprint(tsim, nbyz)
    assert got == fingerprint(jsim, nbyz)
    assert got == fingerprint(inline, nbyz)
    assert any(got[0]), "the inline oracle delivered nothing"
    books = [sum(p.metrics.counters.get(k, 0) for p in sim.processes)
             for sim in (tsim, jsim)
             for k in ("lane_batches_certified", "lane_publish_degraded")]
    assert books[:2] == books[2:] and sum(books[:2]) > 0
