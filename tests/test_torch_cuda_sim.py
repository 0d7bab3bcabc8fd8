"""The port's ``Simulation`` on the card against its host-oracle run.

An n = 16 committee runs DAG-Rider with the named ``"device"`` verifier
(one shared ``CUDAVerifier`` on ``cuda``, coalesced and pipelined) and
threshold-BLS coins whose MSM runs on the card, then again with the host
oracles (``verifier="cpu"``, ``msm="host"``) and the same sequence of
``run`` calls. Every view's ``(round, source, digest)`` log, each wave's
group signature and every ``decided_wave`` must be equal; the comb kernels
launch once per pipeline dispatch, the MSM kernels exactly as the coin's
MSMs require, and the pipeline contains nothing.

These tests need a card and skip without one. They import no JAX, so
they run on a machine without it:

    python -m pytest tests/test_torch_cuda_sim.py -m cuda -p no:xdist --noconftest
"""

import sys
from pathlib import Path

import pytest
import torch

from dag_rider_tpu_torch import Config
from dag_rider_tpu_torch.consensus.coin import ThresholdCoin
from dag_rider_tpu_torch.consensus.simulator import Simulation
from dag_rider_tpu_torch.crypto import threshold as th
from dag_rider_tpu_torch.ops import bls_msm, cuda_group as CG, cuda_group381 as G

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import msm_launches, shared_coin_factory  # noqa: E402

pytestmark = pytest.mark.cuda

N = 16
WAVES = 3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m cuda")
    return torch.device("cuda")


def _build(keys, verifier, msm):
    cfg = Config(n=N, coin="threshold_bls", propose_empty=True, gc_depth=24)
    make, oracle = shared_coin_factory(ThresholdCoin, keys, N, msm=msm)
    sim = Simulation(cfg, verifier=verifier, coin_factory=make)
    sim.submit_blocks(per_process=2)
    return sim, oracle


def _drive(sim, calls=None):
    monitor = sim.attach_invariant_monitor()
    done = 0
    while (done < calls) if calls is not None else (
        min(p.decided_wave for p in sim.processes) < WAVES and done < 40
    ):
        sim.run(max_messages=N * (N - 1))
        done += 1
    sim.check_agreement()
    assert monitor.observed > 0
    return done


def test_card_simulation_equals_host_oracle(dev):
    keys = th.ThresholdKeys.generate(N, N // 3 + 1, seed=b"cuda-sim")
    sizes = []

    def card_msm(scalars, points):
        sizes.append(len(points))
        return bls_msm.msm(scalars, points)

    card, card_oracle = _build(keys, "device", card_msm)
    # the comb tables are built before the run (two table kernels, not counted here)
    card.processes[0].verifier.comb_tables()
    torch.cuda.synchronize()
    CG.reset_launches()
    G.reset_launches()
    calls = _drive(card)
    torch.cuda.synchronize()
    launches = {**CG.LAUNCHES, **G.LAUNCHES}
    pipe = card._verify_pipe
    assert min(p.decided_wave for p in card.processes) >= WAVES
    assert pipe.dispatches > 0 and sizes
    assert launches == {"padd_xx": 0, "tree_sum_xyzt": pipe.dispatches,
                        "finish_check": pipe.dispatches, "pow22523": 0,
                        **msm_launches(sizes)}
    rs = pipe.resilience_stats()
    assert (rs["poisoned_windows"], rs["quarantined"], rs["quarantine_rejected"]) == (0, 0, 0)

    host, host_oracle = _build(keys, "cpu", "host")
    _drive(host, calls)
    logs = [[(v.id.round, v.id.source, v.digest()) for v in d] for d in card.deliveries]
    assert any(logs)
    assert logs == [[(v.id.round, v.id.source, v.digest()) for v in d] for d in host.deliveries]
    assert card_oracle._sigma == host_oracle._sigma and card_oracle._sigma
    assert [p.decided_wave for p in card.processes] == [p.decided_wave for p in host.processes]
