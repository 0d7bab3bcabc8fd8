"""The host modules' paths on the card at a small size: ``chip_smoke.py``'s
phases A-F with smaller committees and shorter loads.

A: the mempool front door at n = 16 (wall clock, 3 s of load) with the
shared ``CUDAVerifier`` and card-MSM threshold coins, and a traced rerun;
B: the mempool under chaos at n = 16, byte-identical to the host oracle;
C: dissemination lanes against inline payloads, every vertex verified on
the card; D: the Byzantine suite at n = 16 with the ``garbage_coin``
MSMs on the card; E: checkpoint round trip and attested snapshot join at
n = 16, the span pairings on the card; F: DKG key rotation at n = 4 with
the coins' MSM on the card. Each phase fails on any missed gate: logs
against their oracle, zero loss, exact launches, nothing contained.

These tests need a card and skip without one. They import no JAX:

    python -m pytest tests/test_torch_cuda_host.py -m cuda -p no:xdist --noconftest
"""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

pytestmark = pytest.mark.cuda

SMALL = {
    "A": dict(INGEST_N=16, INGEST_LOAD_S=3.0, INGEST_DRAIN_S=20.0, INGEST_TRACE_S=1.0,
              INGEST_TRACE_DRAIN_S=10.0),
    "B": dict(CHAOS_N=16, CHAOS_S=0.5),
    "C": dict(LANE_MATRIX=((4, 21, None, 12), (16, 23, "lane_withhold", 12))),
    "D": dict(BYZ_N=16, BYZ_PLAN=(
        {}, dict(adversary="equivocate", min_waves=1, min_each=0),
        dict(adversary="garbage_coin", cycles=2, min_waves=1, min_each=0))),
    "E": dict(SNAP_N=16),
    "F": {},
}
PHASES = {"A": "ingest_phase", "B": "chaos_phase", "C": "lanes_phase", "D": "byzantine_phase",
          "E": "snapshot_phase", "F": "rotate_phase"}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with -m cuda")
    from dag_rider_tpu_torch.utils import build

    build.build_all()


@pytest.mark.parametrize("letter", sorted(PHASES))
def test_phase_on_card(letter, card, monkeypatch):
    def fail(msg):
        raise AssertionError(msg)

    monkeypatch.setattr(cs, "fail", fail)
    for name, value in SMALL[letter].items():
        monkeypatch.setattr(cs, name, value)
    launches = getattr(cs, PHASES[letter])()
    assert launches["padd_xx"] == launches["pow22523"] == launches["field_mul"] == 0
    if letter in "ABCE":
        assert launches["tree_sum_xyzt"] == launches["finish_check"] > 0
    if letter in "ABDEF":
        assert launches["horner381"] > 0 and launches["padd381_xx"] > 0
