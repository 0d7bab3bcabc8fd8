"""The port's Byzantine suite against the JAX package's, exactly.

``run_scenario(Scenario(...), device="cpu")`` of the port and the JAX
``run_scenario`` on the same scenario: every adversary of ``ADVERSARIES``
(and the clean run) under the ``lan`` and ``wan`` profiles at n = 4, and
a few at n = 7. ``run_scenario`` raises on any broken invariant, in both
packages. The report's fields (logs' lengths, waves, rounds, detection
counters, the audit, the transport's fault counts, the behaviour's
books) must be equal. ``garbage_coin`` runs the threshold-BLS coin, whose
combine takes the port's MSM on the CPU (``device="cpu"``: the plain
torch path, ~1.5 s an MSM here), so its runs are cut to one or two
load cycles (``bench.py``'s byzantine rung cuts it to 4), and the
filter must have dropped a share.

One pair is not compared field by field: ``equivocate`` under ``wan``
forces Bracha broadcast over jittery links, and the JAX package's own
reports for it differ from run to run in one process (rounds, sync and
fault counts). There both packages must hold every invariant, forge
variants, run Bracha and agree on the scenario's resolution.
"""

import pytest

from dag_rider_tpu.consensus.scenarios import Scenario as JScenario, run_scenario as jrun
from dag_rider_tpu_torch.consensus.adversary import ADVERSARIES
from dag_rider_tpu_torch.consensus.scenarios import Scenario as TScenario, run_scenario as trun

CUT = {"garbage_coin": {"lan": dict(cycles=1, min_waves=1, min_each=0),
                        "wan": dict(cycles=2, min_waves=1, min_each=0)}}

CASES = [(4, a, wan) for a in (None, *ADVERSARIES) for wan in ("lan", "wan")] + [
    (7, None, "lan"), (7, "equivocate_split", "wan"), (7, "withhold", "lan"),
    (7, "invalid_edges", "wan"), (7, "lane_withhold", "lan"), (7, "stale_epoch", "wan"),
]
#: pairs whose JAX report is not a function of the scenario alone
UNSTABLE = {(4, "equivocate", "wan")}


def test_the_suite_covers_every_adversary():
    assert set(ADVERSARIES) == {a for _, a, _ in CASES} - {None}
    assert len(ADVERSARIES) == 8


@pytest.mark.parametrize("n,adversary,wan", CASES)
def test_scenario_report_equals_jax(n, adversary, wan):
    kw = dict(n=n, adversary=adversary, wan=wan, seed=0, **CUT.get(adversary, {}).get(wan, {}))
    want = jrun(JScenario(**kw))
    got = trun(TScenario(**kw), device="cpu")
    if (n, adversary, wan) in UNSTABLE:
        for k in ("n", "f", "byzantine", "rbc", "coin", "lanes", "adversary", "wan"):
            assert got[k] == want[k], k
        assert got["rbc"] is True
        assert got["behavior"]["mutated"] > 0 and want["behavior"]["mutated"] > 0
    else:
        assert got == want
    assert got["audit"]["lost"] == 0 and got["audit"]["duplicates"] == 0
    if adversary is not None:
        assert sum(got["behavior"].values()) > 0, "the adversary never acted"
    if adversary == "garbage_coin":
        assert got["coin"] == "threshold_bls" and got["coin_filtered"] > 0
