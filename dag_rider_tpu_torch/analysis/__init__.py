"""driderlint — project-invariant static analysis + race detection.

The byte-identity A/B tests and the chaos suite check *behavior*; this
package checks the *invariants those tests silently assume*, the way
"Reusable Formal Verification of DAG-based Consensus Protocols"
(arXiv 2407.02167) argues DAG-BFT correctness should be carried by
reusable machine-checked properties rather than per-change testing. The
reference Go prototype got ``go vet`` and ``-race`` for free; this is
the Python port's equivalent, specialized to THIS repo's seams:

- ``knobs``       — every DAGRIDER_* env read routes through the
                    config.py registry and appears in the README table
- ``determinism`` — no wall clock, unseeded RNG, or set-iteration-order
                    dependence on consensus commit paths
- ``oracle``      — vector-pump / agg-cert-only code never mutates the
                    scalar reference path's state (what every A/B
                    byte-identity test assumes)
- ``metrics``     — every counter bumped is registered in
                    utils/metrics.KNOWN_COUNTERS
- ``jitpure``     — no Python side effects inside CUDA-graph-captured
                    regions of ops/ and parallel/ (the reference's
                    jitted functions)
- ``races``       — a runtime harness: lock-order cycle detection +
                    guarded-field / serialized-method enforcement,
                    driven by the existing chaos/fuzz suites under
                    DAGRIDER_RACE=1

Run the static suite with ``python -m dag_rider_tpu_torch.analysis``; it
scans ``dag_rider_tpu_torch/`` and ``chip_smoke.py``. ``jitpure`` and
``shapes`` check what a CUDA graph captures where the reference's check
``jax.jit`` bodies. Every checker is proven non-vacuous by the planted
violations of tests/test_torch_analysis.py: the reference's run through
both packages, and the port's own for the two capture checkers.
"""

from dag_rider_tpu_torch.analysis.core import Allow, Finding, discover, run_static

__all__ = ["Allow", "Finding", "discover", "run_static"]
