"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``, this
folder and the ``dag_rider_tpu_torch`` package. It drives the package on
one CUDA card and prints, as the last line of standard output, one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` a ``breakdown``, and last ``checks``, each
number compared beside its limit. The checks are also the last lines of
standard error. Without a card, or when JAX was loaded, it exits non-zero
and prints no result.

The run clears every ``DAGRIDER_*`` variable, then sets the knobs that the
cell's configuration names (``knobs``), so the program runs at its
defaults but for those; it keeps the host libraries to one thread. The
program builds its kernels with nvcc under ``build/`` in the checkout.
"""

import os
import sys
import time

T0 = time.perf_counter()

# this file's folder would otherwise shadow top-level modules by its own
# files' names; the checkout's root holds the program and this package
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
sys.path.insert(0, ROOT)

for _k in [k for k in os.environ if k.startswith("DAGRIDER_")]:
    del os.environ[_k]
for _k in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_k] = "1"

FORBIDDEN = {"jax", "jaxlib", "flax", "dag_rider_tpu"}


def loaded_forbidden() -> list:
    """Modules whose top-level name, compared whole, is JAX's or the JAX
    package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def apply_knobs(cfg: dict) -> None:
    """Set the program's knobs that the configuration names, before the
    program is imported, and say which on standard error."""
    knobs = cfg.get("knobs", {})
    os.environ.update(knobs)
    print(f"portbench: knobs {dict(sorted(knobs.items()))}", file=sys.stderr, flush=True)


def cell_metrics(bench: dict, section: str, workload: str) -> list:
    return [m for m in bench[section] if workload in m.get("workloads", [workload])]


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness, workgen

    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    cell = workgen.load_cell(bench, args.workload)
    apply_knobs(cell.config)
    chips = next(w["chips"] for w in bench["workloads"] if w["name"] == args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = harness.run(cell, cell_metrics(bench, "end_to_end", args.workload),
                      cell_metrics(bench, "per_layer", args.workload),
                      args.seed, args.seconds, bool(args.trace), t0=T0)
    found = loaded_forbidden()
    if found:
        print(f"portbench: JAX or the JAX package was loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, check in out["checks"].items():
        print(f"check {name} {check['value']} limit {check['limit']}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
