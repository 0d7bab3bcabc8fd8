"""The control of the benchmark's correctness check.

The control is the plain reference put in the program's place with one
guarantee that the configuration states broken: it keeps the decoding of
A and R and the s < L check, and drops the group equation, so a signature
no longer binds the vertex's bytes. Honest rows still come out accepted;
the rows whose message was altered after signing come out accepted too.
The harness's comparison has to call such a run not correct.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...] [--seconds <s>]

runs the cell's own traffic at its own size through the harness with the
control in the program's place, one run a seed, prints each run's
compared numbers, and exits 0 when every run came out not correct. The
benchmark's own runs never run it.
"""

import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
sys.path.insert(0, ROOT)


class ControlProgram:
    """The control behind the window's entry: ``run_coalesced`` over chunks
    of ``chunk`` rows, with the counters the harness reads."""

    def __init__(self, registry, chunk: int):
        from portbench import ed25519_ref as E

        self._keys = [E.decompress(pk) is not None for pk in registry.public_keys]
        self._chunk = chunk
        self.wait_s = self.seam_s = 0.0
        self.dispatches = self.sigs_dispatched = 0
        self.poisoned_windows = self.quarantined = 0

    def _row(self, v) -> bool:
        from portbench import ed25519_ref as E

        sig = v.signature
        return (0 <= v.source < len(self._keys) and self._keys[v.source]
                and E.decompress(sig[:32]) is not None
                and int.from_bytes(sig[32:], "little") < E.L)

    def run_coalesced(self, vertices):
        t0 = time.perf_counter()
        mask = []
        for lo in range(0, len(vertices), self._chunk):
            chunk = vertices[lo : lo + self._chunk]
            mask.extend(self._row(v) for v in chunk)
            self.dispatches += 1
            self.sigs_dispatched += len(chunk)
        self.seam_s += time.perf_counter() - t0
        return mask


def control_program(registry, chunk: int, device: str):
    return ControlProgram(registry, chunk)


def main(argv=None) -> int:
    import argparse
    import json

    from portbench import harness, workgen
    from portbench.run import apply_knobs

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    cell = workgen.load_cell(bench, args.workload)
    apply_knobs(cell.config)  # importing run cleared every other knob
    caught = 0
    for seed in args.seeds:
        out = harness.run(cell, [], [], seed, args.seconds, False, device="cpu",
                          program=control_program)
        checks = " ".join(f"{k} {c['value']} limit {c['limit']}" for k, c in out["checks"].items())
        line = (f"control {args.workload} seed {seed}: correct {out['correct']}, "
                f"{out['attempted']} requests, {out['failed']} failed; {checks}")
        print(line, flush=True)
        print(line, file=sys.stderr, flush=True)
        caught += not out["correct"]
    return 0 if caught == len(args.seeds) else 1


if __name__ == "__main__":
    sys.exit(main())
