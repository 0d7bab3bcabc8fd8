"""``python -m dag_rider_tpu_torch.analysis`` — run driderlint over the repo.

Exit 0: clean (suppressed findings are reported for transparency).
Exit 1: violations, allowlist entries that suppress nothing, or the
``--budget-s`` wall-time budget blown (driderlint gates every PR, so
it must stay cheap; a checker that quietly grows quadratic gets caught
here, not in everyone's CI latency).

``--with-external`` additionally runs ruff and mypy (pinned configs in
pyproject.toml) when they are importable; absent tools are reported as
skipped, never as failures (the card's machine ships neither). mypy GATES on the strict per-module list
(config.py, analysis/, core/, utils/metrics.py — the modules pyproject
marks strict) and stays advisory on the rest.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import subprocess
import sys
import time

from dag_rider_tpu_torch.analysis.core import run_static

#: modules where mypy findings gate (pyproject [[tool.mypy.overrides]]
#: pins the strictness for exactly this list)
MYPY_GATED = (
    "dag_rider_tpu_torch/config.py",
    "dag_rider_tpu_torch/analysis",
    "dag_rider_tpu_torch/core",
    "dag_rider_tpu_torch/utils/metrics.py",
)

#: still checked, failures reported but not gating (yet)
MYPY_ADVISORY = ("dag_rider_tpu_torch/consensus",)


def _repo_root() -> str:
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(here))


def _run_external(repo_root: str) -> int:
    """ruff + gated mypy when installed; 0 if gate-clean."""
    rc = 0
    if importlib.util.find_spec("ruff") is not None:
        print("== ruff ==")
        proc = subprocess.run(
            [sys.executable, "-m", "ruff", "check", "."],
            cwd=repo_root,
        )
        rc |= proc.returncode
    else:
        print("== ruff == not installed (skipped)")
    if importlib.util.find_spec("mypy") is not None:
        print("== mypy (gating) ==")
        proc = subprocess.run(
            [sys.executable, "-m", "mypy", *MYPY_GATED],
            cwd=repo_root,
        )
        rc |= proc.returncode
        print("== mypy (advisory) ==")
        subprocess.run(
            [sys.executable, "-m", "mypy", *MYPY_ADVISORY],
            cwd=repo_root,
        )
    else:
        print("== mypy == not installed (skipped)")
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m dag_rider_tpu_torch.analysis")
    ap.add_argument(
        "--with-external",
        action="store_true",
        help="also run ruff/mypy when installed",
    )
    ap.add_argument(
        "--root", default=None, help="repo root (default: auto-detected)"
    )
    ap.add_argument(
        "--budget-s",
        type=float,
        default=0.0,
        help="fail if the static checkers exceed this wall time (0: off)",
    )
    args = ap.parse_args(argv)
    root = args.root or _repo_root()

    t0 = time.monotonic()
    kept, suppressed, unused = run_static(root)
    elapsed = time.monotonic() - t0
    print(f"driderlint over {root} ({elapsed:.2f}s)")
    for f in suppressed:
        print(f"  allowed  {f}")
    for f in kept:
        print(f"  VIOLATION  {f}")
    for a in unused:
        print(
            f"  STALE ALLOW  [{a.checker}] {a.path} contains "
            f"{a.contains!r} — suppresses nothing; delete it"
        )
    rc = 1 if (kept or unused) else 0
    if args.budget_s and elapsed > args.budget_s:
        print(
            f"  BUDGET  static checkers took {elapsed:.2f}s "
            f"> {args.budget_s:.0f}s budget — driderlint must stay "
            "cheap enough to gate every PR"
        )
        rc = 1

    if args.with_external:
        rc |= _run_external(root)

    if rc == 0:
        print(
            f"clean: 0 violations, {len(suppressed)} allowlisted, "
            "0 stale allows"
        )
    else:
        print(
            f"FAILED: {len(kept)} violation(s), {len(unused)} stale "
            "allowlist entr(ies)"
        )
    return rc


if __name__ == "__main__":
    sys.exit(main())
