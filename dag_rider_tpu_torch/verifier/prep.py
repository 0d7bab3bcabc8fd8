"""Parallel host-prep engine.

The port's copy of ``dag_rider_tpu/verifier/prep.py``. The merged verify
dispatch is bound by its host half (``CUDAVerifier._prepare``, see
PERF.md §5): one Python thread feeding the card is the ceiling. This
module owns the two threading seams that lift that ceiling without
touching WHAT is computed:

- **row-block pool** — one prep call is partitioned into contiguous row
  blocks, each block running the full per-row pipeline (byte parsing,
  the s < L / r_y < p lexicographic compares, SHA-512 challenge
  scalars, limb/nibble packing) and writing its finished rows straight
  into the block's offsets of the caller-provided destination arrays —
  normally a staging-ring slot (`CUDAVerifier._stage`), so the parallel
  path adds NO extra copy and inherits the ring's aliasing discipline
  unchanged. Every per-row computation is row-local (see
  `CUDAVerifier._prep_block`), so any partition of [0, size) is
  byte-identical to the serial full-range call. The heavy kernels all
  drop the GIL: numpy ufuncs/matmuls internally, and the native
  `challenge_batch` for the whole duration of its ctypes call
  (utils/native.py) — threads, not processes, so workers can share the
  destination arrays zero-copy.
- **seam executor** — a single dedicated FIFO thread
  (:meth:`PrepEngine.submit`) that the pipeline callers
  (``VerifierPipeline.run_coalesced``, the chunk-streaming
  ``CUDAVerifier.verify_rounds``) queue whole `prep_batch` calls on:
  chunk k+2's prep runs concurrently with chunk k+1's prep (queued
  behind it) and chunk k's device execution, deepening the overlap the
  depth-K window already buys. One thread — never more — so
  staging-ring slots are still claimed strictly in chunk order and the
  ring's ``pipeline_depth + 2`` slots cover the at-most-2 outstanding
  preps plus the depth-K in-flight dispatches.

Knobs: ``DAGRIDER_PREP_WORKERS`` (env, default 1 = serial) and
``CUDAVerifier.prep_workers`` (attribute) for per-instance overrides.
Gauges (`workers`, `last_blocks`, `parallel_fraction`) surface through
``CUDAVerifier.prep_stats`` into pipeline stats and the per-process
metrics snapshot.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, List, Optional, Tuple

from dag_rider_tpu_torch import config

#: Smallest row block worth a thread handoff: below this the numpy
#: slices are so small that submit/wake costs exceed the work moved.
#: Also the floor bucket size (cuda._MIN_BUCKET), so sub-bucket
#: dispatches always take the serial path.
MIN_BLOCK_ROWS = 16


def default_prep_workers() -> int:
    """Worker count for the parallel host-prep engine:
    DAGRIDER_PREP_WORKERS, default 1 (serial — byte-identical by
    construction, and the right call on one-core hosts). N > 1 splits
    every big-enough prep into up to N row blocks."""
    return config.env_int("DAGRIDER_PREP_WORKERS")


class PrepEngine:
    """Row-block worker pool + FIFO seam executor for host prep.

    One engine per verifier (the staging ring it feeds is per-verifier
    state). ``workers`` is the total parallelism of one prep call: the
    calling thread always takes the first block, so the pool holds
    ``workers - 1`` threads and ``workers=1`` builds no pool at all —
    that configuration is structurally the serial code path, not a
    simulation of it.
    """

    def __init__(self, workers: Optional[int] = None):
        self.workers = (
            int(workers) if workers is not None else default_prep_workers()
        )
        if self.workers < 1:
            raise ValueError(f"prep workers must be >= 1, got {workers!r}")
        self._pool = (
            ThreadPoolExecutor(
                max_workers=self.workers - 1,
                thread_name_prefix="dagrider-prep",
            )
            if self.workers > 1
            else None
        )
        #: lazy single-thread FIFO executor for whole-prep-call
        #: overlap on the pipeline seam (see submit())
        self._seam: Optional[ThreadPoolExecutor] = None
        #: gauges — cumulative over the engine's lifetime. Guarded by
        #: _gauge_lock: run_blocks legitimately overlaps itself (the
        #: caller thread preps chunk k+1 while the seam thread preps
        #: k+2 into a DIFFERENT ring slot), so the read-modify-write
        #: bumps below race without it (the JAX package's race harness
        #: caught exactly this under tests/test_chaos.py).
        self._gauge_lock = threading.Lock()
        self.last_blocks = 1
        self.dispatches = 0
        self.dispatches_parallel = 0
        self.rows_total = 0
        self.rows_parallel = 0
        self.serial_retries = 0

    # -- row-block half ---------------------------------------------------

    def plan(self, size: int) -> List[Tuple[int, int]]:
        """Contiguous near-equal row blocks partitioning [0, size).

        Deterministic in (size, workers) — though byte-identity never
        depends on the partition, only on every row being covered
        exactly once. Small dispatches stay one block: splitting 16
        rows four ways is pure overhead."""
        blocks = (
            1 if self.workers <= 1 else min(self.workers, size // MIN_BLOCK_ROWS)
        )
        if blocks <= 1:
            return [(0, max(size, 0))]
        step = -(-size // blocks)  # ceil
        return [(lo, min(lo + step, size)) for lo in range(0, size, step)]

    def run_blocks(
        self,
        fn: Callable[[int, int], None],
        blocks: List[Tuple[int, int]],
    ) -> None:
        """Run ``fn(lo, hi)`` over every block; the calling thread takes
        the first block, the pool the rest. Blocks until all blocks are
        done.

        A PARALLEL failure is contained at this boundary: all
        outstanding blocks are waited out (never retried concurrently —
        they share the destination arrays), then the whole range is
        re-run serially ONCE. `_prep_block` fully overwrites its rows,
        so the serial pass is byte-identical no matter which blocks had
        partially written. Only if the serial pass also fails does the
        exception surface — the staging slot is then considered
        unwritten and the dispatch must not ship."""
        size = blocks[-1][1]
        with self._gauge_lock:
            self.dispatches += 1
            self.rows_total += size
            self.last_blocks = len(blocks)
        if len(blocks) == 1:
            fn(*blocks[0])
            return
        with self._gauge_lock:
            self.dispatches_parallel += 1
            self.rows_parallel += size
        futs = [self._pool.submit(fn, lo, hi) for lo, hi in blocks[1:]]
        failed = False
        try:
            fn(*blocks[0])
        except Exception:  # noqa: BLE001 — retried serially below
            failed = True
        for f in futs:
            try:
                f.result()
            except Exception:  # noqa: BLE001 — retried serially below
                failed = True
        if failed:
            with self._gauge_lock:
                self.serial_retries += 1
            fn(0, size)

    # -- pipeline-seam half ----------------------------------------------

    def submit(self, fn: Callable, *args) -> Future:
        """Queue a whole prep call on the engine's dedicated seam thread.

        Exactly one thread, FIFO: submission order IS staging-ring claim
        order, which the ring's aliasing discipline requires (a slot's
        previous dispatch must have resolved before the slot is claimed
        again — callers keep at most 2 preps outstanding and only submit
        a new one after draining the window below depth). The seam
        thread may itself fan out into the row-block pool; the two pools
        are disjoint, so the nesting cannot deadlock."""
        if self._seam is None:
            self._seam = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="dagrider-prep-seam"
            )
        return self._seam.submit(fn, *args)

    # -- gauges / lifecycle ----------------------------------------------

    def parallel_fraction(self) -> float:
        """Fraction of all prepped rows that took the parallel row-block
        path (0.0 = everything ran serially — the no-silent-fallback
        gauge the structural tests assert on)."""
        if self.rows_total <= 0:
            return 0.0
        return self.rows_parallel / self.rows_total

    def close(self) -> None:
        """Shut both executors down (waits for in-flight work). Called
        when a verifier rebuilds its engine at a new worker count; safe
        to call twice."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        if self._seam is not None:
            self._seam.shutdown(wait=True)
            self._seam = None
