"""Depth-K asynchronous verifier pipeline.

The port's copy of ``dag_rider_tpu/verifier/pipeline.py``. It drives
:class:`~dag_rider_tpu_torch.verifier.cuda.CUDAVerifier` through its async
halves (``dispatch_batch`` enqueues on the current CUDA stream and records
an event, ``resolve_batch`` waits on it): a dispatch's fixed cost (the
host-to-card copies, the launches, a blocking resolve right after the
dispatch) is paid once per chunk, and without a window the host would sit
idle through every one of them.

:class:`VerifierPipeline` owns the in-flight window those halves imply:

- **coalescing** — a merged burst (the simulator's per-pump union of all
  n processes' ``take_verify_batch`` output, already deduped) is sliced
  into ``fixed_bucket``-sized chunks, one compiled program shape for the
  whole run;
- **depth-K window** — up to K chunk dispatches stay in flight, so chunk
  k+1's host prep (SHA-512 challenge scalars, limb packing — the
  expensive host half) overlaps chunk k's device execution;
- **FIFO resolve** — masks come back in submission order, and each chunk
  boundary is identical to the synchronous path's, so the concatenated
  mask — and therefore the commit order downstream of it — is
  byte-identical to ``verify_batch`` / ``CPUVerifier``
  (tests/test_pipeline.py);
- **warmup** — construction calls the verifier's :meth:`warmup` when it
  has one, so the first consensus round does not pay a compile.

The mask is still a pure function of (vertex bytes, registry); the
pipeline only changes WHEN the host blocks, never WHAT it computes.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Deque, List, Optional, Sequence

from dag_rider_tpu_torch import config
from dag_rider_tpu_torch.core.types import Vertex
from dag_rider_tpu_torch.utils.slog import NOOP, EventLog
from dag_rider_tpu_torch.verifier.base import Verifier


def default_depth() -> int:
    """In-flight window depth: DAGRIDER_VERIFY_DEPTH, default 2.

    Depth 1 degenerates to the synchronous dispatch-then-resolve shape;
    2 is enough to overlap host prep with device execution (the two
    alternate); deeper windows only help when chunk execution time
    varies."""
    return config.env_int("DAGRIDER_VERIFY_DEPTH")


class VerifierPipeline(Verifier):
    """Depth-K dispatch window over an async-capable verifier.

    Wraps any verifier exposing the ``dispatch_batch``/``resolve_batch``
    seam (``TPUVerifier`` and subclasses) and is itself a drop-in
    :class:`Verifier`: ``verify_batch``/``verify_rounds`` stream through
    the window, so a :class:`~dag_rider_tpu_torch.consensus.process.Process`
    can hold a pipeline directly (node.py's device configuration).
    """

    def __init__(
        self,
        verifier,
        depth: Optional[int] = None,
        *,
        fixed_bucket: Optional[int] = None,
        warmup: bool = True,
        log: EventLog = NOOP,
    ):
        self.log = log
        if not callable(getattr(verifier, "dispatch_batch", None)) or not (
            callable(getattr(verifier, "resolve_batch", None))
        ):
            raise TypeError(
                "VerifierPipeline needs an async-capable verifier "
                "(dispatch_batch/resolve_batch)"
            )
        self.verifier = verifier
        # explicit depth > the verifier's own pipeline_depth > env default
        self.depth = (
            int(depth)
            if depth is not None
            else int(getattr(verifier, "pipeline_depth", 0) or default_depth())
        )
        if self.depth < 1:
            raise ValueError(f"pipeline depth must be >= 1, got {depth!r}")
        # the verifier sizes its host staging ring from pipeline_depth —
        # it must cover THIS window or a slot could be rewritten while
        # its dispatch is still in flight (CPU PJRT may alias host
        # buffers zero-copy into the program)
        if getattr(verifier, "pipeline_depth", self.depth) < self.depth:
            verifier.pipeline_depth = self.depth
        if fixed_bucket is not None:
            verifier.fixed_bucket = fixed_bucket
        #: (pending handle, chunk) FIFO — the chunk rides along so a
        #: dispatch/resolve fault can quarantine exactly the vertices it
        #: poisoned
        self._inflight: Deque[tuple] = deque()
        #: masks already produced by fault containment, FIFO-ordered
        #: ahead of everything in _inflight; _resolve_oldest consumes
        #: these first so the concatenated mask keeps chunk order
        self._salvaged: Deque[List[bool]] = deque()
        #: next tier for quarantined chunks (wired by ResilientVerifier);
        #: None = one serial retry on the wrapped verifier, then reject
        self.quarantine_verifier: Optional[Verifier] = None
        #: fault-containment gauges
        self.poisoned_windows = 0
        self.quarantined = 0
        self.quarantine_rejected = 0
        #: cumulative window accounting (the bench's amortization gauges)
        self.dispatches = 0
        self.sigs_dispatched = 0
        self.wait_s = 0.0  # host blocked in resolve (unhidden device time)
        self.seam_s = 0.0  # verify-seam wall time, overlap callback excluded
        self.depth_hwm = 0  # high-water in-flight count
        #: most recent run_coalesced cycle (the simulator's per-cycle share)
        self.last_seam_s = 0.0
        self.last_wait_s = 0.0
        self.last_max_depth = 0
        self.warmup_compile_s = 0.0
        if warmup and hasattr(verifier, "warmup"):
            self.warmup_compile_s = verifier.warmup()

    # -- passthroughs: tune the wrapped verifier through the pipeline ----

    @property
    def fixed_bucket(self) -> Optional[int]:
        return getattr(self.verifier, "fixed_bucket", None)

    @fixed_bucket.setter
    def fixed_bucket(self, value: Optional[int]) -> None:
        self.verifier.fixed_bucket = value

    @property
    def registry(self):
        return self.verifier.registry

    # -- window mechanics ------------------------------------------------

    def _dispatch(self, chunk: Sequence[Vertex]) -> None:
        try:
            handle = self.verifier.dispatch_batch(chunk)
        except Exception:  # noqa: BLE001 — prep/dispatch fault contained
            self._contain(chunk, failed_first=False)
            return
        self._inflight.append((handle, chunk))
        self._book_dispatch(len(chunk))

    def _dispatch_prepped(self, prepped, chunk: Sequence[Vertex]) -> None:
        """Ship a batch already prepped on the engine's seam thread
        (TPUVerifier.prep_batch_async) — same window accounting as
        _dispatch, prep already paid."""
        try:
            handle = self.verifier.dispatch_prepped(prepped)
        except Exception:  # noqa: BLE001 — dispatch fault contained
            self._contain(chunk, failed_first=False)
            return
        self._inflight.append((handle, chunk))
        self._book_dispatch(prepped.count)

    def _book_dispatch(self, count: int) -> None:
        self.dispatches += 1
        self.sigs_dispatched += count
        d = len(self._inflight)
        if d > self.depth_hwm:
            self.depth_hwm = d
        if d > self.last_max_depth:
            self.last_max_depth = d

    def _pending(self) -> int:
        """Masks still owed to the caller: contained (already computed)
        plus in flight on the device."""
        return len(self._salvaged) + len(self._inflight)

    def _resolve_oldest(self) -> List[bool]:
        if self._salvaged:
            # containment already produced this chunk's mask; it is
            # older than anything in _inflight by construction
            return self._salvaged.popleft()
        handle, chunk = self._inflight.popleft()
        t0 = time.perf_counter()
        try:
            out = self.verifier.resolve_batch(handle)
        except Exception:  # noqa: BLE001 — resolve fault contained
            self._contain(chunk, failed_first=True)
            out = self._salvaged.popleft()
        dt = time.perf_counter() - t0
        self.wait_s += dt
        self.last_wait_s += dt
        # device share of the verifier's cumulative seam breakdown (its
        # own sync verify_batch books the same quantity for itself)
        if hasattr(self.verifier, "total_dispatch_s"):
            self.verifier.total_dispatch_s += dt
        return out

    # -- fault containment --------------------------------------

    def _quarantine(self, chunk: Sequence[Vertex]) -> List[bool]:
        """Re-verify a chunk out of a poisoned window exactly once: on
        the ladder's next tier when ResilientVerifier wired one, else a
        fresh serial pass on the wrapped verifier. A second failure
        rejects the chunk — fail closed, never fail open."""
        self.quarantined += 1
        self.log.event("verify_quarantined", chunk=len(chunk))
        vs = list(chunk)
        try:
            if self.quarantine_verifier is not None:
                return self.quarantine_verifier.verify_batch(vs)
            return self.verifier.verify_batch(vs)
        except Exception:  # noqa: BLE001 — second failure fail-closes
            self.quarantine_rejected += 1
            return [False] * len(vs)

    def _contain(self, chunk: Sequence[Vertex], failed_first: bool) -> None:
        """A dispatch or resolve exception poisoned the window: resolve
        every salvageable in-flight entry (a second fault quarantines
        that chunk too), re-arm the staging ring (fresh slots — the
        aliasing discipline survives orphaned dispatches, see
        TPUVerifier.reset_staging), then quarantine the failing chunk.
        The resulting masks land on ``_salvaged`` in FIFO chunk order:
        ``failed_first`` is True for a resolve fault (the failed chunk
        was the oldest, already popped) and False for a dispatch fault
        (the failed chunk never entered the window)."""
        self.poisoned_windows += 1
        self.log.event(
            "verify_window_poisoned", inflight=len(self._inflight)
        )
        entries = []  # (mask-or-None, chunk) in FIFO order
        while self._inflight:
            h, ch = self._inflight.popleft()
            try:
                entries.append((self.verifier.resolve_batch(h), ch))
            except Exception:  # noqa: BLE001 — quarantined after reset
                entries.append((None, ch))
        if callable(getattr(self.verifier, "reset_staging", None)):
            self.verifier.reset_staging()
        masks: List[List[bool]] = []
        if failed_first:
            masks.append(self._quarantine(chunk))
        for m, ch in entries:
            masks.append(m if m is not None else self._quarantine(ch))
        if not failed_first:
            masks.append(self._quarantine(chunk))
        self._salvaged.extend(masks)

    def drain(self) -> List[bool]:
        """Resolve everything still owed — salvaged containment masks
        plus the in-flight window — and return the concatenated mask.
        The reset seam for callers recovering from an external failure:
        after drain() the window is empty and the next dispatch starts
        clean."""
        out: List[bool] = []
        while self._pending():
            out.extend(self._resolve_oldest())
        return out

    def run_coalesced(
        self,
        vertices: Sequence[Vertex],
        overlap: Optional[Callable[[], None]] = None,
        hold_tail: bool = False,
    ) -> List[bool]:
        """One coalesced cycle: chunk ``vertices`` at the verifier's
        fixed bucket, stream the chunks through the depth-K window, run
        ``overlap()`` once after the last dispatch (host work with no
        causal dependency on the in-flight masks — the simulator's
        deferred delivery flush), resolve FIFO, return the full mask.

        Chunk boundaries are exactly ``verify_rounds``' synchronous
        boundaries, so padding — and therefore the mask — is
        byte-identical to the serial path. ``seam_s``/``last_seam_s``
        exclude the overlap callback's duration (the callee accounts for
        its own time).

        ``hold_tail`` keeps up to ``depth - 1``
        chunks in flight across the call boundary instead of draining
        the window at the cycle edge: the returned mask then covers only
        the RESOLVED front of this call's input, and the held chunks'
        masks emerge at the FRONT of the next call's mask (or via
        :meth:`drain`), in the same FIFO order. Callers owning the
        round loop (the simulator's pipelined path) use it so the
        device keeps crunching round r+1's tail while the host pumps
        round r+2 — the depth-K window spans round boundaries rather
        than re-filling from empty each cycle."""
        t0 = time.perf_counter()
        self.last_wait_s = 0.0
        self.last_max_depth = len(self._inflight)
        # pipeline_enabled off (bench's sync A/B side) caps the window at
        # 1: dispatch-then-resolve, the pre-pipeline serial shape
        depth = (
            self.depth
            if getattr(self.verifier, "pipeline_enabled", True)
            else 1
        )
        cap = getattr(self.verifier, "fixed_bucket", None) or len(vertices)
        cap = max(int(cap), 1)
        mask: List[bool] = []
        chunks = [vertices[i : i + cap] for i in range(0, len(vertices), cap)]
        async_prep = (
            depth > 1
            and len(chunks) > 1
            and callable(getattr(self.verifier, "prep_batch_async", None))
            and callable(getattr(self.verifier, "dispatch_prepped", None))
        )
        if async_prep:
            # Prep-ahead on the engine's seam thread: chunk k+2's prep
            # runs while chunk k+1's prep is queued behind it and chunk
            # k executes on the device. At most 2 preps outstanding, and
            # a new prep is submitted only AFTER the window has drained
            # below depth and the current chunk has dispatched — so when
            # prep j+2 claims staging slot (j+2) mod (pipeline_depth+2),
            # that slot's previous dispatch (chunk <= j-depth) has
            # already resolved.
            preps: Deque = deque()
            nxt = 0
            while nxt < len(chunks) and len(preps) < 2:
                preps.append(
                    (self.verifier.prep_batch_async(chunks[nxt]), chunks[nxt])
                )
                nxt += 1
            while preps:
                fut, chunk = preps.popleft()
                try:
                    prepped = fut.result()
                except Exception:  # noqa: BLE001 — prep fault contained
                    self._contain(chunk, failed_first=False)
                else:
                    while self._pending() >= depth:
                        mask.extend(self._resolve_oldest())
                    self._dispatch_prepped(prepped, chunk)
                if nxt < len(chunks):
                    preps.append(
                        (
                            self.verifier.prep_batch_async(chunks[nxt]),
                            chunks[nxt],
                        )
                    )
                    nxt += 1
        else:
            for chunk in chunks:
                while self._pending() >= depth:
                    mask.extend(self._resolve_oldest())
                self._dispatch(chunk)
        overlap_s = 0.0
        if overlap is not None:
            t1 = time.perf_counter()
            overlap()
            overlap_s = time.perf_counter() - t1
        keep = max(0, depth - 1) if hold_tail else 0
        while self._pending() > keep:
            mask.extend(self._resolve_oldest())
        self.last_seam_s = max(0.0, (time.perf_counter() - t0) - overlap_s)
        self.seam_s += self.last_seam_s
        return mask

    # -- Verifier interface ----------------------------------------------

    def verify_batch(self, vertices: Sequence[Vertex]) -> List[bool]:
        if not vertices:
            return []
        return self.run_coalesced(list(vertices))

    def verify_rounds(
        self, rounds: Sequence[Sequence[Vertex]]
    ) -> List[List[bool]]:
        lens = [len(r) for r in rounds]
        flat = [v for r in rounds for v in r]
        mask = self.run_coalesced(flat) if flat else []
        out, pos = [], 0
        for ln in lens:
            out.append(mask[pos : pos + ln])
            pos += ln
        return out

    # -- gauges ----------------------------------------------------------

    def overlap_fraction(self) -> Optional[float]:
        """Share of the verify seam's wall time during which the host was
        doing useful work instead of blocked on the device:
        ``1 - wait_s / seam_s``. 0 ~= the serial dispatch-then-resolve
        shape; higher = more of the device time hidden behind host prep
        and delivery walks. None until something ran."""
        if self.seam_s <= 0.0:
            return None
        return max(0.0, min(1.0, 1.0 - self.wait_s / self.seam_s))

    def stats(self) -> dict:
        out = {
            "depth": self.depth,
            "queue_depth_max": self.depth_hwm,
            "dispatches": self.dispatches,
            "sigs_dispatched": self.sigs_dispatched,
            "wait_s": round(self.wait_s, 4),
            "seam_s": round(self.seam_s, 4),
            "overlap_fraction": (
                None
                if self.overlap_fraction() is None
                else round(self.overlap_fraction(), 3)
            ),
            "warmup_compile_s": round(self.warmup_compile_s, 2),
        }
        # host-prep engine gauges: worker count and the share
        # of prepped rows that actually took the parallel row-block path
        # — the structural no-silent-fallback signal
        if callable(getattr(self.verifier, "prep_stats", None)):
            ps = self.verifier.prep_stats()
            out["prep_workers"] = ps["workers"]
            out["prep_parallel_fraction"] = round(ps["parallel_fraction"], 3)
        # mesh gauges when the wrapped verifier dispatches sharded
        # (ShardedTPUVerifier): devices, per-shard rows of the latest
        # dispatch, and its shard fill imbalance (0.0 = every shard full)
        mesh_devices = getattr(self.verifier, "mesh_devices", 0)
        if mesh_devices:
            out["mesh_devices"] = mesh_devices
            out["shard_batch"] = getattr(self.verifier, "last_shard_batch", 0)
            out["shard_imbalance"] = round(
                getattr(self.verifier, "last_shard_imbalance", 0.0), 3
            )
        # fault-containment gauges, only once something was
        # actually contained — the clean path's stats dict is unchanged
        rs = self.resilience_stats()
        if rs["poisoned_windows"] or rs["quarantined"]:
            out["poisoned_windows"] = rs["poisoned_windows"]
            out["quarantined"] = rs["quarantined"]
            out["quarantine_rejected"] = rs["quarantine_rejected"]
        return out

    def resilience_stats(self) -> dict:
        """Round-9 containment gauges, pipeline window + wrapped
        verifier's own chunk-streaming path combined. Same key shape as
        ResilientVerifier.resilience_stats so consumers (Simulation's
        metrics fan-out, the bench's verifier_breakdown) read either."""
        return {
            "retries": getattr(self.verifier, "retries_total", 0),
            "fallback_tier": 0,
            "fallbacks": 0,
            "poisoned_windows": self.poisoned_windows
            + getattr(self.verifier, "poisoned_windows", 0),
            "quarantined": self.quarantined
            + getattr(self.verifier, "quarantined_chunks", 0),
            "quarantine_rejected": self.quarantine_rejected
            + getattr(self.verifier, "quarantine_rejected", 0),
            "sidecar_rpc_failures": getattr(self.verifier, "rpc_failures", 0),
            "sidecar_health": None,
        }
