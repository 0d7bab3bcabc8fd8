"""Consensus observability counters.

The port's copy of ``dag_rider_tpu/utils/metrics.py``.

The reference has none (SURVEY.md §5: logging only, 3 Debug call sites).
These counters feed the BASELINE.json metric surface: rounds advanced,
waves decided/skipped, vertices delivered, verify-batch latency.

Sample lists are bounded (deque windows): a long-running node must not
leak a float per verify batch / wave commit for its lifetime — the same
bounded-state rule the DAG/RBC/coin GC enforces. Totals that
consumers sum (verify sig counts, cumulative verify seconds) are kept as
running counters instead, so throughput math is exact over the whole run
while percentiles window to the recent samples.
"""

from __future__ import annotations

import time
from collections import defaultdict, deque
from typing import Deque, Dict

#: per-series sample-window size: big enough that bench boxes (minutes)
#: keep every sample, small enough to bound week-long nodes
SAMPLE_WINDOW = 65536

#: Every counter name any module may bump. The driderlint
#: metrics checker (analysis/metricsreg.py) rejects a literal
#: ``metrics.inc("...")`` / ``self._inc("...")`` / ``counters["..."]``
#: whose name is not registered here — a typo'd counter silently
#: creating a new defaultdict key is the observability analogue of the
#: typo'd-knob bug MempoolConfig.from_dict exists to kill.
KNOWN_COUNTERS = frozenset(
    {
        # consensus/process.py — admission, rounds, waves, sync
        "msgs_received",
        "msgs_rejected_stamp",
        "msgs_below_gc_horizon",
        "equivocations_detected",
        "msgs_duplicate",
        "msgs_rejected_edges",
        "msgs_ignored_kind",
        "msgs_rejected_signature",
        "vertices_admitted",
        "vertices_proposed",
        "vertices_delivered",
        "vertices_pruned",
        "rounds_advanced",
        "waves_decided",
        "waves_skipped",
        # pipelined waves + eager delivery
        "waves_inflight",
        "eager_delivered",
        "eager_reconciled",
        "eager_rollbacks_expected_zero",
        "deadline_ms_effective",
        "sync_requested",
        "sync_attested_floor_raises",
        "sync_nacks",
        "sync_throttled",
        "sync_refused_pruned",
        "sync_served",
        "state_transfers",
        "pump_errors",
        # aggregated round certificates
        "certs_ignored",
        "certs_rejected",
        "certs_verified",
        "certs_assembled",
        "sigs_saved",
        "cert_rounds_degraded",
        "cert_timeouts",
        "cert_path_enabled",
        # cert-of-certs overlay + hash-to-curve cache
        "spans_assembled",
        "spans_verified",
        "spans_rejected",
        "spans_ignored",
        "span_rounds_settled",
        "span_timeouts",
        "span_path_enabled",
        "hash_g1_cache_hits",
        "hash_g1_cache_misses",
        # lanes/ — sharded dissemination
        "lane_batches_certified",
        "lane_publish_degraded",
        "lane_fetch_misses",
        "lane_batches_stored",
        "lane_fetch_served",
        "lane_acks_rejected",
        "lane_store_evicted",
        "committed_bytes_per_s",
        # transport/net.py — wire health
        "net_sends",
        "net_sends_ok",
        "net_send_errors",
        "net_drops",
        "net_retries",
        "net_auth_rejects",
        "net_peer_down",
        "net_peer_recovered",
        "net_snapshot_rejects",
        "net_snapshot_stale_refusals",
        "net_snapshot_replays",
        "net_snapshot_throttled",
        "net_snapshot_global_throttled",
        "net_snapshot_fetches",
        "net_snapshot_errors",
        # transport/net.py — injected WAN faults (cluster harness)
        "net_wan_drops",
        "net_wan_delays",
        # cluster/ — multi-process harness
        "net_client_submits",
        "checkpoint_corrupt",
        "cluster_reinjects",
        # epoch reconfiguration
        "epoch_path_enabled",
        "epoch_current",
        "epoch_ctrl_txs",
        "epoch_boundaries",
        "epoch_rotations",
        "epoch_barrier_holds",
        "epoch_stale_rejected",
        "vertices_live_max",
        # span-attested snapshot sync
        "snapshot_spans_attached",
        "snapshot_spans_verified",
        "snapshot_attest_rejects",
        "snapshot_pairing_checks",
    }
)


class Histogram:
    """Percentiles over a bounded reservoir.

    A deque-windowed sample set plus exact running count/total — the
    same windowed-percentiles/exact-totals split the rest of this
    module uses. ``percentile(q)`` is the nearest-rank estimate over
    the *window*; ``count``/``total`` stay exact for the whole run.
    """

    def __init__(self, maxlen: int = SAMPLE_WINDOW) -> None:
        self.samples: Deque[float] = deque(maxlen=maxlen)
        self.count = 0
        self.total = 0.0

    def __len__(self) -> int:
        return len(self.samples)

    def observe(self, value: float) -> None:
        self.samples.append(value)
        self.count += 1
        self.total += value

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile, q in (0, 100]. Raises on an empty
        reservoir — callers gate on ``len(h)`` like every other
        conditional snapshot section."""
        s = sorted(self.samples)
        if not s:
            raise ValueError("percentile of an empty histogram")
        rank = max(1, -(-len(s) * q // 100))  # ceil without math import
        return s[int(rank) - 1]

    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0


class Metrics:
    """Per-process counters + windowed latency samples."""

    def __init__(self) -> None:
        self.counters: Dict[str, int] = defaultdict(int)
        self.verify_batch_seconds: Deque[float] = deque(maxlen=SAMPLE_WINDOW)
        self.verify_batch_sizes: Deque[int] = deque(maxlen=SAMPLE_WINDOW)
        self.wave_commit_seconds: Deque[float] = deque(maxlen=SAMPLE_WINDOW)
        self.wave_interval_seconds: Deque[float] = deque(
            maxlen=SAMPLE_WINDOW
        )
        self._last_wave_commit_at: float | None = None
        #: in-flight dispatch window high-water per coalesced verify
        #: cycle (depth-K pipeline — verifier/pipeline.py)
        self.verify_queue_depth: Deque[int] = deque(maxlen=SAMPLE_WINDOW)
        #: per-dispatch shard fill imbalance on the mesh-sharded verify
        #: path (0.0 = every shard got equal real rows; 1.0 = at least
        #: one shard was all padding while another was full)
        self.verify_shard_imbalance: Deque[float] = deque(
            maxlen=SAMPLE_WINDOW
        )
        #: exact running totals (never windowed) — the sums consumers use
        self.verify_sigs_total = 0
        self.verify_seconds_total = 0.0
        #: host/device overlap accounting for the pipelined verify seam:
        #: wait = host blocked in resolve (unhidden device time), seam =
        #: verify-seam wall time. overlap_fraction() = 1 - wait/seam.
        self.verify_wait_seconds_total = 0.0
        self.verify_seam_seconds_total = 0.0
        #: parallel host-prep engine gauges (verifier/prep.py): worker
        #: count of the shared verifier's engine and the lifetime share
        #: of prepped rows that took the parallel row-block path
        self.verify_prep_workers = 0
        self.verify_prep_parallel_fraction: float | None = None
        #: resilience gauges (verifier/resilient.py + the
        #: containment seams): absolute counters mirrored from the
        #: shared verify stack, None until a resilient run reported
        self.verify_retries: int | None = None
        self.verify_fallback_tier: int | None = None
        self.verify_quarantined: int | None = None
        self.sidecar_rpc_failures: int | None = None
        #: 1 = the sidecar tier answered its last probe, 0 = down,
        #: None = no sidecar tier in the stack
        self.sidecar_health: int | None = None
        #: transport chaos counters (FaultyTransport.stats), absolute
        self.transport_faults: Dict[str, int] | None = None
        #: client-level latency: submit → a_deliver per
        #: transaction through the mempool front door. END-TO-END and
        #: per-process-real, unlike the verify timing series: under the
        #: simulator's dedup'd shared verifier the per-process verify
        #: timings remain AMORTIZED (each process is charged a
        #: size-proportional share of one union dispatch — see
        #: mark_verify_amortized), so summing them never
        #: yields cluster cost; the submit→deliver histogram has no such
        #: caveat — each sample is one real client transaction's wait.
        self.submit_deliver_seconds = Histogram()
        #: latest mempool gauge dict (Mempool.stats) — None until a
        #: mempool is attached to this process's node
        self.mempool: Dict | None = None
        #: host-pump accounting: messages delivered
        #: through the consensus pump and the wall seconds the pump loop
        #: spent pumping + stepping, plus which path ran. None until a
        #: pump-aware caller (Simulation.run / node pump loop) reports.
        self.pump_msgs_total = 0
        self.pump_seconds_total = 0.0
        self.pump_path: str | None = None

    def inc(self, name: str, by: int = 1) -> None:
        self.counters[name] += by

    def observe_verify_batch(self, size: int, seconds: float) -> None:
        self.verify_batch_sizes.append(size)
        self.verify_batch_seconds.append(seconds)
        self.verify_sigs_total += size
        self.verify_seconds_total += seconds

    def observe_verify_queue_depth(self, depth: int) -> None:
        """High-water in-flight dispatch count of one coalesced verify
        cycle (1 = the serial dispatch-then-resolve shape; >= 2 means
        host prep genuinely overlapped device execution)."""
        self.verify_queue_depth.append(depth)

    def observe_shard_imbalance(self, fraction: float) -> None:
        """Shard fill imbalance of one mesh-sharded dispatch
        ((max - min real rows per shard) / shard rows — 0.0 when the
        batch filled every shard equally). Persistent high values mean
        the bucket is oversized for the burst and chips idle on padding."""
        self.verify_shard_imbalance.append(fraction)

    def observe_verify_overlap(self, wait_s: float, seam_s: float) -> None:
        """This process's share of a pipelined cycle: seconds the host
        blocked in resolve vs the cycle's verify-seam wall time."""
        self.verify_wait_seconds_total += wait_s
        self.verify_seam_seconds_total += seam_s

    def overlap_fraction(self) -> float | None:
        """Fraction of verify-seam wall time the host spent doing useful
        work (prep of later chunks, delivery walks) instead of blocked
        on the device. None until a pipelined cycle ran."""
        if self.verify_seam_seconds_total <= 0.0:
            return None
        return max(
            0.0,
            min(
                1.0,
                1.0
                - self.verify_wait_seconds_total
                / self.verify_seam_seconds_total,
            ),
        )

    def observe_prep(self, workers: int, parallel_fraction: float) -> None:
        """Latest host-prep engine gauges (TPUVerifier.prep_stats):
        configured worker count and the fraction of all prepped rows
        that actually ran row-block parallel — the no-silent-fallback
        signal (workers > 1 with fraction 0.0 means every dispatch was
        below the block floor or the engine never engaged)."""
        self.verify_prep_workers = int(workers)
        self.verify_prep_parallel_fraction = float(parallel_fraction)

    def observe_resilience(
        self,
        retries: int,
        fallback_tier: int,
        quarantined: int,
        sidecar_health: int | None = None,
        rpc_failures: int = 0,
    ) -> None:
        """Latest resilience gauges of the shared verify stack
        (ResilientVerifier.resilience_stats / the pipeline's containment
        counters): cumulative retry count, the tier index that answered
        the most recent call (0 = preferred tier, len(tiers) = whole
        ladder exhausted), chunks re-verified in quarantine, sidecar
        probe health, and transport-level sidecar RPC failures — the
        counter that distinguishes a dead sidecar from a batch of
        invalid signatures (both read all-False at mask level)."""
        self.verify_retries = int(retries)
        self.verify_fallback_tier = int(fallback_tier)
        self.verify_quarantined = int(quarantined)
        self.sidecar_rpc_failures = int(rpc_failures)
        if sidecar_health is not None:
            self.sidecar_health = int(sidecar_health)

    def observe_transport_faults(self, stats: Dict[str, int]) -> None:
        """Absolute FaultyTransport.stats counters
        (dropped/delayed/duplicated/equivocated) — chaos runs surface
        their injected network faults next to the verifier gauges."""
        self.transport_faults = dict(stats)

    def observe_submit_deliver(self, seconds: float) -> None:
        """One accepted transaction's submit→a_deliver latency (the
        mempool closes these books at delivery time)."""
        self.submit_deliver_seconds.observe(seconds)

    def observe_mempool(self, stats: Dict) -> None:
        """Latest mempool gauges (Mempool.stats): depth, admitted/
        shed/deduped/expired counters, batch fill, backpressure state."""
        self.mempool = dict(stats)

    def observe_pump(self, msgs: int, seconds: float, path: str) -> None:
        """Host consensus-pump accounting from the driving loop:
        cumulative messages delivered, wall seconds spent in
        pump + step, and the active path ("scalar" | "vector"). The
        host pump's per-round floor becomes first-class observable as host_pump_ms_per_round / pump_msgs_per_s in the
        snapshot instead of hand-derived in PROFILE."""
        self.pump_msgs_total += int(msgs)
        self.pump_seconds_total += float(seconds)
        self.pump_path = path

    def mark_verify_amortized(self) -> None:
        """Flag this process's verify timings as AMORTIZED: under the
        simulator's dedup'd shared verifier one process pays the wall
        time for a union batch whose masks all n processes consume, so
        per-process verify_seconds/sigs do not sum to cluster
        cost. Consumers must treat the per-process series as
        attribution of shared work, not as independent spend."""
        self.counters["verify_timings_amortized"] = 1

    def observe_wave_commit(self, seconds: float) -> None:
        """Duration of one decided wave's commit + total-order pass (the
        decide-walk HALF of the BASELINE.json 'p50 wave-commit latency'
        story — see :meth:`observe_wave_decided` for the end-to-end
        cadence)."""
        self.wave_commit_seconds.append(seconds)

    def observe_wave_decided(self) -> None:
        """Stamp a wave DECISION: wall time between consecutive decided
        waves is the END-TO-END cadence, including the ~4 rounds of
        verify + consensus a wave costs — the quantity the staged
        proxy (4 dispatches + commit kernels) modeled. Called at decide
        time, NOT at the (possibly deferred and batched) ordering flush:
        two waves flushed together must not record a ~0 interval. The
        decide-walk sample (observe_wave_commit) deliberately excludes
        verify — it is amortized across the round pipeline — and
        reporting both keeps the two from being conflated."""
        now = time.monotonic()
        if self._last_wave_commit_at is not None:
            self.wave_interval_seconds.append(now - self._last_wave_commit_at)
        self._last_wave_commit_at = now

    @staticmethod
    def _p50(samples) -> float:
        s = sorted(samples)
        return s[len(s) // 2]

    def sigs_per_sec(self) -> float:
        if self.verify_seconds_total == 0:
            return 0.0
        return self.verify_sigs_total / self.verify_seconds_total

    def snapshot(self) -> Dict[str, float]:
        out: Dict[str, float] = dict(self.counters)
        # Byzantine-detection counter is part of the stable snapshot/rung
        # schema even when zero (defaultdict counters only appear once
        # incremented): chaos and adversary rungs assert DETECTION
        # counts next to the transport_* fault stats, and "0 detected"
        # must be distinguishable from "not surfaced".
        out.setdefault("equivocations_detected", 0)
        if self.verify_batch_sizes:
            out["verify_sigs_total"] = self.verify_sigs_total
            out["verify_sigs_per_sec"] = self.sigs_per_sec()
            out["verify_batch_p50_ms"] = 1e3 * self._p50(self.verify_batch_seconds)
            out["verify_batch_mean_size"] = sum(self.verify_batch_sizes) / len(
                self.verify_batch_sizes
            )
        if self.verify_queue_depth:
            out["verify_queue_depth_p50"] = self._p50(self.verify_queue_depth)
            out["verify_queue_depth_max"] = max(self.verify_queue_depth)
        if self.verify_shard_imbalance:
            out["verify_shard_imbalance_p50"] = round(
                self._p50(self.verify_shard_imbalance), 4
            )
            out["verify_shard_imbalance_max"] = round(
                max(self.verify_shard_imbalance), 4
            )
        if self.verify_seam_seconds_total > 0.0:
            out["verify_overlap_fraction"] = round(
                self.overlap_fraction(), 4
            )
        if self.verify_prep_workers:
            out["verify_prep_workers"] = self.verify_prep_workers
            out["verify_prep_parallel_fraction"] = round(
                self.verify_prep_parallel_fraction or 0.0, 4
            )
        if self.verify_retries is not None:
            out["verify_retries"] = self.verify_retries
            out["verify_fallback_tier"] = self.verify_fallback_tier or 0
            out["verify_quarantined"] = self.verify_quarantined or 0
            out["sidecar_rpc_failures"] = self.sidecar_rpc_failures or 0
        if self.sidecar_health is not None:
            out["sidecar_health"] = self.sidecar_health
        if self.transport_faults is not None:
            for k, v in self.transport_faults.items():
                out[f"transport_{k}"] = v
        if len(self.submit_deliver_seconds):
            h = self.submit_deliver_seconds
            out["submit_deliver_p50_ms"] = round(1e3 * h.percentile(50), 3)
            out["submit_deliver_p90_ms"] = round(1e3 * h.percentile(90), 3)
            out["submit_deliver_p99_ms"] = round(1e3 * h.percentile(99), 3)
            out["submit_deliver_count"] = h.count
        if self.mempool is not None:
            #: backpressure state as a numeric gauge next to the counters
            ladder = {"accept": 0, "throttle": 1, "shed": 2}
            for k, v in self.mempool.items():
                if k == "state":
                    out["mempool_backpressure"] = ladder.get(v, -1)
                elif isinstance(v, (int, float)):
                    out[f"mempool_{k}"] = v
        if self.pump_path is not None:
            # numeric gauge (same convention as mempool_backpressure)
            out["pump_path"] = {"scalar": 0, "vector": 1}.get(
                self.pump_path, -1
            )
            if self.pump_seconds_total > 0.0:
                out["pump_msgs_per_s"] = round(
                    self.pump_msgs_total / self.pump_seconds_total, 1
                )
                rounds = self.counters.get("rounds_advanced", 0)
                if rounds:
                    out["host_pump_ms_per_round"] = round(
                        1e3 * self.pump_seconds_total / rounds, 3
                    )
                committed = (self.mempool or {}).get("delivered_bytes", 0)
                if committed:
                    # payload bytes committed per second of ordering-path
                    # (pump) time — the lanes A/B headline:
                    # with dissemination on worker lanes, this must keep
                    # scaling as block weight grows while the pump floor
                    # stays flat
                    out["committed_bytes_per_s"] = round(
                        committed / self.pump_seconds_total
                    )
        if "cert_path_enabled" in self.counters:
            # aggregated round-certificate gauges: the cert
            # counters are part of the stable schema whenever the fast
            # path is wired — "0 certs" must be distinguishable from
            # "cert path absent"
            for k in (
                "certs_assembled",
                "certs_verified",
                "certs_rejected",
                "cert_timeouts",
                "cert_rounds_degraded",
                "sigs_saved",
            ):
                out.setdefault(k, 0)
            admitted = self.counters.get("vertices_admitted", 0)
            out["cert_fastpath_fraction"] = round(
                self.counters.get("sigs_saved", 0) / admitted, 4
            ) if admitted else 0.0
            # hash-to-curve cache effectiveness:
            # process-global by construction (the cache lives in the
            # crypto layer), surfaced as gauges wherever the cert path
            # is on so a bench run can see its hit rate next to the
            # signing numbers. Lazy import keeps cert-off snapshots free
            # of the BLS module.
            from dag_rider_tpu_torch.crypto import bls12381 as _bls

            h2g1 = _bls.hash_g1_cache_stats()
            out["hash_g1_cache_hits"] = h2g1["hits"]
            out["hash_g1_cache_misses"] = h2g1["misses"]
            if "span_path_enabled" in self.counters:
                for k in (
                    "spans_assembled",
                    "spans_verified",
                    "spans_rejected",
                    "spans_ignored",
                    "span_rounds_settled",
                    "span_timeouts",
                ):
                    out.setdefault(k, 0)
        if self.wave_commit_seconds:
            out["wave_commit_p50_ms"] = 1e3 * self._p50(self.wave_commit_seconds)
        if self.wave_interval_seconds:
            out["wave_interval_p50_ms"] = 1e3 * self._p50(
                self.wave_interval_seconds
            )
        return out


class Timer:
    """Context manager: ``with Timer() as t: ...; t.seconds``."""

    def __enter__(self) -> "Timer":
        self._start = time.perf_counter()
        self.seconds = 0.0
        return self

    def __exit__(self, *exc) -> None:
        self.seconds = time.perf_counter() - self._start
