"""Framework configuration.

The port's copy of ``dag_rider_tpu/config.py``.

The reference has no config system (SURVEY.md §5): its only knobs are the
``New(index, faulty, tp)`` arguments (``process/process.go:34``) and hardcoded
constants (wave length 4 at ``process.go:238,332,400``, channel buffer 10 at
``process.go:174``). This dataclass makes every knob explicit, including the
TPU-specific ones (verifier backend, device mesh shape).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

# ---------------------------------------------------------------------------
# Central DAGRIDER_* knob registry.
#
# Every environment variable the package reads must be registered here and
# read through one of the env_* accessors below; the driderlint knob checker
# (dag_rider_tpu/analysis/knobs.py) rejects any direct ``os.environ`` read of
# a DAGRIDER_* name outside this module, and cross-checks that every
# registered knob appears in the README knob table. bench.py's
# DAGRIDER_BENCH_* namespace is the one carve-out (bench-local tuning, never
# read by the package).
# ---------------------------------------------------------------------------

#: shared env-flag convention: anything but these (case-insensitive) is on
_OFF_WORDS = ("0", "false", "no", "off")


@dataclasses.dataclass(frozen=True)
class Knob:
    """One registered environment knob.

    ``kind`` is "flag" | "int" | "float" | "str" | "choice"; ``default``
    is the value an empty/unset variable resolves to (already typed);
    ``choices``/``minimum`` carry the validation the accessor enforces.
    """

    name: str
    kind: str
    default: object
    doc: str
    choices: Optional[Tuple[str, ...]] = None
    minimum: Optional[float] = None


KNOBS: Dict[str, Knob] = {}


def _register(
    name: str,
    kind: str,
    default: object,
    doc: str,
    choices: Optional[Tuple[str, ...]] = None,
    minimum: Optional[float] = None,
) -> None:
    KNOBS[name] = Knob(name, kind, default, doc, choices, minimum)


_register("DAGRIDER_PUMP", "choice", "scalar",
          "host consensus pump path", choices=("scalar", "vector"))
_register("DAGRIDER_CERT", "choice", "off",
          "aggregated round certificates", choices=("off", "agg"))
_register("DAGRIDER_CERT_MSM", "choice", "host",
          "certificate-aggregation MSM backend",
          choices=("host", "device", "sharded"))
_register("DAGRIDER_MESH", "int", None,
          "batch-axis device count for the sharded verifier mesh",
          minimum=1)
_register("DAGRIDER_SHARDED_COMB_IMPL", "str", "",
          "per-shard comb impl override (e.g. pallas_interpret)")
_register("DAGRIDER_VERIFY_DEPTH", "int", 2,
          "pipeline in-flight window depth", minimum=1)
_register("DAGRIDER_VERIFY_RETRY", "int", 1,
          "bounded retry count per resilient-verifier tier", minimum=0)
_register("DAGRIDER_VERIFY_FALLBACK", "str", "",
          "fallback-tier selector (cpu, or 0/off/none/false for none)")
_register("DAGRIDER_PREP_WORKERS", "int", 1,
          "parallel host-prep worker count", minimum=1)
_register("DAGRIDER_NATIVE", "flag", True,
          "native challenge hashing (hashlib fallback when off)")
_register("DAGRIDER_COMB", "flag", True,
          "fixed-key comb tables for the TPU verifier")
_register("DAGRIDER_COMB_BITS", "choice", "",
          "comb table window width", choices=("", "4", "8"))
_register("DAGRIDER_PALLAS_GROUP", "flag", True,
          "Pallas group-op kernels on real TPU backends")
_register("DAGRIDER_MSM_PALLAS", "flag", True,
          "Mosaic MSM kernels on real TPU backends")
_register("DAGRIDER_MEMPOOL_CAP", "int", 65536,
          "mempool capacity in transactions", minimum=1)
_register("DAGRIDER_BATCH_BYTES", "int", 8192,
          "target payload bytes per built block", minimum=1)
_register("DAGRIDER_BATCH_DEADLINE_MS", "float", 50.0,
          "max hold latency before a partial batch ships", minimum=0)
_register("DAGRIDER_ADMIT_WATERMARKS", "str", "",
          'admission watermarks as "low,high" pool-fill fractions')
_register("DAGRIDER_MEMPOOL_TTL_S", "float", 60.0,
          "pending-transaction eviction age in seconds")
_register("DAGRIDER_ADAPTIVE_DEADLINE", "flag", False,
          "drive the batcher's effective deadline from the live "
          "submit->deliver latency histogram")
_register("DAGRIDER_PROFILE_DIR", "str", "",
          "jax.profiler trace output directory for bench runs")
_register("DAGRIDER_AGG_OUT", "str", "BENCH_r06.json",
          "aggregate-cert bench output path")
_register("DAGRIDER_MULTICHIP_OUT", "str", "MULTICHIP_r06.json",
          "multichip bench output path")
_register("DAGRIDER_RACE", "flag", False,
          "install the dynamic lock-race harness under pytest")
_register("DAGRIDER_CERT_SIGN", "choice", "host",
          "batched BLS share-signing backend",
          choices=("host", "native", "device"))
_register("DAGRIDER_CERT_PAIR", "choice", "host",
          "certificate aggregate-pairing backend",
          choices=("host", "device"))
_register("DAGRIDER_CERT_SPAN", "int", 0,
          "rounds per cert-of-certs span (0 disables span certificates)",
          minimum=0)
_register("DAGRIDER_CERT_SELFCHECK", "flag", True,
          "aggregator self-verifies certificates before gossip")
_register("DAGRIDER_CERT2_OUT", "str", "BENCH_r07.json",
          "certificate-phase-2 bench output path")
_register("DAGRIDER_TRACE", "flag", False,
          "causal tracing layer (ring recorder + lifecycle/phase spans)")
_register("DAGRIDER_TRACE_SAMPLE", "float", 1.0,
          "fraction of transactions stamped with lifecycle spans",
          minimum=0)
_register("DAGRIDER_TRACE_RING", "int", 65536,
          "trace ring-buffer capacity in events", minimum=1)
_register("DAGRIDER_FLIGHT_DIR", "str", "",
          "flight-recorder dump directory (empty disables dumps)")
_register("DAGRIDER_FLIGHT_EVENTS", "int", 4096,
          "events retained in the flight-recorder last-N ring", minimum=1)
_register("DAGRIDER_WAVE_PIPELINE", "flag", False,
          "pipelined wave evaluation (decide each wave the step its "
          "commit-round quorum lands instead of at the 4-round boundary)")
_register("DAGRIDER_EAGER_DELIVER", "flag", False,
          "optimistic early delivery: surface each decided chunk via "
          "on_deliver_early ahead of the deferred canonical flush")
_register("DAGRIDER_FINALITY_OUT", "str", "BENCH_r08.json",
          "finality-ladder bench output path")
_register("DAGRIDER_LANES", "flag", False,
          "sharded dissemination lanes: vertices carry certified batch "
          "digests while worker lanes move the payload bytes")
_register("DAGRIDER_LANE_WORKERS", "int", 4,
          "payload-dissemination worker threads per lane bus", minimum=1)
_register("DAGRIDER_LANE_BATCH_BYTES", "int", 1024,
          "minimum encoded block size worth a lane round-trip; smaller "
          "blocks ship inline (the oracle path)", minimum=1)
_register("DAGRIDER_LANES_OUT", "str", "BENCH_r09.json",
          "lanes-ladder bench output path")
_register("DAGRIDER_CLUSTER_TRANSPORT", "choice", "uds",
          "address family for multi-process cluster harness sockets",
          choices=("uds", "tcp"))
_register("DAGRIDER_CLUSTER_BOOT_S", "float", 15.0,
          "per-node readiness timeout when booting cluster processes",
          minimum=0)
_register("DAGRIDER_CLUSTER_KEEP", "flag", False,
          "keep the cluster harness workspace (logs, checkpoints, flight "
          "dumps) after a run instead of deleting it")
_register("DAGRIDER_CLUSTER_OUT", "str", "BENCH_r20.json",
          "cluster-e2e ladder bench output path")
_register("DAGRIDER_EPOCH", "flag", False,
          "epoch reconfiguration: validator-set changes ordered through "
          "consensus as control txs, taking effect at deterministic "
          "wave boundaries")
_register("DAGRIDER_EPOCH_WAVES", "int", 8,
          "epoch boundary interval in waves: a committed reconfiguration "
          "control tx takes effect at the next multiple of this many "
          "waves", minimum=1)
_register("DAGRIDER_EPOCH_GC", "int", 0,
          "extra epoch GC depth in rounds kept past the committed "
          "frontier when an epoch settles (0 = reuse gc_depth)",
          minimum=0)
_register("DAGRIDER_EPOCH_ROTATE", "choice", "seed",
          "threshold-key rotation mode at epoch boundaries: seed = "
          "deterministic seeded dealer (every node derives identical "
          "keys from the committed transcript), dkg = full joint-Feldman "
          "resharing over crypto/dkg.py, none = epoch bump only",
          choices=("seed", "dkg", "none"))
_register("DAGRIDER_EPOCH_OUT", "str", "BENCH_r21.json",
          "epoch ladder bench output path")


def _raw(name: str) -> str:
    if name not in KNOBS:
        raise KeyError(
            f"unregistered DAGRIDER knob {name!r} — add it to "
            "dag_rider_tpu_torch.config.KNOBS"
        )
    return os.environ.get(name, "").strip()


def env_is_set(name: str) -> bool:
    """Whether the environment sets the registered knob (non-empty)."""
    return bool(_raw(name))


def env_flag(name: str, default: Optional[bool] = None) -> bool:
    """Registered boolean knob; empty/unset resolves to the registry
    default. Anything but 0/false/no/off (case-insensitive) is on."""
    raw = _raw(name)
    if not raw:
        d = KNOBS[name].default if default is None else default
        return bool(d)
    return raw.lower() not in _OFF_WORDS


def env_str(name: str, default: Optional[str] = None) -> str:
    raw = _raw(name)
    if raw:
        return raw
    return str(KNOBS[name].default if default is None else default)


def env_choice(name: str, default: Optional[str] = None) -> str:
    """Registered enumerated knob; raises ValueError outside choices."""
    knob = KNOBS[name]
    raw = _raw(name)
    val = raw if raw else str(knob.default if default is None else default)
    if knob.choices is not None and val not in knob.choices:
        raise ValueError(
            f"{name} must be one of {knob.choices}, got {val!r}"
        )
    return val


def env_int(name: str, default: Optional[int] = None) -> int:
    knob = KNOBS[name]
    raw = _raw(name)
    if not raw:
        return int(knob.default if default is None else default)  # type: ignore[arg-type]
    try:
        val = int(raw)
    except ValueError as e:
        raise ValueError(f"{name} must be an int, got {raw!r}") from e
    if knob.minimum is not None and val < knob.minimum:
        raise ValueError(
            f"{name} must be >= {int(knob.minimum)}, got {raw!r}"
        )
    return val


def env_opt_int(name: str) -> Optional[int]:
    """Registered optional int knob: unset/empty yields None."""
    knob = KNOBS[name]
    raw = _raw(name)
    if not raw:
        return None
    try:
        val = int(raw)
    except ValueError as e:
        raise ValueError(f"{name} must be an int, got {raw!r}") from e
    if knob.minimum is not None and val < knob.minimum:
        raise ValueError(
            f"{name} must be >= {int(knob.minimum)}, got {raw!r}"
        )
    return val


def env_float(name: str, default: Optional[float] = None) -> float:
    knob = KNOBS[name]
    raw = _raw(name)
    if not raw:
        return float(knob.default if default is None else default)  # type: ignore[arg-type]
    try:
        val = float(raw)
    except ValueError as e:
        raise ValueError(f"{name} must be a float, got {raw!r}") from e
    if knob.minimum is not None and val < knob.minimum:
        raise ValueError(
            f"{name} must be >= {knob.minimum}, got {raw!r}"
        )
    return val


@dataclasses.dataclass(frozen=True)
class Config:
    """All tunables for one DAG-Rider deployment.

    Attributes:
        n: committee size (number of processes). Process indices are
           0-based ints in [0, n) — unlike the reference's 1-based indices
           (``process/process.go:38-40``), which only exist there to paper
           over the genesis-seeding bug (SURVEY.md D2).
        f: max Byzantine faults tolerated. Defaults to floor((n-1)/3),
           the optimal resilience the protocol is designed for. Quorum
           size is 2f+1 (``process.go:165,236,337``).
        wave_length: rounds per wave. The paper (and reference) fix this
           at 4 (``process.go:394-402``); kept configurable for experiments
           but all tests use 4.
        signature_scheme: "none" | "ed25519" | "bls12381". "none" matches
           the reference (no crypto at all — SURVEY.md D10); "ed25519" is
           the per-vertex signing scheme of the north-star Verifier.
        verifier_backend: "cpu" | "tpu". Both must produce byte-identical
           commit order (BASELINE.json north star).
        coin: "fixed" | "round_robin" | "threshold_bls". "fixed" reproduces
           the reference stub's *determinism* (``process.go:390-392``)
           without its bug (we return wave-independent leader 0 only when
           explicitly configured); "threshold_bls" is the real common coin
           the reference's TODO names (``process.go:388``).
        propose_empty: if True, a process with no queued client blocks
           proposes an empty block instead of stalling round advancement.
           The reference busy-waits forever instead (D7, ``process.go:277``).
        mesh_shape: device mesh for multi-chip sharding, e.g. (8,) for a
           1-D "batch" mesh over vertices, (4, 2) for (batch, shard).
        mesh_axis_names: names for the mesh axes.
        max_rounds: capacity hint for dense DAG tensors (grown on demand).
        sync_patience: quiescent step() passes with a stuck buffer before
           a process broadcasts a catch-up sync request (0 disables the
           anti-entropy protocol — elastic recovery, SURVEY §5).
        sync_window: max rounds served per sync request (bounds responder
           amplification together with the per-requester serve cap).
    """

    n: int = 4
    f: Optional[int] = None
    wave_length: int = 4
    signature_scheme: str = "none"
    verifier_backend: str = "cpu"
    coin: str = "round_robin"
    propose_empty: bool = True
    mesh_shape: Tuple[int, ...] = (1,)
    mesh_axis_names: Tuple[str, ...] = ("batch",)
    max_rounds: int = 64
    sync_patience: int = 8
    sync_window: int = 8
    # Wall-clock flood control (0 disables, e.g. in lockstep simulations):
    # a requester spaces its sync requests by at least
    # sync_request_cooldown_s, and a responder serves any one requester at
    # most once per sync_serve_cooldown_s. Rate limits rather than
    # lifetime caps: a lost response can always be re-requested later
    # (no permanent wedge), and a Byzantine requester rotating windows
    # still extracts at most one window per cooldown.
    sync_request_cooldown_s: float = 0.5
    sync_serve_cooldown_s: float = 0.2
    # Garbage-collection depth in rounds (None = unbounded, matching the
    # reference's grow-forever state, process.go:72-85). When set, the
    # ordering rule deterministically EXCLUDES vertices with
    # round <= leader_round - gc_depth from delivery (every process
    # excludes the same vertices for the same committed leader chain, so
    # the total order stays identical — the standard DAG-BFT GC trade:
    # fairness holds only for vertices admitted within the window), and
    # each process retires DAG state below its decided frontier minus
    # gc_depth (DagState.prune_below), bounding memory for long runs.
    gc_depth: Optional[int] = None
    # Host consensus pump path: "scalar" is the reference per-message /
    # per-vertex semantics; "vector" is the round-batched refinement
    # (byte-identical commit order — tests/test_pump_vector.py is the
    # gate). None resolves from DAGRIDER_PUMP, defaulting to "scalar";
    # an explicit value beats the environment.
    pump: Optional[str] = None
    # Aggregated round certificates: "off" keeps the per-vertex
    # verify path as the reference oracle; "agg" BLS-signs vertex digests
    # and lets the round's designated aggregator gossip one
    # RoundCertificate that peers check with a single aggregate pairing
    # instead of n per-vertex verifies. Same resolution rule as pump:
    # None reads DAGRIDER_CERT, explicit beats env.
    cert: Optional[str] = None
    # Quiescent step() passes a non-aggregator waits on a round's
    # certificate before giving up and re-verifying that round per-vertex
    # (the Byzantine-aggregator liveness valve). Must exceed the clean
    # cert latency of 1-2 steps and stay below sync_patience so a silent
    # aggregator degrades locally before the sync machinery fires.
    cert_patience: int = 6
    # Cert-of-certs span width k: every k
    # consecutive verified round certificates fold into one
    # SpanCertificate whose single combined pairing replaces k per-round
    # checks on catch-up consumers. 0 disables spans. Round certs keep
    # flowing regardless — spans are an overlay, never a liveness
    # dependency (receivers must not WAIT on a span). None resolves from
    # DAGRIDER_CERT_SPAN; explicit beats env, like pump/cert.
    cert_span: Optional[int] = None
    # Aggregator self-check before gossiping a certificate (and span):
    # catches local corruption at the cost of one extra aggregate
    # verify per assembly. None resolves from DAGRIDER_CERT_SELFCHECK
    # (default on); peers verify independently either way, so turning
    # it off trades early local detection for assembly latency.
    cert_selfcheck: Optional[bool] = None
    # Pipelined wave evaluation: instead of the
    # one-shot attempt at each 4-round boundary, every undecided wave
    # whose commit round has a quorum is (re)evaluated each step, so a
    # wave decides the moment its votes land rather than when the local
    # round counter happens to cross the boundary. The decided leader
    # chain — and therefore the total order — is unchanged (covering
    # lemma: a quorum of round-4w votes for L_w guarantees every later
    # leader strong-reaches L_w, so the retroactive walk is invariant
    # to attempt timing); tests pin byte-identity against the scalar
    # oracle. None resolves from DAGRIDER_WAVE_PIPELINE; explicit beats
    # env, like pump/cert.
    wave_pipeline: Optional[bool] = None
    # Eager optimistic delivery: surface each
    # decided wave's exact canonical chunk through on_deliver_early at
    # DECISION time, ahead of the (possibly deferred) canonical
    # _order_vertices flush, and reconcile the speculative log against
    # the canonical order when the flush runs. The speculative stream
    # is a prefix of the final order by construction; a reconciliation
    # mismatch is an invariant violation routed through the flight
    # recorder. None resolves from DAGRIDER_EAGER_DELIVER.
    eager_deliver: Optional[bool] = None
    # Sharded dissemination lanes: when on, each submitted
    # block whose encoding reaches lane_batch_bytes is disseminated over
    # the dedicated lane channel by worker threads, certified by 2f+1
    # signed availability acks, and proposed as a constant-size digest
    # ref; the consensus pump orders refs, delivery resolves them back
    # to payload bytes through the lane store (fetch-on-miss). Off keeps
    # inline payloads — the byte-identity oracle. None resolves from
    # DAGRIDER_LANES; explicit beats env, like pump/cert.
    lanes: Optional[bool] = None
    #: lane worker-thread count (None -> DAGRIDER_LANE_WORKERS)
    lane_workers: Optional[int] = None
    #: minimum encoded-block bytes before a block rides a lane
    #: (None -> DAGRIDER_LANE_BATCH_BYTES); smaller blocks stay inline
    lane_batch_bytes: Optional[int] = None
    # Epoch reconfiguration: when on, magic-prefixed control
    # transactions committed through the ordinary total order schedule
    # validator-set changes (join/leave/key-rotation) that take effect
    # at the next epoch boundary — a wave number every process derives
    # identically from the ordered log — rotating the threshold coin
    # keys and advancing an epoch id carried in the wire form (stale
    # pre-rotation messages are rejected at the receive seam). Off keeps
    # the static-membership oracle. None resolves from DAGRIDER_EPOCH;
    # explicit beats env, like pump/cert/lanes.
    epoch: Optional[bool] = None
    #: boundary interval in waves (None -> DAGRIDER_EPOCH_WAVES): a
    #: control tx committed in wave w activates at the next multiple
    #: of epoch_waves strictly after w
    epoch_waves: Optional[int] = None
    #: extra GC depth in rounds kept past a settled epoch's frontier
    #: (None -> DAGRIDER_EPOCH_GC; 0 = reuse gc_depth)
    epoch_gc: Optional[int] = None
    #: key-rotation mode at boundaries (None -> DAGRIDER_EPOCH_ROTATE):
    #: "seed" derives the next ThresholdKeys from a deterministic
    #: dealer seeded by the committed transcript, "dkg" runs the full
    #: joint-Feldman resharing, "none" bumps the epoch id only
    epoch_rotate: Optional[str] = None

    def __post_init__(self) -> None:
        if self.n < 1:
            raise ValueError(f"n must be >= 1, got {self.n}")
        if self.pump is None:
            object.__setattr__(self, "pump", env_choice("DAGRIDER_PUMP"))
        if self.pump not in ("scalar", "vector"):
            raise ValueError(
                f'pump must be "scalar" or "vector", got {self.pump!r}'
            )
        if self.cert is None:
            object.__setattr__(self, "cert", env_choice("DAGRIDER_CERT"))
        if self.cert not in ("off", "agg"):
            raise ValueError(
                f'cert must be "off" or "agg", got {self.cert!r}'
            )
        if self.cert_patience < 1:
            raise ValueError(
                f"cert_patience must be >= 1, got {self.cert_patience}"
            )
        if self.cert_span is None:
            object.__setattr__(self, "cert_span", env_int("DAGRIDER_CERT_SPAN"))
        if self.cert_span < 0:
            raise ValueError(
                f"cert_span must be >= 0, got {self.cert_span}"
            )
        if self.cert_selfcheck is None:
            object.__setattr__(
                self, "cert_selfcheck", env_flag("DAGRIDER_CERT_SELFCHECK")
            )
        if self.wave_pipeline is None:
            object.__setattr__(
                self, "wave_pipeline", env_flag("DAGRIDER_WAVE_PIPELINE")
            )
        if self.eager_deliver is None:
            object.__setattr__(
                self, "eager_deliver", env_flag("DAGRIDER_EAGER_DELIVER")
            )
        if self.lanes is None:
            object.__setattr__(self, "lanes", env_flag("DAGRIDER_LANES"))
        if self.lane_workers is None:
            object.__setattr__(
                self, "lane_workers", env_int("DAGRIDER_LANE_WORKERS")
            )
        if self.lane_workers < 1:
            raise ValueError(
                f"lane_workers must be >= 1, got {self.lane_workers}"
            )
        if self.lane_batch_bytes is None:
            object.__setattr__(
                self,
                "lane_batch_bytes",
                env_int("DAGRIDER_LANE_BATCH_BYTES"),
            )
        if self.lane_batch_bytes < 1:
            raise ValueError(
                f"lane_batch_bytes must be >= 1, got {self.lane_batch_bytes}"
            )
        if self.epoch is None:
            object.__setattr__(self, "epoch", env_flag("DAGRIDER_EPOCH"))
        if self.epoch_waves is None:
            object.__setattr__(
                self, "epoch_waves", env_int("DAGRIDER_EPOCH_WAVES")
            )
        if self.epoch_waves < 1:
            raise ValueError(
                f"epoch_waves must be >= 1, got {self.epoch_waves}"
            )
        if self.epoch_gc is None:
            object.__setattr__(self, "epoch_gc", env_int("DAGRIDER_EPOCH_GC"))
        if self.epoch_gc < 0:
            raise ValueError(f"epoch_gc must be >= 0, got {self.epoch_gc}")
        if self.epoch_rotate is None:
            object.__setattr__(
                self, "epoch_rotate", env_choice("DAGRIDER_EPOCH_ROTATE")
            )
        if self.epoch_rotate not in ("seed", "dkg", "none"):
            raise ValueError(
                f'epoch_rotate must be "seed", "dkg" or "none", '
                f"got {self.epoch_rotate!r}"
            )
        if self.f is None:
            object.__setattr__(self, "f", (self.n - 1) // 3)
        if self.n < 3 * self.f + 1:
            raise ValueError(
                f"need n >= 3f+1 for BFT resilience, got n={self.n}, f={self.f}"
            )
        if self.wave_length < 1:
            raise ValueError("wave_length must be >= 1")
        if self.signature_scheme not in ("none", "ed25519", "bls12381"):
            raise ValueError(f"unknown signature scheme {self.signature_scheme!r}")
        if self.verifier_backend not in ("cpu", "tpu"):
            raise ValueError(f"unknown verifier backend {self.verifier_backend!r}")
        if self.coin not in ("fixed", "round_robin", "threshold_bls"):
            raise ValueError(f"unknown coin {self.coin!r}")
        if self.gc_depth is not None:
            # The horizon must sit safely below everything the live
            # machinery touches: catch-up sync windows, the current
            # wave's 4 rounds, and one wave of retroactive leader walk.
            floor = self.sync_window + 2 * self.wave_length
            if self.gc_depth < floor:
                raise ValueError(
                    f"gc_depth must be >= sync_window + 2*wave_length "
                    f"({floor}), got {self.gc_depth}"
                )

    @property
    def quorum(self) -> int:
        """2f+1 — the quorum threshold used everywhere the reference uses it
        (round advance ``process.go:236``, admission ``process.go:165``,
        commit ``process.go:337``)."""
        return 2 * self.f + 1

    def wave_round(self, wave: int, k: int) -> int:
        """round(w, k) = wave_length*(w-1) + k, 1-indexed k in [1, wave_length].

        Mirrors ``waveRound`` (reference ``process/process.go:394-402``);
        waves are 1-indexed, round 0 is the genesis round.
        """
        if not 1 <= k <= self.wave_length:
            raise ValueError(f"k must be in [1, {self.wave_length}], got {k}")
        return self.wave_length * (wave - 1) + k

    def wave_of_round(self, rnd: int) -> int:
        """Inverse: which wave a round >= 1 belongs to."""
        if rnd < 1:
            raise ValueError("rounds >= 1 belong to waves; round 0 is genesis")
        return (rnd - 1) // self.wave_length + 1


@dataclasses.dataclass(frozen=True)
class MempoolConfig:
    """Knobs for the ingestion edge (``dag_rider_tpu/mempool/``).

    Dataclass defaults < env < explicit :meth:`from_dict` values — so a
    deployed fleet is retunable via environment without editing every
    node's JSON config, and a config file still wins when it speaks up.

    Env knobs: ``DAGRIDER_MEMPOOL_CAP`` (pool capacity, transactions),
    ``DAGRIDER_BATCH_BYTES`` (target payload bytes per built block),
    ``DAGRIDER_BATCH_DEADLINE_MS`` (max hold latency before a partial
    batch ships), ``DAGRIDER_ADMIT_WATERMARKS`` ("low,high" pool-fill
    fractions driving accept → throttle → shed), and
    ``DAGRIDER_MEMPOOL_TTL_S`` (pending-transaction eviction age).

    Attributes:
        cap: max pending transactions the pool holds; adds beyond it shed.
        batch_bytes: the batcher packs blocks up to this many payload
            bytes (a single oversized transaction still ships alone).
        batch_deadline_ms: a non-empty pool older than this flushes a
            partial block — bounds client latency at low load.
        admit_low / admit_high: pool-fill watermarks. Below low every
            source is accepted (subject to ``source_rate``); between them
            each source is throttled to ``throttle_rate`` tx/s; at or
            above high everything sheds.
        ttl_s: pending transactions older than this are evicted (they
            were accepted but never packed — a stalled cluster must not
            pin client payloads forever).
        source_rate: per-source hard rate cap in tx/s applied even in
            the accept band (0 = uncapped).
        throttle_rate: per-source tx/s allowed inside the throttle band.
        source_burst: token-bucket burst depth for both rate caps.
        max_batch_txs: hard cap on transactions per built block (guards
            the wire codec against pathological many-tiny-tx blocks).
        max_staged_blocks: stop pulling built blocks into
            ``Process.blocks_to_propose`` while it already holds this
            many — DAG-Rider proposes ONE block per round, so under
            sustained overload the proposal queue is the next unbounded
            buffer after the pool; capping it keeps excess transactions
            *in* the pool where the watermarks can see them and shed.
    """

    cap: int = 65536
    batch_bytes: int = 8192
    batch_deadline_ms: float = 50.0
    admit_low: float = 0.5
    admit_high: float = 0.9
    ttl_s: float = 60.0
    source_rate: float = 0.0
    throttle_rate: float = 64.0
    source_burst: float = 32.0
    max_batch_txs: int = 1024
    max_staged_blocks: int = 16
    #: DAGRIDER_ADAPTIVE_DEADLINE: when True the
    #: Mempool drives the batcher's EFFECTIVE deadline from the live
    #: submit→deliver histogram — a 50 ms hold is noise against a 10 s
    #: end-to-end path but a third of a sub-second one, so the deadline
    #: tracks a small fraction of the measured p50 (floored at 1 ms,
    #: capped at the configured batch_deadline_ms). Off by default:
    #: adaptive packing changes block contents, so byte-identity A/B
    #: suites must keep it off.
    adaptive_deadline: bool = False

    def __post_init__(self) -> None:
        if self.cap < 1:
            raise ValueError(f"mempool cap must be >= 1, got {self.cap}")
        if self.batch_bytes < 1:
            raise ValueError(
                f"batch_bytes must be >= 1, got {self.batch_bytes}"
            )
        if self.batch_deadline_ms < 0:
            raise ValueError(
                f"batch_deadline_ms must be >= 0, got {self.batch_deadline_ms}"
            )
        if not 0.0 <= self.admit_low <= self.admit_high <= 1.0:
            raise ValueError(
                "admission watermarks need 0 <= low <= high <= 1, got "
                f"low={self.admit_low}, high={self.admit_high}"
            )
        if self.ttl_s <= 0:
            raise ValueError(f"ttl_s must be > 0, got {self.ttl_s}")
        if self.source_rate < 0:
            raise ValueError(
                f"source_rate must be >= 0, got {self.source_rate}"
            )
        if self.throttle_rate <= 0:
            raise ValueError(
                f"throttle_rate must be > 0, got {self.throttle_rate}"
            )
        if self.source_burst < 1:
            raise ValueError(
                f"source_burst must be >= 1, got {self.source_burst}"
            )
        if self.max_batch_txs < 1:
            raise ValueError(
                f"max_batch_txs must be >= 1, got {self.max_batch_txs}"
            )
        if self.max_staged_blocks < 1:
            raise ValueError(
                f"max_staged_blocks must be >= 1, got {self.max_staged_blocks}"
            )

    @classmethod
    def from_env(cls) -> "MempoolConfig":
        low, high = cls._env_watermarks()
        return cls(
            cap=env_int("DAGRIDER_MEMPOOL_CAP", cls.cap),
            batch_bytes=env_int("DAGRIDER_BATCH_BYTES", cls.batch_bytes),
            batch_deadline_ms=env_float(
                "DAGRIDER_BATCH_DEADLINE_MS", cls.batch_deadline_ms
            ),
            admit_low=low,
            admit_high=high,
            ttl_s=env_float("DAGRIDER_MEMPOOL_TTL_S", cls.ttl_s),
            adaptive_deadline=env_flag("DAGRIDER_ADAPTIVE_DEADLINE"),
        )

    @staticmethod
    def _env_watermarks() -> Tuple[float, float]:
        raw = env_str("DAGRIDER_ADMIT_WATERMARKS")
        if not raw:
            return MempoolConfig.admit_low, MempoolConfig.admit_high
        parts = raw.split(",")
        if len(parts) != 2:
            raise ValueError(
                f'DAGRIDER_ADMIT_WATERMARKS must be "low,high", got {raw!r}'
            )
        return float(parts[0]), float(parts[1])

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "MempoolConfig":
        """Env-seeded config with explicit overrides; unknown keys raise
        (a typo'd knob silently falling back to defaults is exactly the
        class of config bug this repo's explicit-knob rule exists to
        kill)."""
        base = dataclasses.asdict(cls.from_env())
        if d:
            fields = {f.name for f in dataclasses.fields(cls)}
            unknown = set(d) - fields
            if unknown:
                raise ValueError(
                    f"unknown mempool config keys: {sorted(unknown)}"
                )
            base.update(d)
        return cls(**base)


def env_set(name: str, value: str) -> None:
    """Set a registered knob in this process's environment, for what the
    process builds after the call (a command that forces a knob on for
    itself); an unregistered name raises ``KeyError``, as a read does."""
    _raw(name)
    os.environ[name] = value
