"""Byzantine-adversary x WAN scenario runner with checked invariants.

The port's copy of ``dag_rider_tpu/consensus/scenarios.py``.

One entry point (:func:`run_scenario`) wires the three robustness layers
built into a single reproducible experiment:

- a seeded :class:`~dag_rider_tpu_torch.consensus.adversary.ByzantineBehavior`
  driving up to f :class:`ByzantineProcess` instances (always the LOWEST
  indices — the threshold coin's ``aggregate`` walks shares sorted by
  source, so a garbage share from a low index deterministically lands in
  the first combination attempt instead of hiding behind honest shares),
- a :class:`~dag_rider_tpu_torch.transport.faults.WanTopology` on the fault
  transport: per-link RTT/jitter/drop matrices, geo regions, and
  partitions that heal on schedule (held, never lost),
- every invariant from :mod:`dag_rider_tpu_torch.consensus.invariants`,
  asserted BOTH online (an :class:`InvariantMonitor` raises at the exact
  delivery that breaks safety) and post-hoc over the full honest logs.

A scenario that returns at all has passed agreement, commit-uniqueness,
zero-loss, and bounded-liveness; the report carries the detection and
containment counters (equivocations detected, forged edges rejected,
garbage coin shares filtered, sync serves) so callers can additionally
assert the attack genuinely ran — see tests/test_adversary.py and the
``ladder.byzantine`` bench rung.

CLI (the tier1-byz CI lane):

    python -m dag_rider_tpu_torch.consensus.scenarios --matrix --n 4
    python -m dag_rider_tpu_torch.consensus.scenarios --adversary equivocate \\
        --wan regions --n 7 --cycles 200
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import List, Optional, Tuple

from dag_rider_tpu_torch.config import Config
from dag_rider_tpu_torch.consensus import invariants as inv
from dag_rider_tpu_torch.consensus.adversary import (
    ADVERSARIES,
    ByzantineProcess,
    make_behavior,
)
from dag_rider_tpu_torch.consensus.simulator import Simulation
from dag_rider_tpu_torch.core.types import Block
from dag_rider_tpu_torch.transport.faults import (
    FaultPlan,
    FaultyTransport,
    LinkPlan,
    Partition,
    WanTopology,
)

#: WAN profiles understood by :func:`build_topology`
WAN_PROFILES = ("lan", "wan", "regions", "partition")


@dataclasses.dataclass
class Scenario:
    """One adversary x topology experiment. ``cycles`` x ``dt`` is the
    virtual duration; None picks a profile-appropriate default."""

    name: str = ""
    n: int = 4
    adversary: Optional[str] = None  # one of ADVERSARIES, or None=clean
    wan: str = "lan"  # one of WAN_PROFILES
    #: Byzantine node count; None = cfg.f when an adversary is set.
    #: Always clamped to cfg.f — the suite tests f-bounded adversaries.
    byzantine: Optional[int] = None
    seed: int = 0
    cycles: Optional[int] = None
    dt: float = 0.01
    #: Bracha RBC stage. None resolves to True exactly where safety
    #: needs it: split equivocation (disjoint variants to disjoint
    #: halves), and any equivocation under jittery links (per-link
    #: jitter can reorder the two variants per destination, so
    #: first-VAL-wins no longer agrees across honest nodes).
    rbc: Optional[bool] = None
    #: "round_robin" (default) or "threshold_bls"; None resolves to
    #: threshold for the garbage_coin adversary (its target) and
    #: round_robin everywhere else.
    coin: Optional[str] = None
    #: liveness floors handed to check_liveness after the drain
    min_waves: int = 2
    min_each: int = 1
    blocks_per_process: int = 3
    #: dissemination lanes. None resolves to forced-on for the
    #: lane_* adversaries (their attack surface IS the lane layer) and
    #: otherwise defers to the DAGRIDER_LANES env default — under which
    #: the stock 32-byte scenario blocks sit below the lane batch floor
    #: and ship inline, so the legacy matrix is byte-identical either way.
    lanes: Optional[bool] = None
    #: epoch reconfiguration. None resolves to forced-on for
    #: the stale_epoch adversary (its attack surface IS the wire stale
    #: gate) and off everywhere else — epoch scenarios inject one
    #: ``rotate`` control op at the start so a boundary genuinely
    #: crosses mid-run. Coin stays round_robin here: the matrix's
    #: shared-book threshold factory cannot rotate per-process keys.
    epoch: Optional[bool] = None
    epoch_waves: int = 4

    def __post_init__(self) -> None:
        if self.adversary is not None and self.adversary not in ADVERSARIES:
            raise ValueError(
                f"unknown adversary {self.adversary!r} "
                f"(choose from {ADVERSARIES})"
            )
        if self.wan not in WAN_PROFILES:
            raise ValueError(
                f"unknown WAN profile {self.wan!r} (choose from {WAN_PROFILES})"
            )
        if not self.name:
            self.name = f"{self.adversary or 'clean'}/{self.wan}"

    def resolved_cycles(self) -> int:
        if self.cycles is not None:
            return self.cycles
        if self.coin_kind() == "threshold_bls":
            # threshold aggregation is host-tower pairing math (~0.3s+
            # per wave); keep the wave count small
            return 10
        return 48 if self.wan == "lan" else 160

    def coin_kind(self) -> str:
        if self.coin is not None:
            return self.coin
        return (
            "threshold_bls"
            if self.adversary == "garbage_coin"
            else "round_robin"
        )

    def resolved_lanes(self) -> bool:
        if self.lanes is not None:
            return self.lanes
        return self.adversary in ("lane_withhold", "lane_garbage_ack")

    def resolved_epoch(self) -> bool:
        if self.epoch is not None:
            return self.epoch
        return self.adversary == "stale_epoch"

    def resolved_rbc(self) -> bool:
        if self.rbc is not None:
            return self.rbc
        if self.adversary == "equivocate_split":
            return True
        return self.adversary == "equivocate" and self.wan != "lan"


def build_topology(
    sc: Scenario, duration: float
) -> Optional[WanTopology]:
    """Scenario WAN profile -> topology (None = direct LAN delivery).

    - ``wan``: uniform moderate-latency links with light loss/duplication
      — the sync/anti-entropy stress shape.
    - ``regions``: geo-replicated clusters (cheap intra, 40ms inter).
    - ``partition``: regions plus one cut that severs the LAST f nodes
      (the honest tail — Byzantine nodes sit at the low indices) from
      25% to 60% of the run, healing with all held traffic released.
      n - f >= 2f+1 nodes stay connected, so the majority side keeps
      committing while the minority is dark.
    """
    if sc.wan == "lan":
        return None
    if sc.wan == "wan":
        return WanTopology(
            default=LinkPlan(
                rtt_s=0.02, jitter_s=0.004, drop=0.005, duplicate=0.01
            )
        )
    cfg_f = (sc.n - 1) // 3
    partitions: Tuple[Partition, ...] = ()
    if sc.wan == "partition":
        m = max(1, cfg_f)
        partitions = (
            Partition(
                start_s=0.25 * duration,
                heal_s=0.60 * duration,
                groups=(
                    tuple(range(sc.n - m)),
                    tuple(range(sc.n - m, sc.n)),
                ),
            ),
        )
    return WanTopology.regions(
        sc.n, k=min(4, sc.n), partitions=partitions
    )


def _coin_factory(kind: str, n: int, f: int, device=None):
    """round_robin -> None (the Config default); threshold_bls -> real
    (f+1)-of-n BLS coins sharing one set of share/sigma books (the bench
    idiom): share SIGNING stays per-process and real, but each wave's
    aggregation + bad-share recovery runs once for the cluster instead
    of once per process — pure-Python pairings are too slow to repeat
    n times per wave in a scenario sweep.

    The port's seam: ``device`` goes to every coin, whose combine runs
    the MSM on the card unless the caller passes ``"cpu"`` (the plain
    torch path); without a card and without ``"cpu"`` the coins raise."""
    if kind != "threshold_bls":
        return None
    from dag_rider_tpu_torch.consensus.coin import ThresholdCoin
    from dag_rider_tpu_torch.crypto import threshold as th

    keys = th.ThresholdKeys.generate(n, f + 1)
    oracle = ThresholdCoin(keys, 0, n, device=device)

    def factory(i: int):
        c = ThresholdCoin(keys, i, n, device=device)
        c._shares = oracle._shares
        c._sigma = oracle._sigma
        c._tried_at = oracle._tried_at
        c.prune_below = lambda wave: None  # shared books: nobody prunes
        return c

    return factory


def run_scenario(sc: Scenario, device=None) -> dict:
    """Run one scenario end to end and audit every invariant.

    Raises :class:`~dag_rider_tpu_torch.consensus.invariants.InvariantViolation`
    (online, at the offending delivery, or in the post-run audit) if the
    honest cluster ever breaks agreement, commits an equivocation, loses
    an accepted transaction, or stalls below the liveness floor. Returns
    the report dict on success.

    ``device`` is where the threshold coins combine (the port's seam,
    passed to :func:`_coin_factory`): ``cuda`` unless the caller passes
    ``"cpu"``."""
    cfg = Config(
        n=sc.n,
        propose_empty=True,
        # None defers to the DAGRIDER_LANES env default (tier1-lanes CI
        # runs the whole legacy matrix with lanes on; 32-byte blocks
        # stay inline there by the batch-size floor)
        lanes=True if sc.resolved_lanes() else None,
        epoch=True if sc.resolved_epoch() else False,
        epoch_waves=sc.epoch_waves,
        # virtual-time lockstep: wall-clock flood control off
        sync_request_cooldown_s=0.0,
        sync_serve_cooldown_s=0.0,
    )
    nbyz = 0
    if sc.adversary is not None:
        nbyz = cfg.f if sc.byzantine is None else sc.byzantine
        nbyz = max(0, min(nbyz, cfg.f))
    byz = tuple(range(nbyz))  # low indices: see module docstring
    behaviors = {
        i: make_behavior(sc.adversary, seed=sc.seed + 1000 + i)
        for i in byz
    }

    cycles = sc.resolved_cycles()
    topo = build_topology(sc, duration=cycles * sc.dt)
    tp = FaultyTransport(FaultPlan(seed=sc.seed), topology=topo)

    def process_factory(pcfg, i, ptp, **kwargs):
        if i in behaviors:
            return ByzantineProcess(
                pcfg, i, ptp, behavior=behaviors[i], **kwargs
            )
        from dag_rider_tpu_torch.consensus.process import Process

        return Process(pcfg, i, ptp, **kwargs)

    sim = Simulation(
        cfg,
        transport=tp,
        coin_factory=_coin_factory(sc.coin_kind(), cfg.n, cfg.f, device=device),
        rbc=sc.resolved_rbc(),
        process_factory=process_factory,
    )
    monitor = sim.attach_invariant_monitor(exclude=byz)

    honest = [i for i in range(cfg.n) if i not in set(byz)]
    accepted: set = set()
    # Lane scenarios pad past the batch floor so every block actually
    # takes the lane path; everything else keeps the 32-byte legacy shape.
    pad = 2 * cfg.lane_batch_bytes if sc.resolved_lanes() else 32
    for i in honest:
        for k in range(sc.blocks_per_process):
            tx = f"s{sc.seed}-p{i}-b{k}".encode().ljust(pad, b".")
            accepted.add(tx)
            sim.processes[i].submit(Block((tx,)))
    if sc.resolved_epoch():
        # one committed rotate op -> a deterministic boundary crosses
        # mid-run; the op itself is an accepted tx, so zero-loss also
        # proves control traffic survives the adversary
        from dag_rider_tpu_torch.core.codec import encode_epoch_op
        from dag_rider_tpu_torch.core.types import EpochOp

        op = encode_epoch_op(EpochOp("rotate", 0, sc.seed, b""))
        accepted.add(op)
        sim.processes[honest[0]].submit(Block((op,)))
    if sc.resolved_lanes():
        # Byzantine lane workers only misbehave on their OWN publishes
        # (withhold their own batches / garble their acks), so feed them
        # blocks too. Excluded from `accepted`: zero-loss is an
        # honest-input property; recovery of Byzantine payloads is what
        # fetch-on-miss at honest delivery proves.
        for i in byz:
            for k in range(sc.blocks_per_process):
                tx = f"s{sc.seed}-byz{i}-b{k}".encode().ljust(pad, b"!")
                sim.processes[i].submit(Block((tx,)))

    # Per-cycle pump budget: ~a round's worth of deliveries. Bracha
    # multiplies every VAL by ~2n (echo + ready fan-outs), so RBC runs
    # need 2n x the budget — starving them turns latency into a sync
    # churn spiral (serves re-enter RBC and eat the whole budget).
    chunk = 2 * cfg.n * cfg.n * (2 * cfg.n if sc.resolved_rbc() else 1)
    for _ in range(cycles):
        if sim.run(max_messages=chunk) == 0:
            # Idle tick: the pump steps each process exactly ONCE when
            # the queue is empty, but an idle cluster is exactly where
            # sync patience must accrue (withholding wedges, post-
            # partition catch-up). One step per cycle makes recovery
            # glacial at n=32 — grant a burst of silent steps so a
            # patience window fits inside a couple of cycles.
            for _ in range(cfg.sync_patience or 4):
                sim.run(max_messages=chunk)
        tp.advance(sc.dt)
    # drain: release everything in flight (partition holds included) and
    # give laggards pump budget to catch up past the liveness floor
    for _ in range(6):
        tp.flush_delayed()
        sim.run(max_messages=2 * chunk)

    # Post-hoc audits raise InvariantViolation directly (no delivery
    # callback to hook); route them through the event stream so the
    # flight recorder — when tracing is on — dumps its last-N ring and
    # metrics snapshots before the exception propagates. The ONLINE
    # monitor needs no such wrapper: it emits invariant_violation at the
    # offending delivery, which the flight sink auto-dumps on.
    try:
        logs = {i: inv.delivery_records(sim.deliveries[i]) for i in honest}
        inv.check_agreement(logs)
        inv.check_commit_uniqueness(logs)

        retained: set = set()
        for i in honest:
            p = sim.processes[i]
            for b in p.blocks_to_propose:
                retained.update(b.transactions)
            for v in p.dag.vertices.values():
                b = v.block
                if p.lanes is not None:
                    # undelivered carrier vertices retain their payload
                    # through the lane store; a local miss (withheld
                    # batch not yet fetched) falls back to the carrier
                    # ref — some other honest holder retains the bytes
                    b = p.lanes.peek_block(b) or b
                retained.update(b.transactions)
        audit = inv.transaction_audit(
            accepted,
            (
                (tx for v in sim.deliveries[i] for tx in v.block.transactions)
                for i in honest
            ),
            retained,
        )
        inv.check_zero_loss(audit)

        decided = {i: sim.processes[i].decided_wave for i in honest}
        inv.check_liveness(
            decided, min_max=sc.min_waves, min_each=sc.min_each
        )
    except inv.InvariantViolation as e:
        if sim.log.enabled:
            sim.log.event(
                "invariant_violation",
                view="posthoc",
                kind="audit",
                detail=str(e)[:500],
            )
        raise

    def _counter(name: str) -> int:
        return sum(
            sim.processes[i].metrics.counters.get(name, 0) for i in honest
        )

    behavior_stats = {"mutated": 0, "withheld": 0, "extra_sent": 0}
    for b in behaviors.values():
        for k, v in b.stats.items():
            behavior_stats[k] = behavior_stats.get(k, 0) + v
    flight_dumps = (
        [str(p) for p in sim.flight.dumps] if sim.flight is not None else []
    )
    return {
        "name": sc.name,
        "n": cfg.n,
        "f": cfg.f,
        "byzantine": list(byz),
        "adversary": sc.adversary,
        "wan": sc.wan,
        "rbc": sc.resolved_rbc(),
        "coin": sc.coin_kind(),
        "seed": sc.seed,
        "cycles": cycles,
        "rounds": max(sim.processes[i].round for i in honest),
        "decided_waves": {
            "min": min(decided.values()),
            "max": max(decided.values()),
        },
        "delivered": {
            "min": min(len(logs[i]) for i in honest),
            "max": max(len(logs[i]) for i in honest),
        },
        "audit": audit,
        # detection / containment counters — callers assert on these to
        # prove the attack was not vacuous
        "equivocations_detected": _counter("equivocations_detected"),
        "edge_rejects": _counter("msgs_rejected_edges"),
        "sync_requested": _counter("sync_requested"),
        "sync_served": _counter("sync_served"),
        "coin_filtered": sum(
            getattr(sim.processes[i].coin, "filtered", 0)
            for i in range(cfg.n)
        ),
        "lanes": bool(cfg.lanes),
        "epoch": bool(cfg.epoch),
        "epoch_boundaries": _counter("epoch_boundaries"),
        "epoch_min": (
            min(
                sim.processes[i].metrics.counters.get("epoch_current", 0)
                for i in honest
            )
            if cfg.epoch
            else 0
        ),
        "epoch_stale_rejected": _counter("epoch_stale_rejected"),
        "lane_batches_certified": _counter("lane_batches_certified"),
        "lane_fetch_misses": _counter("lane_fetch_misses"),
        "lane_publish_degraded": _counter("lane_publish_degraded"),
        "lane_acks_rejected": _counter("lane_acks_rejected"),
        "behavior": behavior_stats,
        "transport": dict(tp.stats),
        "monitor": monitor.stats(),
        "flight_dumps": flight_dumps,
        "invariants": {
            "agreement": True,
            "commit_uniqueness": True,
            "zero_loss": True,
            "liveness": True,
        },
    }


def default_matrix(
    n: int = 4, seed: int = 0, cycles: Optional[int] = None
) -> List[Scenario]:
    """The CI sweep: every adversary class on LAN, a clean WAN + a clean
    partition-then-heal run, and equivocation under geo regions (where
    jitter forces the RBC stage to earn its keep)."""
    mk = lambda **kw: Scenario(n=n, seed=seed, cycles=cycles, **kw)  # noqa: E731
    return [
        mk(),
        mk(wan="partition"),
        mk(adversary="equivocate"),
        mk(adversary="equivocate_split"),
        mk(adversary="withhold"),
        mk(adversary="invalid_edges"),
        mk(adversary="garbage_coin"),
        mk(adversary="lane_withhold"),
        mk(adversary="lane_garbage_ack"),
        mk(adversary="equivocate", wan="regions"),
        mk(adversary="stale_epoch"),
        # straggler-join: the honest tail is dark while the boundary
        # commits; on heal it must sync across the epoch (the sync /
        # sync_nack exemption from the stale gate is what lets a
        # behind-the-epoch node discover it is behind at all)
        mk(name="epoch_straggler", epoch=True, wan="partition"),
    ]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Byzantine x WAN scenario runner (checked invariants)"
    )
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cycles", type=int, default=None)
    ap.add_argument(
        "--adversary", choices=ADVERSARIES, default=None
    )
    ap.add_argument("--wan", choices=WAN_PROFILES, default="lan")
    ap.add_argument(
        "--epoch",
        action="store_true",
        help="force epoch reconfiguration on (a rotate op is injected)",
    )
    ap.add_argument(
        "--matrix",
        action="store_true",
        help="run the default scenario sweep instead of one scenario",
    )
    args = ap.parse_args(argv)

    if args.matrix:
        scenarios = default_matrix(
            n=args.n, seed=args.seed, cycles=args.cycles
        )
    else:
        scenarios = [
            Scenario(
                n=args.n,
                seed=args.seed,
                cycles=args.cycles,
                adversary=args.adversary,
                wan=args.wan,
                epoch=True if args.epoch else None,
            )
        ]
    reports = []
    for sc in scenarios:
        print(f"# {sc.name} ...", file=sys.stderr, flush=True)
        reports.append(run_scenario(sc))
    print(json.dumps(reports, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
