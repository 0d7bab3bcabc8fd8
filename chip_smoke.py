#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one NVIDIA card.

Two paths, each through the hand-written CUDA kernels, the round
certificate lane around the second, the parallel layer (the windowed
oracle, the round step, the sharded verifier, BASELINE config #5 at
n = 1,024), and then the consensus loop that runs them all. The main path is
round signature verification: a committee of n = 256 validators, 16 DAG
rounds of 256 signed vertices (171 strong edges each), verified by
``CUDAVerifier.verify_rounds`` as one merged 4,096-signature dispatch.
The second is the BLS12-381 G1 multi-scalar multiplication at n = 256:
the threshold coin (``ThresholdCoin`` with ``msm=bls_msm.msm`` combining
f + 1 = 86 shares, and filtering a Byzantine share) and round-certificate
aggregation (``CertVerifier(msm="device")`` summing 2f + 1 = 171
signatures). The script:

1. prints the card's name and power limit, builds the kernels from
   ``dag_rider_tpu_torch/csrc`` with nvcc, and prints the ptxas register
   and spill report; builds the native challenge library
   (``csrc/challenge.cpp``, g++) and prints its build seconds; loads the
   card's context and the kernel libraries;
2. builds the n = 256 registry and the device comb tables, the table
   path: the counters at 0 just before ``comb_tables()`` and read just
   after (exactly two ``key_tables`` launches, nothing else), the tables
   byte-identical to the plain build on the card, the build's wall, its
   kernels' time and its bound; runs
   ``CUDAVerifier.warmup`` at the path's bucket (no dispatch counter
   booked), and signs the rounds, with a seeded subset corrupted (bad
   signature bit, another vertex's signature, out-of-range source,
   s >= L, non-canonical R, missing signature, tampered block);
3. kernel phase: each kernel against its plain torch version on the card
   at the path's widths, exactly, timed with CUDA events beside the plain
   version and a lower bound on the card's time: the per-lane addition
   ``padd_xx`` (the tree's unit kernel; also at 256, 1,024, 4,096,
   16,384 and 262,144 lanes in a CUDA graph), the one-launch comb tree
   ``tree_sum_xyzt``, the finish tail (on the real rows with the edge rows
   of ``tests/torch_edge_rows.py`` mixed in) and ``pow22523`` (with edge
   limbs mixed in), each also replayed in a CUDA graph, and the field
   multiply, whose kernel alone is also timed in a CUDA graph at 4,096
   and 262,144 lanes;
4. path phase: launch counters set to 0, one ``verify_rounds`` call, the
   counters read (one ``tree_sum_xyzt`` and one ``finish_check`` launch,
   no ``padd_xx``); the mask must equal the host oracle on the corrupted
   rows and a seeded sample of the valid ones, and the all-plain torch
   path on the card on every row; then the dispatch time (median of
   several, host prep and device split), sigs/s, peak device memory, and
   the device time split into copies, gather, tree and finish;
5. host prep phase, on the same 4,096 rows: every row hashed so far took
   the native route; the prep arrays byte-identical at 1 worker and at
   W = min(4, cpus) workers (native) and at 1 worker with
   ``DAGRIDER_NATIVE=0``, each timed (median of 7, the three in turns)
   beside ``prep_stats()``;
   ``verify_rounds`` streamed in 8 chunks of 512 at depth 1 and 2
   (prep-ahead; three runs each, in turns), masks equal to the merged dispatch's with exactly 8
   ``tree_sum_xyzt`` and 8 ``finish_check`` launches, wall and host/device
   split; then seeded ``dispatch_raise`` and ``resolve_raise`` faults
   (two each) contained with a second card verifier as the quarantine
   tier (windows poisoned, chunks quarantined, none rejected, the same
   masks), and a clean run after disarming;
6. 8-bit comb phase (``DAGRIDER_COMB_BITS=8``): the n = 256 tables' build
   through the table path (two ``key_tables8`` launches, byte-identical to
   the plain build on the card), its time and bytes, one merged dispatch with exactly one ``tree_sum_xyzt``
   (32 entries a group) and one ``finish_check``, its mask equal to the
   4-bit mask on every row and the host oracle on the sample, its wall and
   split, and the tree kernel at M = 32 against its plain version, exactly,
   timed with CUDA events and in a CUDA graph beside its bound;
7. BLS phases: the cooperative ``padd381_xx`` against its plain version
   on real curve points at 1, 128, 4,096, 8,192 and 65,536 lanes, and
   ``horner381`` (the Horner chain and the canonical form in one launch)
   against its plain version on the coin's and the certificate's real
   window sums, exactly, timed beside their bounds; then, with the
   counters set to 0 before each and read after, one coin wave (sigma and
   leader byte-identical to the host coin), one wave with a corrupted
   share (the same ``filtered`` count, sigma and leader as the host coin),
   and one certificate (``agg_sig`` byte-identical to the host group law),
   each MSM with exactly 15 + log2 T ``padd381_xx`` launches and one
   ``horner381``; the certificate's aggregate check through the device
   pairing (``ops/bls_pairing.py``: 172 pairs), its Miller product equal
   to the host's exactly and both verdicts True, the check's wall split
   into host set-up, line evaluation, cross-pair tree, schedule walk
   (from its CUDA graph and eager), ``canonical`` and the host final
   exponentiation, with its torch ops, kernels and device time (CUDA
   profiler), peak memory and bound; forged certificates and the
   Byzantine matrix of ``tests/test_cert_phase2.py`` on the card, verdicts
   equal to the host's; the MSM's wall time and its device split into
   tables, gather, tree and ``horner381``, launched from the host and
   replayed as a CUDA graph (the card's time alone); then four round
   certificates folded into a span (685 pairs): its aggregate
   byte-identical to the host group law's with one 4-point MSM's
   launches, ``verify_span`` True on the card and False for each of six
   mutations; then ``sign_many`` over 173 rows on the ``native`` (C,
   ctypes) and ``device`` lanes byte-identical to ``sign`` with no row on
   a host route, beside the host lane, and the device ladder alone,
   eager and replayed step by step from a CUDA graph;
8. consensus phase: the port's ``Simulation`` runs DAG-Rider at n = 256
   (threshold-BLS coin, ``propose_empty``, ``gc_depth`` 24, two blocks a
   process) with one shared ``CUDAVerifier`` (coalesced, pipelined) and
   threshold coins whose MSM runs on the card and which share one
   oracle's books (``shared_coin_factory``), ``run(max_messages=256 *
   255)`` until every view decided ``CONS_WAVES`` waves, with the counters
   set to 0 just before and read just after (one chunk a pump cycle, so
   the pipeline's dispatches run ``prep_batch`` and ``dispatch_prepped``
   in turn; ``prep_batch_async`` engages from two chunks a cycle):
   ``tree_sum_xyzt`` and ``finish_check`` once per pipeline dispatch,
   ``padd381_xx`` and ``horner381`` exactly as the coin's MSMs require,
   nothing contained;
   then the same construction with the host oracles (``CPUVerifier``,
   ``msm="host"``) and the same ``run`` calls, whose logs, leaders and
   decided waves must be byte-identical; prints rounds, waves, deliveries,
   messages, signatures applied and dispatched, sigs/s, the wave-commit
   and wave-interval p50, the seam and MSM walls and each run's host
   split, and holds the comb kernels against their plain versions at the
   phase's dispatch width;
9. consensus with certificates (``BASELINE.json`` config #4 whole): the
   cluster of phase 8 with ``CERT_BLOCKS`` blocks a process and no empty
   proposals, run until quiet, without and then with aggregate round
   certificates (certificate MSM and pairing on the card): logs, leaders
   and decided waves byte-identical, certificates assembled, signatures
   saved, none rejected, fewer signatures verified, nothing contained, no
   host route, launches exact; the wall, admitted and dispatched sigs/s,
   wave-commit and wave-interval p50, pairing checks and their wall, and
   the host split (certificate-share signing included);
10. windowed oracle (after the 8-bit phase): ``CUDAVerifier(comb=False)``
   on the verify phase's 4,096 rows, exactly 80 ``padd_xx`` and one
   ``pow22523`` launch, its mask equal to the comb mask and the host
   oracle's sample, the device program eager and with its walk replayed
   from a step graph, its torch ops and bound; then the round step
   (``make_round_step(mesh_from_env(), quorum=171)``) on round 4 and wave 1
   of the verify DAG against the numpy twins, and ``wave_commit_votes`` at
   n = 256 and 1,024; then the sharded verifier through
   ``VerifierPipeline(depth=2)`` on one card, ``mesh_from_env()`` and
   ``virtual_mesh(4)`` (masks equal, launches k a chunk, sigs/s in turns)
   and one ``virtual_mesh(5)`` dispatch;
11. BASELINE config #5 (after the BLS phases): n = 1,024, its comb tables
   through the table path (two ``key_tables`` launches, byte-identical to
   the plain build on the card), 4 rounds signed in spawn workers, 64 corrupted, one merged dispatch through
   ``ShardedCUDAVerifier`` on ``mesh_from_env()``, the T = 1,024 MSM
   through ``ShardedMSM()`` and 683 signatures summed by
   ``CertVerifier(msm="sharded")``, launches exact; masks equal to
   ``CUDAVerifier`` and the host oracle's sample, the MSM to
   ``bls_msm.msm``, the host group law and ``virtual_mesh(4)``;
12. consensus with ``verifier="sharded"`` (after phase 9): phase 8's
   cluster and number of ``run`` calls, byte-identical to phase 8's
   device run, launches exact, nothing contained;
13. the host layer's paths (phases A-F, each with the counters set to 0
   just before its runs and read just after): A, client transactions
   into DAG-Rider at n = 256 through one ``Mempool`` a process
   (``bench.py``'s ``mempool_e2e`` load on the wall clock) with the
   shared ``CUDAVerifier`` and card-MSM coins: agreement, no lost or
   duplicate transaction, launches exact; committed tx/s, submit→deliver
   p50/p99, batch fill, the host split and the card's busy share (CUDA
   profiler), then a traced rerun whose ``obs.report`` attribution and
   Perfetto trace (``build/ingest_trace.json``) it prints; B, the mempool
   under chaos at n = 64 byte-identical to its host-oracle run; C,
   dissemination lanes against inline payloads on the card; D, the
   Byzantine suite at n = 32 (``garbage_coin``'s MSMs on the card); E,
   checkpoint round trip and attested snapshot join at n = 64 (span
   pairings on the card, a tampered blob refused); F, DKG key rotation at
   n = 4 with the coins on the card, byte-identical to host coins;
14. the degradation ladder (phase G): G1, after the sharded verifier, the
   verify phase's 4,096 rows through ``ResilientVerifier([card tier,
   CPUVerifier floor], retries=1)``, where the card tier is a counting
   wrapper over the shared ``CUDAVerifier``: streamed in chunks of
   ``STREAM_BUCKET`` with two seeded ``dispatch_raise`` and then two
   ``resolve_raise`` faults armed on the card, whose containment
   quarantines exactly the plan's chunks onto the ladder's floor (the
   ladder sees no exception); then 8 calls of 2 rounds with the card tier
   down for a seeded window of 2 calls and promoted back by the probe, on
   ``CUDAVerifier`` and on ``ShardedCUDAVerifier(mesh_from_env())``: masks
   equal, retries, fallbacks and quarantined rows exactly the plan's, no
   fall without a fault, the call after the promotion launched on the card,
   launches exactly the card tier's answered dispatches; G2, after phase
   12, phase 8's cluster with the ladder as its shared verifier and the
   card tier down for 2 seeded run calls: logs, leaders and waves
   byte-identical to the host oracle's log of phase 8,
   ``verify_fallback_tier`` 1 in the process metrics at the stretch's end,
   the card answering every call after the promotion, launches exact,
   nothing contained;
15. the checkers (phase H, after phases A-F): ``python -m
   dag_rider_tpu_torch.analysis --budget-s 30`` in a subprocess, exit 0 and
   ``clean``;
16. the networked deployment (phase I, after phase H): I1, a
   ``VerifierSidecarServer`` over a card ``CUDAVerifier`` (warmed up before
   its port opens) answers the verify phase's 16 rounds shipped by a
   ``RemoteVerifier`` as whole-round gRPC batches: masks equal to the
   phase's, one ``tree_sum_xyzt`` and one ``finish_check`` a dispatch, the
   RPC wall beside the in-process wall (encode, transport, host prep,
   device); I2, ``BASELINE.json`` config #2's committee (n = 16, 4 waves,
   1 tx a vertex) as 16 ``Node``s over gRPC on localhost (Bracha RBC,
   frame auth, ``verifier: "remote"`` to I1's sidecar with the ladder's
   CPU floor, ``coin_msm: "device"``, ``net_batch``: a peer's frames go
   out once a pump pass as one RPC), run in ``I2_WORKERS`` OS processes:
   every node decides 4 waves, the 16 logs agree by the audit's rule, each
   wave's leader is the host coin's, every row the sidecar answered gets
   the same bit from one ``CPUVerifier`` pass, no frame refused, no ladder
   retry or fallback, launches exactly the sidecar's dispatches and the
   nodes' ``ShardedMSM`` plans; then, with the server stopped, a
   ``RemoteVerifier`` fails closed; I3, the port's cluster command
   ``python -m dag_rider_tpu_torch.scripts.cluster --n 4 --seconds 6
   --rate 300 --kill auto`` as a subprocess: 4 OS processes of ``python -m
   dag_rider_tpu_torch.cluster.runner`` over UDS, wire-level load, one
   seeded kill -9 and a rejoin from checkpoint, then ``audit_cluster``,
   read from its exit code and the audit JSON it prints: agreement, no
   lost or duplicated transaction, liveness, no flight dump (CPU verifiers
   in the runners' own processes: no launch, and no entry in the
   ``{"kernels"}`` line);
17. the driver entry points (phase J, after phase I): J1, the flagship
   step of ``dag_rider_tpu_torch.graft_entry.entry()`` on the card, its
   mask equal to ``CPUVerifier``'s and to ``fn`` over CPU copies of its
   arguments, one ``tree_sum_xyzt`` and one ``finish_check`` launch; J2,
   ``dryrun_multichip(8, mesh=virtual_mesh(8))``, its four paths passing
   with exact launches; J3, ``python -m dag_rider_tpu_torch.graft_entry
   --mesh virtual`` exiting 0 with both OK lines;
18. prints ``{"device_programs": [...]}`` (the pairing's, the ladder's, the
   windowed program's, ``wave_commit_votes``' and the sharded MSM's times
   and bounds), ``{"kernels": [...]}`` (with each kernel's
   ``consensus_launches``, ``consensus_cert_launches``,
   ``windowed_launches``, ``n1024_launches``, ``sharded_launches``,
   ``host_layer_launches`` per phase A-F, ``ladder_launches`` per run of
   phase G, ``networked_launches`` for I1 and I2 and ``entry_launches``
   for J1 and J2; the tree's row
   carries its M = 32 reading under ``at_m32``, ``padd_xx``'s its widths;
   the ``key_tables`` and ``key_tables8`` rows each build of their width;
   every row its kernels' ptxas registers and spills), the card line again, and
   as the last line ``{"ok": true, "device": {...}}``.

Any failure exits non-zero before the last line. Run it from the root of
the repository: ``python3 chip_smoke.py`` (one card, no arguments).
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

N_KEYS = 256
ROUNDS = 16
STRONG_EDGES = 2 * (N_KEYS // 3) + 1  # 2f + 1 = 171
N_CORRUPT = 64
N_VALID_SAMPLE = 64
SEED = 20261017
PATH_REPEATS = 5

BLS_N = 256
BLS_THRESHOLD = BLS_N // 3 + 1  # f + 1 = 86 shares combine into the coin
CERT_QUORUM = 2 * (BLS_N // 3) + 1  # 2f + 1 = 171 signatures per certificate
BAD_SHARE = 17  # index of the corrupted share, among the first f + 1
WIDE_LANES = 65536  # padd381_xx's widest check, beyond the path's widths
FIELD_MUL_WIDE = 262144  # field_mul's graph time at a width that fills the card
PADD_WIDTHS = (256, 1024, 4096, 16384, 262144)  # padd_xx's graph times
MSM_REPEATS = 5

PREP_REPEATS = 7  # host prep timings: median of this many, in turns
STREAM_BUCKET = 512  # the streamed verify_rounds' chunk: 4,096 rows in 8 chunks

CONS_N = 256  # the consensus phase's committee (BASELINE.json config #4)
# every view decides at least this many waves; cut from bench.py's 3 to fit
# phase I in the time limit (depth only: every gate of phases 8, 9, 12 and
# G2 stays)
CONS_WAVES = 2
CONS_MAX_RUNS = 40  # cap on Simulation.run calls before the phase fails
# blocks a process submits in the certificate cell: 8 rounds, the fewest that
# decide 2 waves (bench.py's rung: 14; cut to fit the time limit)
CERT_BLOCKS = 8

N1024 = 1024  # BASELINE.json config #5: "1024-node full-wave MSM"
N1024_ROUNDS = 4  # bench.py's verify1024 rung: 4 rounds of 1,024 signed vertices
MSM_T = 1024  # bench.py's msm1024 rung

ROOT = os.path.dirname(os.path.abspath(__file__))
# phases A-F (the host layer's paths): the reference rungs' own settings
INGEST_N = 256  # bench.py's mempool_e2e rung (:2872-2931): n, load and drain
INGEST_LOAD_S = 20.0
INGEST_DRAIN_S = 30.0
INGEST_TRACE_S = 3.0  # the traced rerun's load
INGEST_TRACE_DRAIN_S = 15.0  # and its drain
INGEST_TRACE_SAMPLE = 0.05  # DAGRIDER_TRACE_SAMPLE of the traced rerun
INGEST_TRACE_RING = 262144  # DAGRIDER_TRACE_RING of the traced rerun
CHAOS_N = 64  # bench.py's mempool_chaos rung (:2935-2990)
CHAOS_S = 0.25  # cut from the rung's 1 s of virtual load to fit the time limit
LANE_MATRIX = ((4, 21, None, 12), (16, 22, "equivocate", 12), (16, 23, "lane_withhold", 12),
               (32, 24, None, 10))  # bench.py's lanes identity matrix (:1007-1075)
LANE_PUMPS = ("scalar", "vector")
BYZ_N = 32  # bench.py's byzantine rung plan (:3234-3267)
BYZ_PLAN = (
    {},
    dict(wan="partition", min_waves=1, min_each=1),
    dict(adversary="equivocate", min_waves=1, min_each=0),
    dict(adversary="equivocate_split", cycles=12, min_waves=1, min_each=0),
    dict(adversary="withhold", min_waves=1, min_each=0),
    dict(adversary="invalid_edges", min_waves=1, min_each=0),
    # cut from the rung's 4 cycles to fit the time limit: each filtered wave
    # pays host pairings for every share (1 cycle decides 6 waves and
    # filters 60 shares, 2 cycles 7 and 70)
    dict(adversary="garbage_coin", cycles=1, min_waves=1, min_each=0),
)
SNAP_N = 64  # phase E's committee
SNAP_SPAN = 4  # cert_span
SNAP_GC = 16  # gc_depth: the window a snapshot carries
SNAP_BLOCKS = 24  # blocks a process submits before the snapshot: past the GC depth
SNAP_MORE = 4  # blocks a process submits for the run on
ROTATE_N = 4  # bench.py's rotate_ab cell (:2025-2080); DKG host math grows as n^3
LADDER_ROUNDS_PER_CALL = 2  # G1's flaky run: the 16 rounds in 8 ladder calls of 512 rows
LADDER_WINDOW = 2  # calls the card tier is down for in G1's flaky run
LADDER_DOWN = 2  # run calls the card tier is down for in G2
LADDER_PROBE_S = 0.05  # the ladder's probe interval
I2_N = 16  # BASELINE.json config #2: 16 nodes, 4 waves, 1 tx a vertex
I2_WAVES = 4  # every node decides at least this many waves
I2_DEADLINE_S = 120.0  # the committee's time to I2_WAVES, or the phase fails
# RBC at n = 16 makes 16 x (15 + 2 x 16 x 15) = 7,920 gRPC sends a round,
# and one Python process serialises its sends and handlers under its
# interpreter lock: the 16 nodes run in this many OS processes
I2_WORKERS = 8
I2_BLOCKS = 40  # one-transaction blocks each node submits: one a vertex past wave 4
# quiescent pump ticks before a node asks its peers to re-serve a round
# (anti-entropy sync). Config's 8 is tuned for the simulator's whole-cluster
# step; a socket node's pump ticks every ~2 ms, so with blocks pending every
# node asks at each cooldown while it waits for a round's quorum, and at
# n = 16 the n^2 re-serves swamp the gRPC senders: on the H100 machine the
# committee stalled in its first waves with most sends past their deadline,
# at 8 ticks and at 500. 5,000 ticks is ~10 s of silence; the node config's
# sync_patience key carries it (the cluster harness raises cert_patience for
# the same reason).
I2_SYNC_PATIENCE = 5000
# The node config's "net_batch": each node ships its frames to a peer once
# a pump pass as one DeliverMany RPC. One Python gRPC call a frame (7,920
# a round) kept the card machine's 8 cores busy at ~4.5 s a round; some
# nodes then stayed behind for good, their vertices missing the next
# round's strong edges, and a wave whose leader one of them was got
# skipped: three in a row (waves 4-6) left a run at 3 waves after 120 s.
I2_NET_BATCH = True
I3_N = 4  # python -m dag_rider_tpu_torch.scripts.cluster --n 4 --seconds 6 --rate 300 --kill auto
I3_LOAD_S = 6.0
I3_RATE = 300.0
I3_BOOT_S = 60.0  # --boot-timeout: a runner's boot (its torch import) on a loaded host
J_MESH = 8  # phase J: the dry run's mesh (the reference's dryrun_multichip(8)), virtual
J_BUDGET_S = 30.0  # phase J's wall budget (printed beside its wall)

# Published H100 SXM peak memory rate (NVIDIA data sheet), used for the
# byte side of each kernel's bound.
HBM_BYTES_PER_S = 3.35e12
# Assumed int32 multiply-add rate: 64 lanes per SM per clock (Hopper's
# INT32 units) x the SM count x the card's maximum SM clock.
INT32_LANES_PER_SM_CLOCK = 64
IMAD_PER_PRODUCT = 22 * 22  # one general 22-limb schoolbook product
D2_NONZERO_LIMBS = 21  # limbs of 2d (ops/field.py's D2) that are not 0
PADD_IMADS = 8 * IMAD_PER_PRODUCT + 22 * D2_NONZERO_LIMBS  # padd_cached(p, to_cached(q))
PDOUBLE_IMADS = 8 * IMAD_PER_PRODUCT  # pdouble_packed: four squares, four products


# The functions each kernel row launches, by source stem (for the ptxas
# register and spill counts in the {"kernels"} line).
KERNEL_FUNCS = {
    "padd_xx": [("ed25519_group", "padd_xx_kernel")],
    "tree_sum_xyzt": [("ed25519_group", "tree_sum_xyzt_kernel")],
    "finish_check": [("ed25519_group", "finish_kernel")],
    "pow22523": [("ed25519_group", "pow22523_kernel")],
    "field_mul": [("ed25519_group", "field_mul_kernel")],
    "key_tables": [("ed25519_group", "key_bases_kernel"), ("ed25519_group", "key_entries_kernel")],
    "key_tables8": [("ed25519_group", "key_bases_kernel"),
                    ("ed25519_group", "key_entries8_kernel")],
    "padd381_xx": [("bls381_group", "padd381_kernel")],
    "horner381": [("bls381_group", "horner381_kernel")],
}
# The jnp scans the table kernels replace (no pallas_call there).
TABLE_REPLACES = {
    "key_tables": "dag_rider_tpu/ops/comb.py:130 (build_key_tables, jnp lax.scan)",
    "key_tables8": "dag_rider_tpu/ops/comb.py:197 (build_key_tables8, jnp lax.scan)",
}
# What every launch gate outside the table path wants of the table kernels:
# a verifier whose tables were built inside a gated window fails its gate.
NO_TABLES = {"key_tables": 0, "key_tables8": 0}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    raise SystemExit(1)


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls captured in one CUDA
    graph and replayed: the launches follow each other on the card without
    the host's issue gaps, which set the pace of back-to-back launches of
    a kernel shorter than its Python wrapper (tens of microseconds)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm the allocator on the capture's side stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_moved: float, imads: float, imad_per_s: float):
    """(least ms, "bytes" | "operations") for the work of one call."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = imads / imad_per_s * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def table_work(n: int, bits: int):
    """(bytes, int32 multiply-adds) of one comb table build of n keys: the
    key limbs read once and the tables written once; the window bases'
    doublings, then the entries' additions (4-bit) or each window's 127
    doublings and 127 additions (8-bit)."""
    windows, dbl, entries = (64, 4, 16) if bits == 4 else (32, 8, 256)
    bytes_moved = 4 * (3 * n * 22 + n * windows * entries * 88)
    doubles = n * (windows - 1) * dbl
    # a 4-bit window adds its base 15 times; an 8-bit window's 7 levels
    # (1, 2, ..., 64 entries) double 127 entries and add the base to 127
    adds = n * windows * (entries - 1 if bits == 4 else entries // 2 - 1)
    if bits == 8:
        doubles += adds
    return bytes_moved, doubles * PDOUBLE_IMADS + adds * PADD_IMADS


def ptxas_kernels(stem: str) -> dict:
    """{kernel name: {"registers", "spill_bytes"}} from the ptxas report of
    ``csrc/<stem>.cu`` (names demangled from their Itanium prefix)."""
    import re

    from dag_rider_tpu_torch.utils import build

    out, name = {}, None
    for line in build.ptxas_report(stem):
        m = re.search(r"entry function '_Z(\d+)(\w+)'", line)
        if m:
            name = m.group(2)[: int(m.group(1))]
            out[name] = {"registers": None, "spill_bytes": 0}
        elif name and "spill" in line:
            out[name]["spill_bytes"] = sum(int(b) for b in re.findall(r"(\d+) bytes spill", line))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out[name]["registers"] = int(m.group(1))
    return out


def table_build_gate(label: str, ver, imad_per_s: float):
    """One comb table build as a user reaches it, ``ver.comb_tables()`` of
    a fresh verifier, with the launch counters at 0 just before and read
    just after: exactly ``TABLE_KERNELS`` launches of its table kernels and
    nothing else. Its key tables (and the 8-bit base table, built as key n)
    must equal the plain build's on the card byte for byte. Prints the
    build's wall beside its bound and the kernels' own time (CUDA events);
    returns ((key tables, base table), its record)."""
    import numpy as np
    import torch

    from dag_rider_tpu_torch.crypto import ed25519
    from dag_rider_tpu_torch.ops import comb, cuda_field, cuda_group as CG, field as F

    bits = ver._comb_bits
    name = "key_tables" if bits == 4 else "key_tables8"
    torch.cuda.synchronize()
    CG.reset_launches()
    cuda_field.reset_launches()
    t0 = time.perf_counter()
    tables, b_tab = ver.comb_tables()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**CG.LAUNCHES, **CG.TABLE_LAUNCHES, **cuda_field.LAUNCHES}
    want = {**dict.fromkeys(launches, 0), name: CG.TABLE_KERNELS}
    if launches != want:
        fail(f"{label}: the table build launched {launches}, want {want}")
    keys = [ver._a_x, ver._a_y, ver._a_t]
    if bits == 8:  # the base point B is key n of the 8-bit build
        bx, by, _, bt = ed25519.B
        keys = [np.concatenate([a, F.to_limbs(c)[None]]) for a, c in zip(keys, (bx, by, bt))]
    keys = [torch.as_tensor(a, device=ver.device) for a in keys]
    plain_fn = comb.build_key_tables_plain if bits == 4 else comb.build_key_tables8_plain
    t0 = time.perf_counter()
    plain = plain_fn(*keys).reshape(-1, 88)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    got = tables if bits == 4 else torch.cat([tables, b_tab])
    if got.shape != plain.shape or not torch.equal(got, plain):
        fail(f"{label}: the table build differs from the plain build on the card")
    del got, plain
    kernel_fn = CG.key_tables if bits == 4 else CG.key_tables8
    ms = cuda_ms(lambda: kernel_fn(*keys), 5, 1)
    b_ms, b_by = bound(*table_work(len(keys[0]), bits), imad_per_s)
    print(f"table build {label} ({len(keys[0])} keys, {bits}-bit): {wall * 1e3:.3f} ms wall "
          f"through comb_tables(), {name} kernels {ms:.4f} ms (CUDA events), bound "
          f"{b_ms:.4f} ms by {b_by}; plain build on the card {plain_s:.2f} s; "
          f"byte-identical; launches {name} {CG.TABLE_KERNELS}, nothing else")
    return (tables, b_tab), {
        "label": label, "name": name, "keys": len(keys[0]), "launches": CG.TABLE_KERNELS,
        "wall_ms": wall * 1e3, "ms": ms, "plain_ms": plain_s * 1e3, "bound_ms": b_ms,
        "bound_by": b_by,
    }


def main() -> int:
    import numpy as np
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        from dag_rider_tpu_torch.core.types import Block, Vertex, VertexID
        from dag_rider_tpu_torch.ops import comb, cuda_field, cuda_group as CG, field as F
        from dag_rider_tpu_torch.utils import build, native
        from dag_rider_tpu_torch.verifier.base import KeyRegistry, VertexSigner
        from dag_rider_tpu_torch.verifier.cpu import CPUVerifier
        from dag_rider_tpu_torch.verifier.cuda import CUDAVerifier, unpack
    except ImportError as exc:
        print(f"chip_smoke: the dag_rider_tpu_torch package is missing: {exc}",
              file=sys.stderr)
        return 2
    card = smi("name,power.limit")
    print(card)
    garbage = next(kw["cycles"] for kw in BYZ_PLAN if kw.get("adversary") == "garbage_coin")
    print(f"depth cuts to fit the time limit (every gate stays): consensus phases 8, 9, 12 "
          f"and G2 to {CONS_WAVES} decided waves (bench.py's rung: 3), the certificate cell "
          f"to {CERT_BLOCKS} blocks a process (the rung's 14); the mempool chaos rung to "
          f"{CHAOS_S:g} s of virtual load (its 1 s); garbage_coin to {garbage} cycle(s) (the "
          f"rung's 4)")
    max_sm_mhz = float(smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    imad_per_s = INT32_LANES_PER_SM_CLOCK * sms * max_sm_mhz * 1e6
    print(f"bound model: {HBM_BYTES_PER_S / 1e12} TB/s; int32 IMAD "
          f"{INT32_LANES_PER_SM_CLOCK} x {sms} SMs x {max_sm_mhz:.0f} MHz = "
          f"{imad_per_s / 1e12:.2f} T/s")

    # -- build ------------------------------------------------------------
    # a stamp file's mtime starts the build on the file system's clock, the
    # clock each library's mtime is read on
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stamp = build.BUILD_DIR / ".build_start"
    stamp.touch()
    t0, wall0 = time.perf_counter(), stamp.stat().st_mtime
    libs = build.build_all()
    # each library is the file its own nvcc wrote last, so its mtime marks
    # the end of that source's compile (the sources compile in parallel)
    per_source = ", ".join(f"{stem} {so.stat().st_mtime - wall0:.1f} s"
                           for stem, so in libs.items() if so.stat().st_mtime >= wall0)
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc {build.last_build_s:.1f} s, "
          f"in parallel: {per_source or 'nothing to build'})")
    for stem in ("ed25519_group", "bls381_group"):
        for line in build.ptxas_report(stem):
            print(f"  ptxas {stem}: {line}")
    # the native challenge library (g++), before any row is hashed: every
    # row of every phase takes the native route unless a phase asks for
    # DAGRIDER_NATIVE=0
    t0 = time.perf_counter()
    if native.load() is None:
        fail(f"the native challenge library did not build from {native.SRC}")
    print(f"native challenge library: {native.library_path().name}, g++ "
          f"{native.last_build_s:.2f} s, load {time.perf_counter() - t0:.2f} s")
    native.reset_rows()
    # the card's context and the kernel libraries, so that the first table
    # build's wall holds neither (its first launches still load the kernels)
    t0 = time.perf_counter()
    torch.zeros(1, device="cuda")
    for stem in libs:
        build.library(stem)
    torch.cuda.synchronize()
    print(f"card context and kernel libraries loaded: {time.perf_counter() - t0:.2f} s")

    # -- set-up: registry, device tables, signed rounds ---------------------
    t0 = time.perf_counter()
    reg, seeds = KeyRegistry.generate(N_KEYS)
    signers = [VertexSigner(s) for s in seeds]
    t_keys = time.perf_counter() - t0
    ver = CUDAVerifier(reg)  # on the card: there is no other default
    dev = ver.device
    # the table path: each build's launches gated, its tables held against
    # the plain build (4-bit here, 8-bit in phase 6, n = 1,024 in phase 11)
    builds = []
    (tables, b_tab), rec = table_build_gate("n = 256", ver, imad_per_s)
    builds.append(rec)
    t_tables = rec["wall_ms"] / 1e3
    # warmup at the path's bucket: libraries, tables, native library and one
    # all-padding dispatch, booking none of the dispatch counters
    t_warm = ver.warmup(ROUNDS * N_KEYS)
    if (ver.total_dispatches, ver.total_sigs_dispatched, ver.total_prepare_s) != (0, 0, 0.0):
        fail("warmup() booked a dispatch counter")
    rng = np.random.default_rng(SEED)
    rounds = []
    t0 = time.perf_counter()
    for r in range(1, ROUNDS + 1):
        rnd = []
        for i in range(N_KEYS):
            edges = tuple(VertexID(r - 1, int(j)) for j in
                          rng.choice(N_KEYS, STRONG_EDGES, replace=False))
            v = Vertex(id=VertexID(r, i), block=Block((rng.bytes(64),)),
                       strong_edges=edges)
            rnd.append(signers[i].sign_vertex(v))
        rounds.append(rnd)
    t_sign = time.perf_counter() - t0
    total = ROUNDS * N_KEYS
    corrupted = corrupt_rounds(rounds, N_KEYS, rng)
    print(f"set-up: keys {t_keys:.2f} s, device tables {t_tables:.4f} s "
          f"({tables.numel() * 4 / 2**20:.0f} MiB), warmup at {total} rows {t_warm:.2f} s, "
          f"signing {total} vertices {t_sign:.2f} s, {len(corrupted)} corrupted")

    flat = [v for rnd in rounds for v in rnd]
    u8, i32 = ver.prepare_batch(flat)
    if u8.shape != (total, 131) or i32.shape != (total, 23):
        fail(f"prepared shapes {u8.shape}, {i32.shape}")
    def to_device():
        return torch.from_numpy(u8).to(dev), torch.from_numpy(i32).to(dev)

    u8_dev, i32_dev = to_device()
    x = unpack(u8_dev, i32_dev)
    entries = comb.gather_entries(x.s_nibbles, x.k_nibbles, x.key_idx, tables, b_tab)

    # -- kernel phase ---------------------------------------------------------
    report = []

    def record(name, replaces, got, want, ms, plain_ms, bytes_moved, imads, lanes):
        err = int((got.long() - want.long()).abs().max().item())
        b_ms, b_by = bound(bytes_moved, imads, imad_per_s)
        print(f"kernel {name}: lanes {lanes}, equal {err == 0}, {ms:.4f} ms "
              f"(plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms by {b_by})")
        if err != 0:
            fail(f"{name} disagrees with its plain version (max abs err {err})")
        report.append({
            "name": name, "route": "cuda", "source": CG.SOURCE, "replaces": replaces,
            "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "lanes": lanes,
        })

    # padd_xx at the first tree level: 2 * 64 * 4096 entries in pairs
    m, flat_n = entries.shape[2], 2 * total
    lm = entries.reshape(flat_n, m, 88).permute(2, 1, 0).reshape(88, m * flat_n)
    half = lm.shape[1] // 2
    p, q = lm[:, :half], lm[:, half:]
    got = CG.padd_xx(p, q)
    want = CG.padd_xx_plain(p, q)
    d2_nnz = int((F.D2 != 0).sum())
    if d2_nnz != D2_NONZERO_LIMBS:
        fail(f"2d has {d2_nnz} nonzero limbs, the bounds count {D2_NONZERO_LIMBS}")
    record("padd_xx", "dag_rider_tpu/ops/pallas_group.py:211", got, want,
           cuda_ms(lambda: CG.padd_xx(p, q), 20), cuda_ms(lambda: CG.padd_xx_plain(p, q), 3, 1),
           3 * 88 * 4 * half, half * PADD_IMADS, half)
    report[-1]["graph_ms"] = graph_ms(lambda: CG.padd_xx(p, q), 20)
    # at the paths' widths, on seeded reduced limbs (column slices of one
    # tensor), exact, in a CUDA graph: 256 and 1,024 lanes (n = 256 and
    # 1,024 keys), 4,096 (the windowed walk), 16,384 (the widest level of
    # an 8-bit build) and the first tree level's 262,144
    pr = np.random.default_rng(SEED + 2)
    padd_widths = {}
    for lanes in PADD_WIDTHS:
        lx = pr.integers(-8191, 8192, (88, 2 * lanes), dtype=np.int32)
        lx[::22] = pr.integers(-16383, 16384, (4, 2 * lanes), dtype=np.int32)
        lx = torch.from_numpy(lx).to(dev)
        lp, lq = lx[:, :lanes], lx[:, lanes:]
        if not torch.equal(CG.padd_xx(lp, lq), CG.padd_xx_plain(lp, lq)):
            fail(f"padd_xx disagrees with its plain version at {lanes} lanes")
        g_ms = graph_ms(lambda: CG.padd_xx(lp, lq), 20)
        b_ms, b_by = bound(3 * 88 * 4 * lanes, lanes * PADD_IMADS, imad_per_s)
        padd_widths[str(lanes)] = {"graph_ms": g_ms, "bound_ms": b_ms, "bound_by": b_by}
        print(f"  padd_xx at {lanes} lanes: exact, {g_ms:.4f} ms in a CUDA graph, bound "
              f"{b_ms:.4f} ms by {b_by} ({b_ms / g_ms:.1%} of the bound's rate)")
    report[-1]["widths"] = padd_widths
    del lx, lp, lq

    # the whole comb tree in one launch: 2 * 4096 groups of 64 entries,
    # 63 additions each, read from the gather's own output
    acc = CG.tree_sum_xyzt(entries)
    acc_plain = comb.tree_sum_packed(entries)
    tree_adds = flat_n * (m - 1)
    record("tree_sum_xyzt", "dag_rider_tpu/ops/pallas_group.py:211", acc, acc_plain,
           cuda_ms(lambda: CG.tree_sum_xyzt(entries), 20),
           cuda_ms(lambda: comb.tree_sum_packed(entries), 2, 1),
           4 * (entries.numel() + acc.numel()),
           tree_adds * PADD_IMADS, flat_n)
    report[-1]["entries_per_group"] = m
    report[-1]["graph_ms"] = graph_ms(lambda: CG.tree_sum_xyzt(entries), 20)
    tree_ms = report[-1]["ms"]

    # the real rows with the edge rows of tests/torch_edge_rows.py (valid,
    # wrong [s]B, non-square y, x = 0 with sign 1, y >= p, 8-torsion [k]A,
    # the identity) on every 64th row
    sys.path.insert(0, os.path.join(root, "tests"))
    from torch_edge_rows import edge_limbs, edge_rows, tiled

    _, e_y, e_sign, e_acc = edge_rows()
    mix = slice(0, total, 64)
    n_mix = len(range(0, total, 64))
    f_y, f_sign, f_acc = x.r_y.clone(), x.r_sign.clone(), acc.clone()
    f_y[mix], f_sign[mix], f_acc[mix] = (tiled(t, n_mix).to(dev) for t in (e_y, e_sign, e_acc))
    got = CG.finish_check(f_y, f_sign, f_acc)
    want = CG.finish_check_plain(f_y, f_sign, f_acc)
    # finish: 285 general products + the D, SQRT_M1 and D2 constant products
    finish_imads = 285 * IMAD_PER_PRODUCT + 22 * (
        int((F.D != 0).sum()) + int((F.SQRT_M1 != 0).sum()) + d2_nnz)
    record("finish_check", "dag_rider_tpu/ops/pallas_group.py:273", got, want,
           cuda_ms(lambda: CG.finish_check(f_y, f_sign, f_acc), 20),
           cuda_ms(lambda: CG.finish_check_plain(f_y, f_sign, f_acc), 2, 1),
           (22 + 1 + 176 + 1) * 4 * total, total * finish_imads, total)
    print(f"  {n_mix} edge rows mixed in; {int(want.sum())} of {total} rows accepted")
    report[-1]["graph_ms"] = graph_ms(lambda: CG.finish_check(f_y, f_sign, f_acc), 20)

    zr = np.random.default_rng(SEED + 1)
    z = torch.from_numpy(zr.integers(-4095, 4096, (22, total), dtype=np.int32)).to(dev)
    z[:, mix] = tiled(edge_limbs(), n_mix).t().to(dev)
    got = CG.pow22523(z)
    want = CG.pow22523_plain(z)
    record("pow22523", "dag_rider_tpu/ops/pallas_group.py:264", got, want,
           cuda_ms(lambda: CG.pow22523(z), 20), cuda_ms(lambda: CG.pow22523_plain(z), 2, 1),
           2 * 22 * 4 * total, total * 262 * IMAD_PER_PRODUCT, total)
    report[-1]["graph_ms"] = graph_ms(lambda: CG.pow22523(z), 20)

    a = torch.from_numpy(zr.integers(-4095, 4096, (total, 22), dtype=np.int32)).to(dev)
    b = torch.from_numpy(zr.integers(-4095, 4096, (total, 22), dtype=np.int32)).to(dev)
    got = cuda_field.mul(a, b)
    record("field_mul", "dag_rider_tpu/ops/pallas_field.py:43", got, cuda_field.mul_plain(a, b),
           cuda_ms(lambda: cuda_field.mul(a, b), 50), cuda_ms(lambda: cuda_field.mul_plain(a, b), 5),
           3 * 22 * 4 * total, total * IMAD_PER_PRODUCT, total)
    # the kernel alone (limb-major operands, no transposes) replayed in a
    # CUDA graph, at the path's width and at a width that fills the card
    fm_widths = {}
    for lanes in (total, FIELD_MUL_WIDE):
        fa = torch.from_numpy(zr.integers(-4095, 4096, (22, lanes), dtype=np.int32)).to(dev)
        fb = torch.from_numpy(zr.integers(-4095, 4096, (22, lanes), dtype=np.int32)).to(dev)
        fo = torch.empty_like(fa)

        def fm_launch():
            CG.launch("dr_field_mul", dev, fa.data_ptr(), fb.data_ptr(), fo.data_ptr(), lanes)

        fm_launch()
        torch.cuda.synchronize()
        if not torch.equal(fo.t(), cuda_field.mul_plain(fa.t(), fb.t())):
            fail(f"field_mul disagrees with its plain version at {lanes} lanes")
        g_ms = graph_ms(fm_launch, 50)
        b_ms, b_by = bound(3 * 22 * 4 * lanes, lanes * IMAD_PER_PRODUCT, imad_per_s)
        fm_widths[str(lanes)] = {"graph_ms": g_ms, "bound_ms": b_ms, "bound_by": b_by,
                                 "bound_share": b_ms / g_ms}
        print(f"  field_mul kernel alone at {lanes} lanes: {g_ms:.4f} ms in a CUDA graph, bound "
              f"{b_ms:.4f} ms by {b_by} ({b_ms / g_ms:.1%} of the bound's rate)")
    report[-1]["widths"] = fm_widths
    del fa, fb, fo  # before the path phase's peak-memory reading
    del entries, lm, p, q, acc, acc_plain

    # -- path phase -----------------------------------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    CG.reset_launches()
    cuda_field.reset_launches()
    masks = ver.verify_rounds(rounds)
    torch.cuda.synchronize()
    launches = {**CG.LAUNCHES, **CG.TABLE_LAUNCHES, **cuda_field.LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    print(f"path launches: {launches}")
    if (launches["tree_sum_xyzt"], launches["finish_check"], launches["padd_xx"]) != (1, 1, 0) \
            or any(launches[k] for k in NO_TABLES):
        fail(f"the dispatch launched {launches}; want one tree_sum_xyzt, one finish_check, "
             f"no padd_xx and no table build")
    for row in report:
        row["launches"] = launches[row["name"]]
    if [len(mk) for mk in masks] != [N_KEYS] * ROUNDS:
        fail(f"mask shape {[len(mk) for mk in masks]}")
    mask = [bool(bit) for mk in masks for bit in mk]

    sample = sorted(corrupted) + sorted(
        int(i) for i in rng.choice(sorted(set(range(total)) - corrupted),
                                   N_VALID_SAMPLE, replace=False))
    oracle = CPUVerifier(reg).verify_batch([flat[i] for i in sample])
    if [mask[i] for i in sample] != oracle:
        bad = [i for i, o in zip(sample, oracle) if mask[i] != o]
        fail(f"mask differs from the host oracle at rows {bad[:10]}")
    plain = comb.tree_sum_packed(
        comb.gather_entries(x.s_nibbles, x.k_nibbles, x.key_idx, tables, b_tab))
    plain = CG.finish_check_plain(x.r_y, x.r_sign, plain) & x.a_valid & x.prevalid
    if plain.cpu().tolist() != mask:
        fail("mask differs from the all-plain torch path on the card")
    n_accept = sum(mask)
    print(f"path mask: {n_accept} accepted, {total - n_accept} rejected; equal to the host "
          f"oracle on {len(sample)} rows ({len(corrupted)} corrupted) and to the plain path "
          f"on all {total}")
    if not all(mask[i] for i in range(total) if i not in corrupted):
        fail("a valid signature outside the corrupted set was rejected")

    walls, preps, devs = [], [], []
    for _ in range(PATH_REPEATS):
        p0, d0 = span_s(ver, PREP), span_s(ver, *ENQUEUE_TO_MASK)
        t0 = time.perf_counter()
        again = ver.verify_rounds(rounds)
        walls.append(time.perf_counter() - t0)
        preps.append(span_s(ver, PREP) - p0)
        devs.append(span_s(ver, *ENQUEUE_TO_MASK) - d0)
        if again != masks:
            fail("a repeated dispatch returned another mask")
    wall = statistics.median(walls)
    print(f"path dispatch ({total} sigs, median of {PATH_REPEATS}): {wall * 1e3:.1f} ms wall = "
          f"host prep {statistics.median(preps) * 1e3:.1f} ms + device "
          f"{statistics.median(devs) * 1e3:.1f} ms; {total / wall:.0f} sigs/s; "
          f"runs {[round(w * 1e3, 1) for w in walls]} ms; "
          f"peak device memory {peak / 2**20:.0f} MiB")

    def unpack_gather():
        y = unpack(u8_dev, i32_dev)
        return comb.gather_entries(y.s_nibbles, y.k_nibbles, y.key_idx, tables, b_tab)

    copy_ms = cuda_ms(to_device, 10)
    gather_ms = cuda_ms(unpack_gather, 10)
    finish_ms = next(r["ms"] for r in report if r["name"] == "finish_check")
    print(f"device breakdown (CUDA events): copies in {copy_ms:.3f} ms, unpack + gather "
          f"{gather_ms:.3f} ms, tree {tree_ms:.3f} ms, finish {finish_ms:.3f} ms; sum "
          f"{copy_ms + gather_ms + tree_ms + finish_ms:.3f} ms")

    if native.ROWS_HASHED["hashlib"] or not native.ROWS_HASHED["native"]:
        fail(f"rows hashed by route {native.ROWS_HASHED}; DAGRIDER_NATIVE is on, so every "
             f"row must take the native route")
    host_prep_phase(ver, rounds, mask)
    tree_row = next(r for r in report if r["name"] == "tree_sum_xyzt")
    tree_row["at_m32"] = comb8_phase(reg, rounds, mask, sample, oracle, imad_per_s, builds)
    windowed_launches, windowed_row = windowed_phase(reg, rounds, mask, sample, oracle,
                                                     imad_per_s)
    vote_rows = round_step_phase(reg, rounds, mask, imad_per_s)
    sharded_verify_phase(ver, rounds, mask)
    ladder_launches = ladder_verify_phase(ver, rounds, mask)

    bls_rows, programs = bls_phases(dev, imad_per_s)
    report.extend(bls_rows)
    programs.append(windowed_row)
    programs.extend(vote_rows)
    n1024_launches, n1024_msm_row = n1024_phase(imad_per_s, builds)
    programs.append(n1024_msm_row)

    ref = consensus_phase()
    cert_launches = consensus_cert_phase()
    sharded_launches = sharded_consensus_phase(ref)
    ladder_launches["G2"] = ladder_consensus_phase(ref)
    host_layer = host_layer_phases()
    checkers_phase()
    networked = networked_phases(ver, rounds, mask, seeds)
    entry = entry_phase()
    for row in report:
        name = row["name"]
        row["consensus_launches"] = ref["launches"].get(name, 0)
        row["consensus_cert_launches"] = cert_launches.get(name, 0)
        row["sharded_launches"] = sharded_launches.get(name, 0)
        row["windowed_launches"] = windowed_launches.get(name, 0)
        row["n1024_launches"] = n1024_launches.get(name, 0)
        row["host_layer_launches"] = {k: v.get(name, 0) for k, v in host_layer.items()}
        row["ladder_launches"] = {k: v.get(name, 0) for k, v in ladder_launches.items()}
        row["networked_launches"] = {k: v.get(name, 0) for k, v in networked.items()}
        row["entry_launches"] = {k: v.get(name, 0) for k, v in entry.items()}

    for rec in builds:  # the table kernels: one row a width, each build listed
        row = next((r for r in report if r["name"] == rec["name"]), None)
        if row is None:
            row = {
                "name": rec["name"], "route": "cuda", "source": CG.SOURCE,
                "replaces": TABLE_REPLACES[rec["name"]], "launches": rec["launches"],
                "max_abs_err": 0, "ms": rec["ms"], "plain_ms": rec["plain_ms"],
                "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"], "library_ms": None,
                "keys": rec["keys"], "wall_ms": rec["wall_ms"], "builds": [],
            }
            report.append(row)
        row["builds"].append(rec)
        row["entry_launches"] = {k: v.get(rec["name"], 0) for k, v in entry.items()}
    ptxas = {stem: ptxas_kernels(stem) for stem in ("ed25519_group", "bls381_group")}
    for row in report:
        row["ptxas"] = {f: ptxas[stem].get(f) for stem, f in KERNEL_FUNCS[row["name"]]}

    print(f"chip_smoke wall: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"device_programs": programs}))
    print(json.dumps({"kernels": report}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def corrupt_rounds(rounds, n: int, rng) -> set:
    """Corrupt ``N_CORRUPT`` seeded rows of ``rounds`` in place, seven
    kinds in turn: a flipped signature bit, another vertex's signature, an
    out-of-range source, s >= L, a non-canonical R (y >= p), a missing
    signature, a tampered block. Returns the flat indices corrupted."""
    import dataclasses

    from dag_rider_tpu_torch.core.types import Block, VertexID
    from dag_rider_tpu_torch.crypto import ed25519

    total = sum(len(r) for r in rounds)
    corrupted = set()
    for k, fi in enumerate(rng.choice(total, N_CORRUPT, replace=False)):
        r, i = divmod(int(fi), n)
        v = rounds[r][i]
        sig = v.signature
        mode = k % 7
        if mode == 0:  # one flipped signature bit
            b = bytearray(sig)
            b[int(rng.integers(64))] ^= 1 << int(rng.integers(8))
            v = dataclasses.replace(v, signature=bytes(b))
        elif mode == 1:  # another vertex's signature
            v = dataclasses.replace(v, signature=rounds[r][(i + 1) % n].signature)
        elif mode == 2:  # out-of-range source
            v = dataclasses.replace(v, id=VertexID(v.round, n + i))
        elif mode == 3:  # s >= L (malleability)
            s_big = int.from_bytes(sig[32:], "little") + ed25519.L
            v = dataclasses.replace(v, signature=sig[:32] + s_big.to_bytes(32, "little"))
        elif mode == 4:  # non-canonical R (y >= p)
            v = dataclasses.replace(
                v, signature=(2**255 - 10).to_bytes(32, "little") + sig[32:])
        elif mode == 5:  # missing signature
            v = dataclasses.replace(v, signature=None)
        else:  # tampered block
            v = dataclasses.replace(v, block=Block((b"tampered",)))
        rounds[r][i] = v
        corrupted.add(int(fi))
    return corrupted


@contextlib.contextmanager
def env(**values):
    """Set environment variables for a block and restore them after."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def flat_mask(masks) -> list:
    return [bool(bit) for mk in masks for bit in mk]


#: the verifier's spans (obs/spans.py) from a dispatch's enqueue to its
#: mask on the host, and of its resolve alone
ENQUEUE_TO_MASK = ("dagrider.verify.dispatch", "dagrider.verify.wait",
                   "dagrider.verify.copy_out")
RESOLVE = ENQUEUE_TO_MASK[1:]
PREP = "dagrider.verify.prep"


def span_s(ver, *names: str) -> float:
    """Seconds the verifier's span book holds under ``names``, summed."""
    return sum(ver.spans.seconds(name) for name in names)


def host_prep_phase(ver, rounds, mask) -> None:
    """The verifier's host half on the path's 4,096 rows: the prep arrays
    byte-identical at 1 worker and W = min(4, cpus) workers with the
    native challenge route and at 1 worker with DAGRIDER_NATIVE=0 (each
    timed, each row on the route it claims); ``verify_rounds`` streamed in
    8 chunks of ``STREAM_BUCKET`` at depth 1 and 2 (prep-ahead), masks
    equal to the merged dispatch's with exactly 8 launches of each
    kernel; then seeded dispatch and resolve faults contained (poisoned
    windows and quarantined chunks, nothing rejected, the same masks),
    and a clean run after disarming. Fails on any mismatch."""
    import torch

    from dag_rider_tpu_torch.ops import cuda_field, cuda_group as CG
    from dag_rider_tpu_torch.utils import native
    from dag_rider_tpu_torch.verifier.cuda import CUDAVerifier
    from dag_rider_tpu_torch.verifier.faults import VerifierFaultInjector, VerifierFaultPlan

    flat = [v for rnd in rounds for v in rnd]
    total = len(flat)
    cpus = os.cpu_count() or 1
    w = min(4, cpus)
    print(f"host prep phase: os.cpu_count() {cpus}, W = {w}, {total} rows")
    configs = (("1 worker, native", 1, "1"), (f"{w} workers, native", w, "1"),
               ("1 worker, DAGRIDER_NATIVE=0", 1, "0"))
    depth0 = ver.pipeline_depth
    try:
        arrays, stats = {}, {}
        walls, rows = {c[0]: [] for c in configs}, {c[0]: {} for c in configs}
        # the three in turns, PREP_REPEATS rounds: the host's load drifts
        # between the configurations' runs, not within one round
        for _ in range(PREP_REPEATS):
            for name, workers, flag in configs:
                ver.prep_workers = workers
                ver._prep()  # (re)build the engine outside the timed call
                before = dict(native.ROWS_HASHED)
                with env(DAGRIDER_NATIVE=flag):
                    t0 = time.perf_counter()
                    out = ver._prepare(flat, total)
                    walls[name].append(time.perf_counter() - t0)
                for k in native.ROWS_HASHED:
                    rows[name][k] = rows[name].get(k, 0) + native.ROWS_HASHED[k] - before[k]
                arrays[name], stats[name] = out, ver.prep_stats()
        for name, workers, flag in configs:
            route = "native" if flag == "1" else "hashlib"
            got = rows[name]
            if got[route] != PREP_REPEATS * int(arrays[name][0][:, 129].sum()) or (
                    sum(got.values()) != got[route]):
                fail(f"prep {name}: rows hashed by route {got}, want all on the {route} route")
            print(f"  prep {name}: median {statistics.median(walls[name]) * 1e3:.2f} ms wall (runs "
                  f"{[round(t * 1e3, 2) for t in walls[name]]} ms, in turns with the others); "
                  f"rows hashed {got}; prep_stats after its last run {stats[name]}")
        first = arrays[configs[0][0]]
        for name, out in arrays.items():
            if any(a.tobytes() != b.tobytes() for a, b in zip(out, first)):
                fail(f"prep arrays of {name} differ from those of {configs[0][0]}")
        print(f"  prep arrays (u8 {first[0].shape}, i32 {first[1].shape}) byte-identical across "
              f"the three")

        chunks = -(-total // STREAM_BUCKET)
        ver.prep_workers = w
        ver.fixed_bucket = STREAM_BUCKET
        runs = {d: {"wall": [], "prep": [], "wait": []} for d in (1, 2)}
        for _ in range(3):  # depth 1 and 2 in turns
            for depth in (1, 2):
                ver.pipeline_depth = depth
                p0, d0 = ver.total_prepare_s, span_s(ver, *RESOLVE)
                torch.cuda.synchronize()
                CG.reset_launches()
                cuda_field.reset_launches()
                t0 = time.perf_counter()
                got = ver.verify_rounds(rounds)
                runs[depth]["wall"].append(time.perf_counter() - t0)
                torch.cuda.synchronize()
                runs[depth]["prep"].append(ver.total_prepare_s - p0)
                runs[depth]["wait"].append(span_s(ver, *RESOLVE) - d0)
                launches = {**CG.LAUNCHES, **CG.TABLE_LAUNCHES, **cuda_field.LAUNCHES}
                want = {"padd_xx": 0, "tree_sum_xyzt": chunks, "finish_check": chunks,
                        "pow22523": 0, "field_mul": 0, **NO_TABLES}
                if launches != want:
                    fail(f"streamed depth {depth}: launches {launches}, want {want}")
                if flat_mask(got) != mask:
                    fail(f"streamed depth {depth}: masks differ from the merged dispatch's")
        if ver.poisoned_windows or ver.quarantined_chunks:
            fail("streamed: a clean run contained faults")
        for depth, r in runs.items():
            print(f"  streamed verify_rounds, depth {depth}, {chunks} chunks of {STREAM_BUCKET}, "
                  f"{w} prep workers (prep-ahead {'on' if depth > 1 else 'off'}): wall median "
                  f"{statistics.median(r['wall']) * 1e3:.2f} ms (runs "
                  f"{[round(t * 1e3, 2) for t in r['wall']]} ms, in turns); host prep "
                  f"{statistics.median(r['prep']) * 1e3:.2f} ms, resolve wait "
                  f"{statistics.median(r['wait']) * 1e3:.2f} ms; {chunks} + {chunks} launches "
                  f"each run; masks equal")

        # chaos on the card: the ladder's next tier is a second card verifier
        tier = CUDAVerifier(ver.registry)
        tier.comb_tables()
        ver.quarantine_verifier = tier
        ver.pipeline_depth = 2
        for kind, seed in (("dispatch_raise", SEED), ("resolve_raise", SEED + 1)):
            g0 = (ver.poisoned_windows, ver.quarantined_chunks, ver.quarantine_rejected)
            inj = VerifierFaultInjector(VerifierFaultPlan(**{kind: 1.0}, max_faults=2, seed=seed))
            try:
                inj.arm(ver)
                got = ver.verify_rounds(rounds)
            finally:
                inj.disarm()
            g = [a - b for a, b in zip(
                (ver.poisoned_windows, ver.quarantined_chunks, ver.quarantine_rejected), g0)]
            print(f"  chaos {kind} (max_faults 2, seed {seed}): {inj.faults_injected} faults, "
                  f"poisoned windows {g[0]}, quarantined chunks {g[1]}, rejected {g[2]}")
            if inj.faults_injected != 2 or g[0] <= 0 or g[1] <= 0 or g[2] != 0:
                fail(f"chaos {kind}: faults {inj.faults_injected}, gauges {g}")
            if flat_mask(got) != mask:
                fail(f"chaos {kind}: masks differ from the clean run's")
        g0 = (ver.poisoned_windows, ver.quarantined_chunks, ver.quarantine_rejected)
        if flat_mask(ver.verify_rounds(rounds)) != mask or g0 != (
                ver.poisoned_windows, ver.quarantined_chunks, ver.quarantine_rejected):
            fail("the clean run after disarming differs or contained a fault")
        print("  disarmed: a clean streamed run gives the same masks, nothing contained")
    finally:
        ver.fixed_bucket = None
        ver.pipeline_depth = depth0
        ver.quarantine_verifier = None
        ver.prep_workers = None


def comb8_phase(reg, rounds, mask, sample, oracle, imad_per_s: float, builds: list) -> dict:
    """The 8-bit comb (DAGRIDER_COMB_BITS=8) at n = 256: the table build
    (``table_build_gate``, its record appended to ``builds``; time and
    bytes), one merged 4,096-signature dispatch whose mask
    equals the 4-bit mask on every row and the host oracle on the sample,
    with exactly one ``tree_sum_xyzt`` (32 entries a group) and one
    ``finish_check`` launch, its wall and split, and the tree kernel at
    M = 32 against its plain version. Returns the tree's report at M = 32."""
    import torch

    from dag_rider_tpu_torch.ops import comb, cuda_field, cuda_group as CG
    from dag_rider_tpu_torch.verifier.cuda import CUDAVerifier, unpack8

    flat = [v for rnd in rounds for v in rnd]
    total = len(flat)
    with env(DAGRIDER_COMB_BITS="8"):
        v8 = CUDAVerifier(reg)
    dev = v8.device
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    (tables, b_tab), rec = table_build_gate("8-bit, n = 256", v8, imad_per_s)
    builds.append(rec)
    print(f"8-bit comb: tables built in {rec['wall_ms'] / 1e3:.4f} s; key tables "
          f"{tuple(tables.shape)} "
          f"{tables.numel() * 4} B, base table {tuple(b_tab.shape)} {b_tab.numel() * 4} B; "
          f"device memory +{torch.cuda.memory_allocated() - mem0} B")

    torch.cuda.synchronize()
    CG.reset_launches()
    cuda_field.reset_launches()
    masks = v8.verify_rounds(rounds)
    torch.cuda.synchronize()
    launches = {**CG.LAUNCHES, **CG.TABLE_LAUNCHES, **cuda_field.LAUNCHES}
    want = {"padd_xx": 0, "tree_sum_xyzt": 1, "finish_check": 1, "pow22523": 0, "field_mul": 0,
            **NO_TABLES}
    if launches != want:
        fail(f"8-bit dispatch launched {launches}, want {want}")
    m8 = flat_mask(masks)
    if m8 != mask:
        bad = [i for i in range(total) if m8[i] != mask[i]]
        fail(f"8-bit mask differs from the 4-bit mask at rows {bad[:10]}")
    if [m8[i] for i in sample] != oracle:
        fail("8-bit mask differs from the host oracle on the sample")
    walls, preps, devs = [], [], []
    for _ in range(PATH_REPEATS):
        p0, d0 = span_s(v8, PREP), span_s(v8, *ENQUEUE_TO_MASK)
        t0 = time.perf_counter()
        again = v8.verify_rounds(rounds)
        walls.append(time.perf_counter() - t0)
        preps.append(span_s(v8, PREP) - p0)
        devs.append(span_s(v8, *ENQUEUE_TO_MASK) - d0)
        if again != masks:
            fail("a repeated 8-bit dispatch returned another mask")
    wall = statistics.median(walls)
    print(f"8-bit dispatch ({total} sigs, median of {PATH_REPEATS}): {wall * 1e3:.1f} ms wall = "
          f"host prep {statistics.median(preps) * 1e3:.1f} ms + device "
          f"{statistics.median(devs) * 1e3:.1f} ms; {total / wall:.0f} sigs/s; launches "
          f"{launches}; mask equal to the 4-bit mask on all {total} rows and the host oracle "
          f"on {len(sample)}")

    u8, i32 = v8.prepare_batch(flat)
    u8_dev, i32_dev = torch.from_numpy(u8).to(dev), torch.from_numpy(i32).to(dev)

    def unpack_gather():
        y = unpack8(u8_dev, i32_dev)
        return comb.gather_entries8(y.s_nibbles, y.k_nibbles, y.key_idx, tables, b_tab)

    x = unpack8(u8_dev, i32_dev)
    entries = unpack_gather()
    groups, m = entries.shape[0] * entries.shape[1], entries.shape[2]
    acc = CG.tree_sum_xyzt(entries)
    plain = comb.tree_sum_packed(entries)
    err = int((acc.long() - plain.long()).abs().max().item())
    b_ms, b_by = bound(4 * (entries.numel() + acc.numel()), groups * (m - 1) * PADD_IMADS,
                       imad_per_s)
    ms = cuda_ms(lambda: CG.tree_sum_xyzt(entries), 20)
    g_ms = graph_ms(lambda: CG.tree_sum_xyzt(entries), 20)
    plain_ms = cuda_ms(lambda: comb.tree_sum_packed(entries), 2, 1)
    print(f"kernel tree_sum_xyzt at M = {m}: {groups} groups, equal {err == 0}, {ms:.4f} ms, "
          f"{g_ms:.4f} ms in a CUDA graph (plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms by {b_by})")
    if err != 0:
        fail(f"tree_sum_xyzt at M = {m} disagrees with its plain version (max abs err {err})")
    gather_ms = cuda_ms(unpack_gather, 10)
    finish_ms = cuda_ms(lambda: CG.finish_check(x.r_y, x.r_sign, acc), 20)
    print(f"8-bit device breakdown (CUDA events): unpack + gather {gather_ms:.3f} ms, tree "
          f"{ms:.3f} ms, finish {finish_ms:.3f} ms")
    return {"name": "tree_sum_xyzt", "route": "cuda", "source": CG.SOURCE,
            "replaces": "dag_rider_tpu/ops/pallas_group.py:211",
            "launches": launches["tree_sum_xyzt"], "max_abs_err": err, "ms": ms,
            "graph_ms": g_ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "lanes": groups, "entries_per_group": m}


def shared_coin_factory(coin_cls, keys, n: int, **coin_kw):
    """``(factory, oracle)``: n processes' threshold coins over one oracle
    coin's books (shares, group signatures, attempts). The (f + 1)-of-n
    combine and its pairing check are a pure function of the observed
    shares, the same at every process, so the cluster evaluates each wave's
    coin once instead of n times; every process still signs its own share.
    The books are never pruned: a lagging process still reads them."""
    oracle = coin_cls(keys, 0, n, **coin_kw)

    def make(i: int):
        coin = coin_cls(keys, i, n, **coin_kw)
        coin._shares, coin._sigma, coin._tried_at = (
            oracle._shares, oracle._sigma, oracle._tried_at)
        coin.prune_below = lambda wave: None
        return coin

    return make, oracle


def timed(fn, spent, key):
    """``fn`` that adds its wall time to ``spent[key]``."""
    def call(*args, **kw):
        t = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            spent[key] += time.perf_counter() - t
    return call


def reset_launch_counters() -> None:
    import torch

    from dag_rider_tpu_torch.ops import cuda_field, cuda_group as CG, cuda_group381 as G

    torch.cuda.synchronize()
    CG.reset_launches()
    G.reset_launches()
    cuda_field.reset_launches()


def read_launch_counters() -> dict:
    import torch

    from dag_rider_tpu_torch.ops import cuda_field, cuda_group as CG, cuda_group381 as G

    torch.cuda.synchronize()
    return {**CG.LAUNCHES, **CG.TABLE_LAUNCHES, **G.LAUNCHES, **cuda_field.LAUNCHES}


def timed_cluster(cfg, keys, signers, msm, spent, **sim_kw):
    """``(sim, oracle)``: the port's ``Simulation`` over ``cfg`` with threshold
    coins over one oracle's books (``shared_coin_factory``) and the given
    vertex signers, their host time booked in ``spent`` (vertex signing,
    coin share signing, the coin's combine with its pairing check);
    ``sim_kw`` goes to ``Simulation``."""
    from dag_rider_tpu_torch.consensus.coin import ThresholdCoin
    from dag_rider_tpu_torch.consensus.simulator import Simulation

    make, oracle = shared_coin_factory(ThresholdCoin, keys, cfg.n, msm=msm)

    def coin(i):
        c = make(i)
        c.my_share = timed(c.my_share, spent, "coin share signing")
        c._try_aggregate = timed(c._try_aggregate, spent, "coin combine + pairing check")
        return c

    class Signer:
        def __init__(self, inner):
            self.sign_vertex = timed(inner.sign_vertex, spent, "vertex signing")

    wrapped = [Signer(s) for s in signers]
    sim = Simulation(cfg, coin_factory=coin, signer_factory=lambda i: wrapped[i], **sim_kw)
    return sim, oracle


def drive_cluster(cfg, keys, signers, msm, *, verifier=None, cert=False, per_process=2,
                  calls=None, budget=None, until_quiet=False, named=None, between=None):
    """Build the port's cluster, run it, and split its host time: vertex
    signing, coin share signing, the coin's combine with its pairing
    check, the verify seam, and with certificates the certificate share
    signing, aggregation and pairing checks; the rest is the pump itself.

    ``verifier`` is the shared per-vertex verifier; with ``cert`` the
    cluster builds the named "device" verifier (a shared
    ``CUDAVerifier``) with the certificate MSM and pairing on the card;
    ``named`` builds that named verifier instead (``"sharded"``: a shared
    ``ShardedCUDAVerifier`` over ``mesh_from_env()``).
    The launch counters are set to 0 just before the first ``run`` call
    (after the comb tables exist). The run loop: ``calls`` calls if given,
    else until every view decided ``CONS_WAVES`` waves, or with
    ``until_quiet`` until a call delivers nothing. ``between(done, sim)`` runs
    after each ``run`` call (``done`` calls made so far)."""
    n = cfg.n
    budget = n * (n - 1) if budget is None else budget
    keys_spent = ["vertex signing", "coin share signing", "coin combine + pairing check"]
    if cert:
        keys_spent += ["certificate share signing", "certificate aggregation",
                       "certificate pairing checks"]
    spent = dict.fromkeys(keys_spent, 0.0)
    cert_msm_sizes = []
    if cert:
        sim, oracle = timed_cluster(cfg, keys, signers, msm, spent, verifier="device", cert=True)
        cv = sim.cert_verifier
        sim.processes[0].verifier.comb_tables()  # the tables, before the counters go to 0
        for p in sim.processes:
            p.cert_signer.sign_digest = timed(p.cert_signer.sign_digest, spent,
                                              "certificate share signing")
        sum_points = cv._sum_points

        def recorded_sum(points):
            cert_msm_sizes.append(len(points))
            return sum_points(points)

        cv._sum_points = recorded_sum
        cv.make_certificate = timed(cv.make_certificate, spent, "certificate aggregation")
        cv._pairing_check = timed(cv._pairing_check, spent, "certificate pairing checks")
    elif named is not None:
        sim, oracle = timed_cluster(cfg, keys, signers, msm, spent, verifier=named)
        sim.processes[0].verifier._comb_tables_dev()  # the tables, before the counters go to 0
    else:
        sim, oracle = timed_cluster(cfg, keys, signers, msm, spent,
                                    verifier_factory=lambda i: verifier)
    monitor = sim.attach_invariant_monitor()
    sim.submit_blocks(per_process=per_process)
    msgs, done = 0, 0
    reset_launch_counters()
    t = time.perf_counter()
    while True:
        if calls is not None:
            if done >= calls:
                break
        elif until_quiet:
            if done >= CONS_MAX_RUNS:
                break
        elif min(p.decided_wave for p in sim.processes) >= CONS_WAVES or done >= CONS_MAX_RUNS:
            break
        got = sim.run(max_messages=budget)
        msgs += got
        done += 1
        if between is not None:
            between(done, sim)
        if until_quiet and calls is None and got == 0:
            break
    wall = time.perf_counter() - t
    sim.check_agreement()
    if monitor.observed == 0:
        fail("consensus: the invariant monitor observed no delivery")
    spent["verify seam"] = sum(p.metrics.verify_seconds_total for p in sim.processes)
    spent["the rest (pump, admission, ordering)"] = wall - sum(spent.values())
    return sim, oracle, msgs, done, wall, spent, cert_msm_sizes


def split_line(spent) -> str:
    return ", ".join(f"{k} {v:.2f} s" for k, v in spent.items())


def consensus_phase() -> dict:
    """DAG-Rider at n = 256 through the port's ``Simulation``, with the
    shared ``CUDAVerifier`` (coalesced, pipelined) and card-MSM threshold
    coins in the loop; then the same construction with the host oracles
    (``CPUVerifier``, ``msm="host"``) and the same sequence of ``run``
    calls. Fails unless every view decided ``CONS_WAVES`` waves, the logs
    and leaders are byte-identical, the launches are exactly those of the
    dispatches and MSMs that ran, and nothing was contained. Returns the
    card run's launches per kernel, logs, group signatures, decided waves,
    message and call counts, wall, keys and signers (the sharded run's
    reference)."""
    import torch

    from dag_rider_tpu_torch import Config
    from dag_rider_tpu_torch.crypto import threshold as th
    from dag_rider_tpu_torch.ops import comb, cuda_group as CG
    from dag_rider_tpu_torch.verifier.base import KeyRegistry, VertexSigner
    from dag_rider_tpu_torch.verifier.cpu import CPUVerifier
    from dag_rider_tpu_torch.verifier.cuda import CUDAVerifier, unpack

    n = CONS_N
    cfg = Config(n=n, coin="threshold_bls", propose_empty=True, gc_depth=24)
    t0 = t_phase = time.perf_counter()
    keys = th.ThresholdKeys.generate(n, cfg.f + 1)
    reg, seeds = KeyRegistry.generate(n)
    signers = [VertexSigner(s) for s in seeds]
    card_ver = CUDAVerifier(reg)
    card_ver.comb_tables()
    torch.cuda.synchronize()
    print(f"consensus set-up (n {n}, threshold {cfg.f + 1}): keys and device tables "
          f"{time.perf_counter() - t0:.2f} s")

    msm_sizes, msm_walls = [], []
    card_msm = msm_recorder(msm_sizes, msm_walls)

    # -- the card run: counters at 0 just before, read just after --------------
    sim, oracle, msgs, calls, wall, spent, _ = drive_cluster(cfg, keys, signers, card_msm,
                                                             verifier=card_ver)
    launches = read_launch_counters()
    pipe = sim._verify_pipe
    waves = min(p.decided_wave for p in sim.processes)
    if waves < CONS_WAVES:
        fail(f"consensus: {waves} waves decided in the slowest view after {calls} runs, "
             f"want {CONS_WAVES}")
    rs = pipe.resilience_stats()
    contained = {k: rs[k] for k in ("poisoned_windows", "quarantined", "quarantine_rejected")}
    if any(contained.values()):
        fail(f"consensus: the verify pipeline contained faults {contained}")
    want = want_launches(pipe.dispatches, msm_sizes)
    if pipe.dispatches <= 0 or not msm_sizes or launches != want:
        fail(f"consensus launches {launches}, want {want} ({pipe.dispatches} dispatches, "
             f"MSMs of {msm_sizes} points)")
    sizes = [len(d) for d in sim.deliveries]
    applied = sum(p.metrics.verify_sigs_total for p in sim.processes)
    commit = [s for p in sim.processes for s in p.metrics.wave_commit_seconds]
    interval = [s for p in sim.processes for s in p.metrics.wave_interval_seconds]
    rounds = [p.round for p in sim.processes]
    print(f"consensus (card): {calls} runs, rounds {min(rounds)}-{max(rounds)}, waves decided "
          f"{waves} (min over views), vertices delivered per view {min(sizes)}-{max(sizes)}, "
          f"{msgs} messages, wall {wall:.2f} s")
    print(f"  signatures: {applied} applied, {pipe.sigs_dispatched} dispatched in "
          f"{pipe.dispatches} dispatches; {applied / wall:.0f} applied sigs/s of the wall, "
          f"{pipe.sigs_dispatched / pipe.seam_s:.0f} dispatched sigs/s of the verify seam; "
          f"verify seam {pipe.seam_s:.3f} s, of it pipeline wait {pipe.wait_s:.3f} s")
    print(f"  wave commit p50 {statistics.median(commit) * 1e3:.3f} ms ({len(commit)} samples), "
          f"wave interval p50 {statistics.median(interval) * 1e3:.1f} ms "
          f"({len(interval)} samples)")
    print(f"  coin: {len(msm_sizes)} MSMs of {sorted(set(msm_sizes))} points, wall "
          f"{sum(msm_walls) * 1e3:.1f} ms (median {statistics.median(msm_walls) * 1e3:.2f} ms); "
          f"leaders {[th.leader_from_sigma(s, n) for _, s in sorted(oracle._sigma.items())]}")
    print(f"  launches {launches}; contained {contained}")
    print(f"  host split: {split_line(spent)}; the card's work lies inside the verify seam and "
          f"the coin MSMs ({pipe.seam_s + sum(msm_walls):.3f} s of the {wall:.2f} s wall)")

    # -- the host-oracle run, the same sequence of run calls --------------------
    host, host_oracle, host_msgs, _, host_wall, host_spent, _ = drive_cluster(
        cfg, keys, signers, "host", verifier=CPUVerifier(reg), calls=calls)
    logs = [[(v.id.round, v.id.source, v.digest()) for v in d] for d in sim.deliveries]
    host_logs = [[(v.id.round, v.id.source, v.digest()) for v in d] for d in host.deliveries]
    if not any(logs):
        fail("consensus: nothing was delivered")
    if logs != host_logs:
        bad = [i for i, (a, b) in enumerate(zip(logs, host_logs)) if a != b]
        fail(f"consensus: the card run's logs differ from the host oracle's at views {bad[:10]}")
    if oracle._sigma != host_oracle._sigma:
        fail("consensus: the card coins' group signatures (leaders) differ from the host coins'")
    decided = [p.decided_wave for p in sim.processes]
    if decided != [p.decided_wave for p in host.processes] or msgs != host_msgs:
        fail("consensus: decided waves or message counts differ from the host oracle run")
    print(f"consensus (host oracle): logs of all {n} views, {len(oracle._sigma)} leaders and "
          f"decided waves byte-identical; wall {host_wall:.2f} s; host split: "
          f"{split_line(host_spent)}")

    # the path's kernels against their plain versions at its dispatch width:
    # one round of n signed vertices from the run
    rnd = [v for v in sim.deliveries[0] if v.signature is not None][-n:]
    u8, i32 = card_ver.prepare_batch(rnd)
    x = unpack(torch.from_numpy(u8).cuda(), torch.from_numpy(i32).cuda())
    tables, b_tab = card_ver.comb_tables()
    entries = comb.gather_entries(x.s_nibbles, x.k_nibbles, x.key_idx, tables, b_tab)
    acc = CG.tree_sum_xyzt(entries)
    ok_tree = torch.equal(acc, comb.tree_sum_packed(entries))
    ok_finish = torch.equal(CG.finish_check(x.r_y, x.r_sign, acc),
                            CG.finish_check_plain(x.r_y, x.r_sign, acc))
    print(f"  kernels at the consensus dispatch width ({u8.shape[0]} rows, {len(rnd)} real): "
          f"tree_sum_xyzt equal {ok_tree}, finish_check equal {ok_finish}")
    if not (ok_tree and ok_finish):
        fail("consensus: a kernel disagrees with its plain version at the consensus width")
    print(f"consensus phase wall (set-up, both runs, checks): "
          f"{time.perf_counter() - t_phase:.2f} s")
    return {"launches": launches, "logs": logs, "sigma": oracle._sigma, "decided": decided,
            "msgs": msgs, "calls": calls, "wall": wall, "keys": keys, "signers": signers,
            "verifier": card_ver}


def consensus_cert_phase() -> dict:
    """``BASELINE.json`` config #4 whole: DAG-Rider at n = 256 with the
    threshold-BLS coin and aggregate round certificates, the certificate
    MSM and pairing on the card, against the same cluster without
    certificates on the card. The construction is the one whose commit is
    independent of certificates (``tests/test_cert.py:241-280``): every
    process submits ``CERT_BLOCKS`` blocks and proposes no empty vertex,
    and one ``run`` call drives the cluster until it is quiet (a run cut
    by a message budget lets certificates change which vertices a
    proposer has in hand, in the JAX package as here). Fails unless the
    logs, leaders and decided waves are byte-identical, certificates were
    assembled and saved signatures, none was rejected, fewer signatures
    were verified, nothing was contained, no check took the host route,
    and the launches are exactly those of the dispatches and MSMs that
    ran. Returns the certificate run's launches per kernel."""
    import torch

    from dag_rider_tpu_torch import Config
    from dag_rider_tpu_torch.crypto import bls12381 as bls, threshold as th
    from dag_rider_tpu_torch.ops import bls_pairing
    from dag_rider_tpu_torch.verifier.base import KeyRegistry, VertexSigner
    from dag_rider_tpu_torch.verifier.cuda import CUDAVerifier

    n = CONS_N
    cfg = Config(n=n, coin="threshold_bls", propose_empty=False, gc_depth=24)
    t_phase = time.perf_counter()
    keys = th.ThresholdKeys.generate(n, cfg.f + 1)
    reg, seeds = KeyRegistry.generate(n)
    signers = [VertexSigner(s) for s in seeds]
    card_ver = CUDAVerifier(reg)
    card_ver.comb_tables()
    torch.cuda.synchronize()
    runs = {}
    for name, cert in (("off", False), ("on", True)):
        msm_sizes, msm_walls = [], []
        card_msm = msm_recorder(msm_sizes, msm_walls)
        bls_pairing.reset_host_routed()
        bls.reset_sign_host_rows()
        sim, oracle, msgs, calls, wall, spent, cert_sizes = drive_cluster(
            cfg, keys, signers, card_msm, verifier=None if cert else card_ver, cert=cert,
            per_process=CERT_BLOCKS, budget=10**9, until_quiet=True)
        launches = read_launch_counters()
        pipe = sim._verify_pipe
        rs = pipe.resilience_stats()
        contained = {k: rs[k] for k in ("poisoned_windows", "quarantined", "quarantine_rejected")}
        if any(contained.values()):
            fail(f"consensus ({name} certificates): the pipeline contained faults {contained}")
        want = want_launches(pipe.dispatches, msm_sizes + cert_sizes)
        if pipe.dispatches <= 0 or launches != want:
            fail(f"consensus ({name} certificates): launches {launches}, want {want} "
                 f"({pipe.dispatches} dispatches, coin MSMs of {msm_sizes} points, "
                 f"certificate MSMs of {cert_sizes})")
        if bls_pairing.HOST_ROUTED["checks"] or any(bls.SIGN_HOST_ROWS.values()):
            fail(f"consensus ({name} certificates): host routes taken: pairing "
                 f"{bls_pairing.HOST_ROUTED}, signing {bls.SIGN_HOST_ROWS}")
        waves = min(p.decided_wave for p in sim.processes)
        if waves < CONS_WAVES:
            fail(f"consensus ({name} certificates): {waves} waves decided, want {CONS_WAVES}")
        snaps = [p.metrics.snapshot() for p in sim.processes]
        books = {k: sum(sn.get(k, 0) for sn in snaps)
                 for k in ("certs_assembled", "certs_verified", "sigs_saved", "certs_rejected",
                           "cert_rounds_degraded")}
        verified = sum(p.metrics.verify_sigs_total for p in sim.processes)
        admitted = verified + books["sigs_saved"]  # checked one by one or by a certificate
        commit = [x for p in sim.processes for x in p.metrics.wave_commit_seconds]
        interval = [x for p in sim.processes for x in p.metrics.wave_interval_seconds]
        rounds = [p.round for p in sim.processes]
        sizes = [len(d) for d in sim.deliveries]
        runs[name] = {"sim": sim, "oracle": oracle, "verified": verified, "books": books,
                      "launches": launches}
        print(f"consensus with certificates {name} (card; n {n}, {CERT_BLOCKS} blocks a "
              f"process, run until quiet): {calls} runs, rounds {min(rounds)}-{max(rounds)}, "
              f"waves decided {waves}, vertices delivered per view {min(sizes)}-{max(sizes)}, "
              f"{msgs} messages, wall {wall:.2f} s")
        print(f"  signatures: {admitted} admitted ({verified} verified one by one, "
              f"{books['sigs_saved']} by a certificate), {pipe.sigs_dispatched} dispatched in "
              f"{pipe.dispatches} dispatches; {admitted / wall:.0f} admitted sigs/s of the wall, "
              f"{pipe.sigs_dispatched / pipe.seam_s:.0f} dispatched sigs/s of the verify seam "
              f"({pipe.seam_s:.3f} s)")
        print(f"  wave commit p50 {statistics.median(commit) * 1e3:.3f} ms ({len(commit)} "
              f"samples), wave interval p50 {statistics.median(interval) * 1e3:.1f} ms "
              f"({len(interval)} samples); coin MSMs {len(msm_sizes)}, "
              f"{sum(msm_walls) * 1e3:.1f} ms")
        if cert:
            cv = sim.cert_verifier
            if (cv.msm, cv.pair, cv.device.type) != ("device", "device", "cuda"):
                fail(f"consensus: the certificate verifier runs msm {cv.msm!r}, pair "
                     f"{cv.pair!r} on {cv.device}; want both on the card")
            print(f"  certificates: {books}; pairing checks {cv.stats['pairing_checks']} "
                  f"({spent['certificate pairing checks']:.2f} s summed), verifier stats "
                  f"{cv.stats}; certificate MSMs {len(cert_sizes)} of "
                  f"{sorted(set(cert_sizes))} points; host certificate-share signing "
                  f"{spent['certificate share signing']:.2f} s")
        print(f"  launches {launches}; host split: {split_line(spent)}")
    off, on = runs["off"], runs["on"]
    logs = [[(v.id.round, v.id.source, v.digest()) for v in d] for d in on["sim"].deliveries]
    ref = [[(v.id.round, v.id.source, v.digest()) for v in d] for d in off["sim"].deliveries]
    if not any(ref) or logs != ref:
        bad = [i for i, (a, b) in enumerate(zip(logs, ref)) if a != b]
        fail(f"consensus: the certificate run's logs differ from the run without at views "
             f"{bad[:10]}")
    if on["oracle"]._sigma != off["oracle"]._sigma:
        fail("consensus: the leaders differ between the runs with and without certificates")
    if [p.decided_wave for p in on["sim"].processes] != [
            p.decided_wave for p in off["sim"].processes]:
        fail("consensus: decided waves differ between the runs with and without certificates")
    b = on["books"]
    if b["certs_assembled"] <= 0 or b["sigs_saved"] <= 0 or b["certs_rejected"] != 0:
        fail(f"consensus: certificate books {b}; want assembled > 0, sigs_saved > 0, "
             f"rejected 0")
    if on["verified"] >= off["verified"]:
        fail(f"consensus: {on['verified']} signatures verified with certificates, "
             f"{off['verified']} without; want fewer")
    print(f"consensus with certificates: logs of all {n} views, {len(off['oracle']._sigma)} "
          f"leaders and decided waves byte-identical to the run without; signatures verified "
          f"{on['verified']} against {off['verified']}; phase wall "
          f"{time.perf_counter() - t_phase:.2f} s")
    return on["launches"]


class OpCount:
    """Counts the aten ops dispatched inside a ``with`` block: each op
    launches one or more kernels on the card (a CUDA graph's replay is
    not an op; its kernels are counted where it was captured)."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        count = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                count.ops += 1
                return func(*args, **(kwargs or {}))

        self.ops = 0
        self._mode = Mode()

    def __enter__(self):
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)


def device_kernels(fn):
    """(kernels, device ms) the CUDA profiler saw while ``fn`` ran, or
    (None, None) when it records no device activity."""
    return profiled(fn)[1:]


def field381_imads() -> int:
    """int32 multiply-adds of one ``field381.mul``: the 33 x 33 schoolbook
    columns and the fold through FOLD's nonzero entries (carries left
    out, like every bound here)."""
    from dag_rider_tpu_torch.ops import field381 as F

    return F.LIMBS * F.LIMBS + int((F.FOLD != 0).sum())


def pairing_bound(pairs: int, imad_per_s: float):
    """(least ms, bound_by, field products) of one device Miller product
    over ``pairs`` pairs: the line evaluations (68 steps x 12 products a
    pair), the cross-pair tree (pairs - 1 Fp12 products a step, 72 field
    products each) and the schedule walk (131 Fp12 products); bytes: the
    line coefficients and the points read once, the product written."""
    products = 68 * pairs * 12 + (pairs - 1) * 68 * 72 + 131 * 72
    bytes_moved = 4 * (2 * 68 * pairs * 12 * 33 + 2 * pairs * 33 + 12 * 33)
    ms, by = bound(bytes_moved, products * field381_imads(), imad_per_s)
    return ms, by, products


def pairing_phase(dev, reg, cert_sks, cert, imad_per_s: float) -> dict:
    """The certificate's aggregate check at n = 256 (171 signers, 172
    pairs) through the device Miller product against the host's: the host
    Miller product (the loop of ``bls12381.multi_pairing_check`` stopped
    before the final exponentiation) must equal the device's exactly, and
    both verdicts must be True; the check's wall split; then forged
    certificates on the card and the Byzantine matrix of
    ``tests/test_cert_phase2.py:148-206`` at its own committee of 4, each
    verdict equal to the host pairing's. Returns the program's row."""
    import dataclasses
    import hashlib

    import torch

    from dag_rider_tpu_torch.crypto import bls12381 as bls
    from dag_rider_tpu_torch.ops import bls_pairing as BP, field381 as F
    from dag_rider_tpu_torch.verifier.base import CertSigner, KeyRegistry
    from dag_rider_tpu_torch.verifier.cert import CertVerifier

    BP.reset_host_routed()
    cv = CertVerifier(reg, CERT_QUORUM)  # the port's defaults: MSM and pairing on the card
    if (cv.msm, cv.pair, cv.device.type) != ("device", "device", "cuda"):
        fail(f"CertVerifier defaults: msm {cv.msm!r}, pair {cv.pair!r} on {cv.device}")

    def sync_s(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    # host set-up, cold (hash and G2 line caches emptied) and warm
    bls.hash_g1_cache_clear()
    bls._G2_PRECOMP.clear()
    BP._SLOT_CACHE.clear()
    pairs, t_pairs = sync_s(lambda: cv._cert_pairs(cert))
    host, t_cold = sync_s(lambda: BP.marshal(pairs))
    host, t_warm = sync_s(lambda: BP.marshal(pairs))
    xp, yp, slots = host
    n_pairs = xp.shape[0]
    # the device split, stage by stage (each stage's wall, launches included)
    tensors, t_copy = sync_s(lambda: [torch.from_numpy(a).to(dev) for a in (xp, yp, *slots)])
    xp_d, yp_d, dl, dc, al, ac = tensors
    evals, t_eval = sync_s(lambda: torch.cat([BP.eval_lines(dl, dc, xp_d, yp_d),
                                              BP.eval_lines(al, ac, xp_d, yp_d)]))
    prod, t_tree = sync_s(lambda: BP.tree_product(evals))
    dprod, aprod = prod[:63], prod[63:]
    canon, t_walk_cold = sync_s(lambda: BP.walk_on_device(dprod, aprod))  # captures the graph
    canon, t_walk = sync_s(lambda: BP.walk_on_device(dprod, aprod))
    eager, t_walk_eager = sync_s(lambda: BP.walk(dprod, aprod))
    acc = eager  # a canonical Fp12 element: canonical of it is itself
    _, t_canon = sync_s(lambda: F.canonical(acc))
    if not torch.equal(canon, eager):
        fail("pairing: the walk replayed from its CUDA graph differs from the eager walk")
    device_fm = BP.to_host_fp12(canon)
    host_fm, t_host_miller = sync_s(lambda: BP.host_miller_product(pairs))
    if device_fm != host_fm:
        fail("pairing: the device Miller product differs from the host's")
    ok_dev, t_fexp = sync_s(lambda: bls.final_exponentiation(device_fm) == bls.FP12_ONE)
    ok_host = bls.final_exponentiation(host_fm) == bls.FP12_ONE
    if not (ok_dev and ok_host):
        fail(f"pairing: the certificate's verdicts are device {ok_dev}, host {ok_host}")
    # the whole check through the verifier, warm (memo-free verifiers)
    walls = []
    for _ in range(3):
        fresh = CertVerifier(reg, CERT_QUORUM)
        ok, w = sync_s(lambda: fresh.verify_certificate(cert))
        walls.append(w)
        if not ok:
            fail("pairing: the certificate does not verify through the card pairing")
    with OpCount() as ops:
        BP.multi_pairing_check(pairs, dev)
    with OpCount() as walk_ops:
        BP.walk(dprod, aprod)
    kernels, busy_ms = device_kernels(lambda: BP.multi_pairing_check(pairs, dev))
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    BP.multi_pairing_check(pairs, dev)
    peak = torch.cuda.max_memory_allocated() - base_mem
    b_ms, b_by, products = pairing_bound(n_pairs, imad_per_s)
    wall = statistics.median(walls)
    print(f"pairing (certificate, {n_pairs} pairs): device Miller product equal to the host's, "
          f"both verdicts True; check wall median {wall * 1e3:.1f} ms (runs "
          f"{[round(w * 1e3, 1) for w in walls]} ms) against the host's Miller product "
          f"{t_host_miller:.2f} s + final exponentiation {t_fexp:.3f} s")
    print(f"  split: host set-up hash_to_g1 {t_pairs:.3f} s, _slot_limbs cold {t_cold:.3f} s / "
          f"warm {t_warm * 1e3:.1f} ms; copies {t_copy * 1e3:.2f} ms, line evaluation "
          f"{t_eval * 1e3:.2f} ms, cross-pair tree {t_tree * 1e3:.2f} ms, schedule walk with "
          f"canonical {t_walk * 1e3:.2f} ms from its CUDA graph (capture {t_walk_cold:.2f} s, "
          f"eager {t_walk_eager * 1e3:.2f} ms), canonical alone {t_canon * 1e3:.2f} ms; host final "
          f"exponentiation {t_fexp * 1e3:.1f} ms")
    print(f"  torch ops launched from the host per check {ops.ops} (the walk's "
          f"{walk_ops.ops} replay from one CUDA graph); kernels on the card per check "
          f"{kernels if kernels is not None else 'not measured'}, their device time "
          f"{f'{busy_ms:.2f} ms' if busy_ms is not None else 'not measured'}; peak device "
          f"memory {peak / 2**20:.0f} MiB over the resident; {products} field products, bound "
          f"{b_ms:.4f} ms by {b_by}")
    # forged certificates, on the card only: one digest substituted, and
    # another round's aggregate over the same signers
    other_digests = [hashlib.sha512(b"round-8|" + i.to_bytes(4, "little")).digest()
                     for i in cert.signers]
    other_sigs = bls.sign_many([cert_sks[i] for i in cert.signers], other_digests,
                               backend="native")
    other = cv.make_certificate(8, list(zip(cert.signers, other_digests, other_sigs)))
    forged = [dataclasses.replace(cert, digests=cert.digests[:3] + (bytes(64),)
                                  + cert.digests[4:]),
              dataclasses.replace(cert, agg_sig=other.agg_sig)]
    for i, c in enumerate(forged):
        if CertVerifier(reg, CERT_QUORUM).verify_certificate(c):
            fail(f"pairing: forged certificate {i} verified on the card")
    # the Byzantine matrix at its own committee of 4
    sreg, _, ssks = KeyRegistry.generate_with_cert(4)

    def small_entries(tag):
        ds = [bytes([i]) * 16 + tag.ljust(16, b".") for i in range(4)]
        return [(i, d, CertSigner(sk).sign_digest(d)) for i, (sk, d) in enumerate(zip(ssks, ds))]

    host_v = CertVerifier(sreg, quorum=3, msm="host", pair="host")
    full = host_v.make_certificate(3, small_entries(b"byz"))
    q = host_v.make_certificate(4, small_entries(b"byq")[:3])
    matrix = [full, q,
              dataclasses.replace(q, signers=(0, 1, 3)), dataclasses.replace(q, signers=(0, 1, 1)),
              dataclasses.replace(q, signers=(0, 1, 9)), dataclasses.replace(q, signers=(0, 1)),
              dataclasses.replace(q, digests=(q.digests[0], b"stale-digest!".ljust(32, b"?"),
                                              q.digests[2])),
              dataclasses.replace(q, agg_sig=bls.g1_compress(bls.g1_mul(0xBAD))),
              dataclasses.replace(q, agg_sig=b"\xff" * 48)]
    card_v = CertVerifier(sreg, quorum=3)
    verdicts = [card_v.verify_certificate(c) for c in matrix]
    host_verdicts = [host_v.verify_certificate(c) for c in matrix]
    if verdicts != host_verdicts or verdicts[:2] != [True, True] or any(verdicts[2:]):
        fail(f"pairing: Byzantine matrix verdicts {verdicts} on the card, {host_verdicts} host")
    if BP.HOST_ROUTED["checks"]:
        fail(f"pairing: {BP.HOST_ROUTED['checks']} checks took the host route")
    print(f"  forged certificates (a substituted digest, another round's aggregate) rejected on "
          f"the card; Byzantine matrix (n 4, {len(matrix)} certificates) verdicts {verdicts} equal "
          f"to the host's; pairing_checks {card_v.stats['pairing_checks']}; host-routed checks 0")
    return {"name": "bls_pairing.multi_pairing_check", "replaces":
            "dag_rider_tpu/ops/bls_pairing.py:257 (jnp, no pallas_call)",
            "pairs": n_pairs, "wall_ms": wall * 1e3, "eval_ms": t_eval * 1e3,
            "tree_ms": t_tree * 1e3, "walk_graph_ms": t_walk * 1e3,
            "walk_eager_ms": t_walk_eager * 1e3, "host_setup_cold_s": t_pairs + t_cold,
            "final_exp_ms": t_fexp * 1e3, "host_miller_s": t_host_miller,
            "torch_ops": ops.ops, "kernels": kernels, "device_ms": busy_ms,
            "peak_bytes": peak, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def spans_phase(dev, reg, cert_sks) -> dict:
    """Four consecutive round certificates at n = 256 made on the card and
    folded into one span: the span aggregate byte-identical to the host
    group law's, with exactly one 4-point MSM's launches; ``verify_span``
    on the card True, and False for each mutation of
    ``tests/test_cert_phase2.py:296-334``. Returns the span MSM's
    launches."""
    import dataclasses
    import hashlib
    import random

    import torch

    from dag_rider_tpu_torch.crypto import bls12381 as bls
    from dag_rider_tpu_torch.ops import bls_pairing as BP, cuda_group381 as G
    from dag_rider_tpu_torch.verifier.cert import CertVerifier

    cv = CertVerifier(reg, CERT_QUORUM)
    rng = random.Random(SEED + 4)
    certs = []
    t0 = time.perf_counter()
    for r in range(5, 9):
        signers = sorted(rng.sample(range(BLS_N), CERT_QUORUM))
        digests = [hashlib.sha512(b"round-%d|" % r + i.to_bytes(4, "little")).digest()
                   for i in signers]
        sigs = bls.sign_many([cert_sks[i] for i in signers], digests, backend="native")
        certs.append(cv.make_certificate(r, list(zip(signers, digests, sigs))))
    t_certs = time.perf_counter() - t0
    torch.cuda.synchronize()
    G.reset_launches()
    span, t_span = None, time.perf_counter()
    span = cv.make_span(5, certs)
    torch.cuda.synchronize()
    t_span = time.perf_counter() - t_span
    launches = dict(G.LAUNCHES)
    host = CertVerifier(reg, CERT_QUORUM, msm="host", pair="host").make_span(5, certs)
    if span is None or span != host:
        fail("span: the span certificate differs from the host group law's")
    if launches != msm_launches([4]):
        fail(f"span: make_span launched {launches}, want one 4-point MSM's {msm_launches([4])}")
    pairs = 1 + sum(len(s) for s in span.signers)
    walls = []
    for _ in range(2):
        fresh = CertVerifier(reg, CERT_QUORUM)
        torch.cuda.synchronize()
        t = time.perf_counter()
        ok = fresh.verify_span(span)
        walls.append(time.perf_counter() - t)
        if not ok:
            fail("span: the span does not verify on the card")
    # the warm check's split: hashing the 684 digests (the hash cache holds
    # 256, so a span's digests miss it), then the pairing check alone
    t = time.perf_counter()
    hashed = [bls.hash_to_g1(d) for ds in span.digests for d in ds]
    t_hash = time.perf_counter() - t
    span_pairs = [(bls.g1_decompress(span.agg_sig), bls.g2_neg(bls.G2_GEN))] + [
        (h, reg.bls_key_of(src)) for h, src in zip(hashed, (x for s in span.signers for x in s))]
    torch.cuda.synchronize()
    t = time.perf_counter()
    ok = BP.multi_pairing_check(span_pairs, dev)
    torch.cuda.synchronize()
    t_check = time.perf_counter() - t
    if not ok:
        fail("span: the span's pairs do not check on the card")
    mutations = [
        dataclasses.replace(span, agg_sig=bls.g1_compress(bls.g1_mul(0xBAD))),
        dataclasses.replace(span, agg_sig=b"\xff" * 48),
        dataclasses.replace(span, digests=(span.digests[0], (b"swapped!".ljust(32, b"?"),)
                                           + span.digests[1][1:]) + span.digests[2:]),
        dataclasses.replace(span, signers=(span.signers[0][:2],) + span.signers[1:],
                            digests=(span.digests[0][:2],) + span.digests[1:]),
        dataclasses.replace(span, signers=(span.signers[0], span.signers[1][:-1] + (BLS_N + 3,))
                            + span.signers[2:]),
        dataclasses.replace(span, first_round=0),
    ]
    mwalls = []
    for i, m in enumerate(mutations):
        t = time.perf_counter()
        if CertVerifier(reg, CERT_QUORUM).verify_span(m):
            fail(f"span: mutation {i} verified on the card")
        mwalls.append(time.perf_counter() - t)
    if BP.HOST_ROUTED["checks"]:
        fail(f"span: {BP.HOST_ROUTED['checks']} checks took the host route")
    print(f"span (4 rounds, {pairs} pairs): agg_sig {span.agg_sig.hex()[:16]}... equal to the host "
          f"group law; make_span {t_span * 1e3:.1f} ms, launches {launches}; verify_span on the "
          f"card True, wall {[round(w, 3) for w in walls]} s (cold, warm); of a warm check: "
          f"hash_to_g1 of the digests {t_hash:.3f} s, the pairing check {t_check:.3f} s; "
          f"{len(mutations)} mutations rejected ({[round(w, 3) for w in mwalls]} s); 4 "
          f"certificates made in {t_certs:.2f} s")
    return launches


def signing_phase(dev, cert_sks, imad_per_s: float) -> dict:
    """``sign_many`` over 171 digests with distinct keys, plus rows with
    sk = 0 mod r, on the device lane (the card) and the native lane (the
    ctypes C library), each byte-for-byte ``[sign(sk, m) ...]``; the host
    routes counted and 0; each lane's wall beside the host's. Returns the
    device ladder's row."""
    import hashlib

    import torch

    from dag_rider_tpu_torch.crypto import bls12381 as bls
    from dag_rider_tpu_torch.ops import bls_g1, field381 as F, native381

    t0 = time.perf_counter()
    if native381.load() is None:
        fail(f"the native381 library did not build from {native381.SRC}")
    print(f"native381 library: {native381.library_path().name}, gcc "
          f"{native381.last_build_s:.2f} s, load {time.perf_counter() - t0:.2f} s")
    sks = [cert_sks[i] for i in range(CERT_QUORUM)] + [bls.R, 2 * bls.R]
    msgs = [hashlib.sha512(b"sign|" + i.to_bytes(4, "little")).digest()[:32]
            for i in range(len(sks))]
    domain = b"dagrider-coin-v1"
    retries = sum(1 for m in msgs if pow((bls._hash_candidate_x(m, domain, 0) ** 3 + 4) % bls.P,
                                         (bls.P - 1) // 2, bls.P) != 1)
    if not retries:
        fail("signing: no row needs a second hash-to-curve candidate")
    want = [bls.sign(sk, m) for sk, m in zip(sks, msgs)]
    walls = {}
    for lane in ("host", "native", "device", "device"):
        bls.hash_g1_cache_clear()
        bls.reset_sign_host_rows()
        native381.reset_host_rows()
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = bls.sign_many(sks, msgs, backend=lane)
        torch.cuda.synchronize()
        w = time.perf_counter() - t
        walls[lane if lane not in walls else "device warm"] = w
        if got != want:
            bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
            fail(f"signing: the {lane} lane differs from sign at rows {bad[:10]}")
        if any(bls.SIGN_HOST_ROWS.values()) or any(native381.HOST_ROWS.values()):
            fail(f"signing: the {lane} lane took host routes {bls.SIGN_HOST_ROWS}, "
                 f"{native381.HOST_ROWS}")
    # the device ladder alone at the lane's rows and width, eager and replayed
    rows = [(sk % bls.R) * bls._H1_COFACTOR for sk in sks if sk % bls.R]
    pts = [bls.hash_to_g1(m) for sk, m in zip(sks, msgs) if sk % bls.R]
    bits, nbits = bls_g1._bit_columns(rows)
    px = torch.from_numpy(F.to_limbs_bulk([p[0] for p in pts])).to(dev)
    py = torch.from_numpy(F.to_limbs_bulk([p[1] for p in pts])).to(dev)
    bd = torch.from_numpy(bits).to(dev)
    times = {}
    outs = {}
    for graph in (False, True):
        torch.cuda.synchronize()
        t = time.perf_counter()
        outs[graph] = bls_g1.ladder(px, py, bd, graph=graph)
        torch.cuda.synchronize()
        times[graph] = time.perf_counter() - t
    if not all(torch.equal(a, b) for a, b in zip(outs[False], outs[True])):
        fail("signing: the ladder replayed from its CUDA graph differs from the eager ladder")
    with OpCount() as step_ops:
        one = F.const("ONE", dev).expand(len(rows), F.LIMBS)
        state = torch.zeros((3, len(rows), F.LIMBS), dtype=torch.int32, device=dev)
        bls_g1.ladder_step(state, torch.ones(len(rows), dtype=torch.bool, device=dev),
                           px, py, one, bd[0])
    n_rows = len(rows)
    inv = (bls.P - 2).bit_length() - 1 + bin(bls.P - 2).count("1") - 1 + 4
    products = nbits * n_rows * 18 + n_rows * inv
    imads = products * field381_imads() + nbits * n_rows * 9 * F.LIMBS
    # bytes: the points read, the bit columns (one byte a bit), the affine
    # results and the two masks written
    b_ms, b_by = bound(n_rows * (4 * 4 * F.LIMBS + nbits + 2), imads, imad_per_s)
    print(f"signing ({len(sks)} rows: {CERT_QUORUM} distinct keys, 2 with sk = 0 mod r; {retries} "
          f"rows need a second hash candidate): device and native lanes byte-identical to sign; "
          f"host routes 0; wall host {walls['host']:.3f} s, native {walls['native']:.3f} s, "
          f"device {walls['device']:.3f} s (cold, the step graph captured) / "
          f"{walls['device warm']:.3f} s (warm)")
    print(f"  device ladder alone ({n_rows} rows, {nbits} bit columns): eager "
          f"{times[False]:.3f} s, replayed step by step from a CUDA graph {times[True]:.3f} s; "
          f"{step_ops.ops} torch ops a step; {products} field products, bound {b_ms:.4f} ms "
          f"by {b_by}")
    return {"name": "bls_g1.g1_ladder_batch", "replaces":
            "dag_rider_tpu/ops/bls_g1.py:175 (jnp lax.scan, no pallas_call)",
            "rows": n_rows, "bit_columns": nbits, "ladder_eager_s": times[False],
            "ladder_graph_s": times[True], "step_torch_ops": step_ops.ops,
            "sign_many_s": {k: v for k, v in walls.items()}, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None}


def msm_launches(sizes) -> dict:
    """Kernel launches of MSMs over ``sizes`` points: per MSM over T padded
    points, 15 table steps and the log2 T tree levels through padd381_xx,
    and the Horner chain with its canonical tail in one horner381."""
    from dag_rider_tpu_torch.ops import bls_msm

    ts = [bls_msm._pad(n) for n in sizes]
    return {"padd381_xx": sum(15 + t.bit_length() - 1 for t in ts), "horner381": len(ts)}


def bls_phases(dev, imad_per_s: float):
    """The BLS12-381 MSM path at n = 256 through ``padd381_xx`` and
    ``horner381``, then the certificate's device pairing, the span and the
    signing lanes; returns the two kernels' report rows and the device
    programs' rows. Fails on any mismatch."""
    import dataclasses
    import hashlib
    import random

    import numpy as np
    import torch

    from dag_rider_tpu_torch.consensus.coin import ThresholdCoin
    from dag_rider_tpu_torch.crypto import bls12381 as bls, threshold as th
    from dag_rider_tpu_torch.ops import bls_msm, cuda_group381 as G, field381 as F
    from dag_rider_tpu_torch.verifier.base import CertSigner, KeyRegistry
    from dag_rider_tpu_torch.verifier.cert import CertVerifier

    # one complete addition: 12 general 33x33 products, each with its fold
    # through FOLD's nonzero entries, and 2 multiplies by 12
    imads_per_lane = 12 * (F.LIMBS * F.LIMBS + int((F.FOLD != 0).sum())) + 2 * F.LIMBS

    # -- set-up: keys, shares, certificate signatures -------------------------
    t0 = time.perf_counter()
    keys = th.ThresholdKeys.generate(BLS_N, BLS_THRESHOLD)
    t_keys = time.perf_counter() - t0
    t0 = time.perf_counter()
    waves = {w: {i: th.sign_share(keys.share_sks[i], w) for i in range(BLS_N)}
             for w in (1, 2)}
    waves[2][BAD_SHARE] = th.sign_share(keys.share_sks[BAD_SHARE], 2 + 991)
    t_shares = time.perf_counter() - t0
    t0 = time.perf_counter()
    reg, _, cert_sks = KeyRegistry.generate_with_cert(BLS_N)
    rng = random.Random(SEED)
    signers = sorted(rng.sample(range(BLS_N), CERT_QUORUM))
    entries = []
    for i in signers:
        digest = hashlib.sha512(b"round-7|" + i.to_bytes(4, "little")).digest()
        entries.append((i, digest, CertSigner(cert_sks[i]).sign_digest(digest)))
    t_cert_keys = time.perf_counter() - t0
    print(f"bls set-up: threshold keys {t_keys:.2f} s, {2 * BLS_N} shares "
          f"{t_shares:.2f} s, certificate keys + {CERT_QUORUM} signatures {t_cert_keys:.2f} s")

    # the MSMs' real inputs: the coin's f + 1 shares with their Lagrange
    # coefficients (T = 128), the certificate's 171 signatures (T = 256)
    coin_pts = [bls.g1_decompress(waves[1][i]) for i in range(BLS_THRESHOLD)]
    coin_lams = th.lagrange_at_zero([i + 1 for i in range(BLS_THRESHOLD)])
    cert_pts = [bls.g1_decompress(sig) for _, _, sig in entries]
    msm_inputs = {}
    for name, scalars, pts in (("coin", coin_lams, coin_pts),
                               ("certificate", [1] * len(cert_pts), cert_pts)):
        t = bls_msm._pad(len(pts))
        nib, px, py, pz = (torch.from_numpy(a).to(dev)
                           for a in bls_msm.pack_inputs(scalars, pts, t))
        lm = torch.cat([px, py, pz], dim=-1).t().contiguous()
        tables = bls_msm._point_tables(lm)
        lanes = bls_msm.gather_windows(nib, tables)
        msm_inputs[name] = {"scalars": scalars, "points": pts, "t": t, "nib": nib,
                            "lm": lm, "tables": tables, "lanes": lanes}

    # -- kernel phase: padd381_xx against its plain version -------------------
    # Real curve points in projective form: the first tree level of each MSM
    # (4,096 and 8,192 lanes at n = 256), a doubling on one lane, 128 lanes
    # (the coin's table steps), and WIDE_LANES pairs drawn from the
    # certificate's 4,096 table entries (1/16 of them the identity, 1/16 of
    # the pairs doublings).
    operands = {}
    for name in ("coin", "certificate"):
        lanes = msm_inputs[name]["lanes"]
        half = lanes.shape[1] // 2
        operands[half] = (lanes[:, :half], lanes[:, half:])
    cert_width = max(operands)
    flat = msm_inputs["certificate"]["tables"].permute(1, 0, 2).reshape(G.ROWS, -1)
    prng = np.random.default_rng(SEED)
    idx_p = torch.from_numpy(prng.integers(0, flat.shape[1], WIDE_LANES)).to(dev)
    idx_q = torch.from_numpy(prng.integers(0, flat.shape[1], WIDE_LANES)).to(dev)
    idx_q[::16] = idx_p[::16]
    operands[1] = (flat[:, 5:6], flat[:, 5:6])
    operands[128] = (flat[:, idx_p[:128]], flat[:, idx_q[:128]])
    operands[WIDE_LANES] = (flat[:, idx_p], flat[:, idx_q])
    widths = {}
    for lanes_n in sorted(operands):
        p, q = operands[lanes_n]
        got = G.padd381_xx(p, q)
        want = G.padd381_xx_plain(p, q)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max().item())
        reps = 50 if lanes_n < WIDE_LANES else 20
        ms = cuda_ms(lambda: G.padd381_xx(p, q), reps)
        g_ms = graph_ms(lambda: G.padd381_xx(p, q), reps)
        plain_ms = cuda_ms(lambda: G.padd381_xx_plain(p, q), 3, 1)
        b_ms, b_by = bound(3 * G.ROWS * 4 * lanes_n, imads_per_lane * lanes_n, imad_per_s)
        print(f"kernel padd381_xx: lanes {lanes_n}, equal {err == 0}, {ms:.4f} ms, "
              f"{g_ms:.4f} ms in a CUDA graph (plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms "
              f"by {b_by})")
        if err != 0:
            fail(f"padd381_xx disagrees with its plain version at {lanes_n} lanes "
                 f"(max abs err {err})")
        widths[lanes_n] = {"max_abs_err": err, "ms": ms, "graph_ms": g_ms,
                           "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by}
    row = {"name": "padd381_xx", "route": "cuda", "source": G.SOURCE,
           "replaces": "dag_rider_tpu/ops/pallas_group381.py:150", "launches": None,
           **widths[cert_width], "library_ms": None, "lanes": cert_width,
           "widths": {str(k): v for k, v in widths.items()}}

    # -- kernel phase: horner381 on the coin's and the certificate's window sums
    # One chain is 320 dependent additions on one point, so beside its
    # operation bound stands the chain's latency as 320 single-lane
    # padd381_xx launches take it on the card: the 1-lane device time of
    # one cooperative addition (CUDA graph, no host gaps) x 320.
    hrows = {}
    for name in ("coin", "certificate"):
        m = msm_inputs[name]
        w = G.tree_sum_xyz381(m["lanes"], m["t"])
        m["w"] = w
        raw, canon = G.horner381(w)
        want_raw, want_canon = G.horner381_plain(w)
        torch.cuda.synchronize()
        err = max(int((a.long() - b.long()).abs().max().item())
                  for a, b in ((raw, want_raw), (canon, want_canon)))
        ms = cuda_ms(lambda: G.horner381(w), 20)
        plain_ms = cuda_ms(lambda: G.horner381_plain(w), 1, 1)
        b_ms, b_by = bound(4 * (G.ROWS * G.WINDOWS + G.ROWS + 3 * F.LIMBS),
                           320 * imads_per_lane, imad_per_s)
        chain_ms = 320 * widths[1]["graph_ms"]
        print(f"kernel horner381 ({name} window sums): equal {err == 0}, {ms:.4f} ms "
              f"(plain {plain_ms:.3f} ms, bound {b_ms:.6f} ms by {b_by}; 320 x the 1-lane "
              f"padd381_xx device time {chain_ms:.3f} ms)")
        if err != 0:
            fail(f"horner381 disagrees with its plain version on the {name}'s window sums "
                 f"(max abs err {err})")
        hrows[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                       "bound_by": b_by, "chain_ms": chain_ms}
    hrow = {"name": "horner381", "route": "cuda", "source": G.SOURCE,
            "replaces": "dag_rider_tpu/ops/bls_msm.py:196", "launches": None,
            **hrows["certificate"], "library_ms": None, "lanes": 1,
            "inputs": hrows}

    # -- coin path: n = 256, f + 1 = 86 shares, an honest and a Byzantine wave --
    def coin_wave(wave, want_sizes):
        """One wave through a card coin and a host coin; the card coin's
        MSMs must have the sizes ``want_sizes`` lists, in order, and the
        wave must make exactly the launches those MSMs hold."""
        sizes = []

        def card_msm(scalars, points):
            sizes.append(len(points))
            return bls_msm.msm(scalars, points)

        host = ThresholdCoin(keys, 0, BLS_N, msm="host")
        card = ThresholdCoin(keys, 0, BLS_N, msm=card_msm)
        for coin in (host, card):
            for src, share in waves[wave].items():
                coin.observe_share(wave, src, share)
        torch.cuda.synchronize()
        G.reset_launches()
        t0 = time.perf_counter()
        ready = card.ready(wave)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(G.LAUNCHES)
        t0 = time.perf_counter()
        host_ready = host.ready(wave)
        host_wall = time.perf_counter() - t0
        if not (ready and host_ready):
            fail(f"coin wave {wave} not ready (card {ready}, host {host_ready})")
        if card._sigma[wave] != host._sigma[wave]:
            fail(f"coin wave {wave}: sigma differs from the host coin")
        leader = card.choose_leader(wave)
        if leader != host.choose_leader(wave) or card.filtered != host.filtered:
            fail(f"coin wave {wave}: leader {leader} / filtered {card.filtered} differ "
                 f"from the host coin's {host.choose_leader(wave)} / {host.filtered}")
        want = msm_launches(want_sizes)
        if sizes != want_sizes or launches != want:
            fail(f"coin wave {wave}: MSMs of {sizes} points with launches {launches}, "
                 f"want {want_sizes} with {want}")
        print(f"coin wave {wave} (n {BLS_N}, threshold {BLS_THRESHOLD}): sigma "
              f"{card._sigma[wave].hex()[:16]}... and leader {leader} equal to the host "
              f"coin; filtered {card.filtered}; MSMs of {sizes} points, launches "
              f"{launches}; ready() "
              f"{wall * 1e3:.1f} ms on the card path, {host_wall * 1e3:.1f} ms host")
        return card.filtered, launches

    # an honest wave: one Lagrange MSM over f + 1 shares
    filtered, coin_launches = coin_wave(1, [BLS_THRESHOLD])
    if filtered != 0:
        fail(f"honest coin wave: filtered {filtered}, want 0")
    # one bad share: the first aggregate fails its check, then the filter's
    # RLC MSM over all n shares, its x-weighted MSM that localizes the bad
    # one, the RLC MSM over the other n - 1, and the aggregate of f + 1
    filtered, byz_launches = coin_wave(
        2, [BLS_THRESHOLD, BLS_N, BLS_N, BLS_N - 1, BLS_THRESHOLD])
    if filtered != 1:
        fail(f"Byzantine coin wave: filtered {filtered}, want 1")

    # -- certificate path: n = 256, 2f + 1 = 171 signatures --------------------
    cv = CertVerifier(reg, CERT_QUORUM, msm="device")
    torch.cuda.synchronize()
    G.reset_launches()
    t0 = time.perf_counter()
    cert = cv.make_certificate(7, entries)
    torch.cuda.synchronize()
    make_wall = time.perf_counter() - t0
    cert_launches = dict(G.LAUNCHES)
    host_cert = CertVerifier(reg, CERT_QUORUM, msm="host").make_certificate(7, entries)
    if cert is None or cert.agg_sig != host_cert.agg_sig:
        fail("certificate agg_sig differs from the host group law's")
    if cert_launches != msm_launches([CERT_QUORUM]):
        fail(f"certificate MSM launches {cert_launches}, want {msm_launches([CERT_QUORUM])}")
    if cv.verify_certificate(dataclasses.replace(cert, signers=cert.signers[:-1])):
        fail("a certificate below quorum verified")
    print(f"certificate (n {BLS_N}, quorum {CERT_QUORUM}): agg_sig {cert.agg_sig.hex()[:16]}... "
          f"equal to the host group law; launches {cert_launches}; "
          f"make_certificate {make_wall * 1e3:.1f} ms")
    programs = [pairing_phase(dev, reg, cert_sks, cert, imad_per_s)]
    for r in (row, hrow):
        r["launches"] = sum(d[r["name"]] for d in (coin_launches, byz_launches, cert_launches))
    print(f"bls path launches: coin {coin_launches}, Byzantine coin wave {byz_launches}, "
          f"certificate {cert_launches}")

    # -- MSM wall time and device split -----------------------------------------
    for name, m in msm_inputs.items():
        scalars, pts, t, nib, lm, tables, lanes, w = (
            m[k] for k in ("scalars", "points", "t", "nib", "lm", "tables", "lanes", "w"))
        walls = []
        for _ in range(MSM_REPEATS):
            t0 = time.perf_counter()
            res = bls_msm.msm(scalars, pts)
            walls.append(time.perf_counter() - t0)
        if res != bls.g1_msm(scalars, pts):
            fail(f"{name} MSM differs from the host group law")
        parts = {
            "tables": lambda: bls_msm._point_tables(lm),
            "gather": lambda: bls_msm.gather_windows(nib, tables),
            "tree": lambda: G.tree_sum_xyz381(lanes, t),
            "horner381 incl. canonical": lambda: G.horner381(w),
        }
        split = {k: cuda_ms(fn, 5) for k, fn in parts.items()}
        gsplit = {k: graph_ms(fn, 5) for k, fn in parts.items()}
        print(f"{name} MSM (T = {t}, {len(pts)} points): wall median "
              f"{statistics.median(walls) * 1e3:.2f} ms (runs "
              f"{[round(x * 1e3, 2) for x in walls]} ms); device split (CUDA events, "
              f"launched from the host / in a CUDA graph): "
              + ", ".join(f"{k} {split[k]:.3f} / {gsplit[k]:.3f} ms" for k in parts)
              + f"; sum {sum(split.values()):.3f} / {sum(gsplit.values()):.3f} ms")
    span_launches = spans_phase(dev, reg, cert_sks)
    for r in (row, hrow):
        r["launches"] += span_launches[r["name"]]
    programs.append(signing_phase(dev, cert_sks, imad_per_s))
    return [row, hrow], programs


def windowed_products() -> tuple:
    """(general products, additions, constant products besides the
    additions' 2d) of one row of the windowed verify: decompression (the
    262 of the pow22523 chain and 11 around it, plus the D and SQRT_M1
    constants), 15 table additions, 64 windows of four packed doublings (8
    products each) and one addition for each of [k]A and [s]B, R + [k]A,
    and the projective comparison (4). An addition is 8 general products
    and one by 2d."""
    adds = 15 + 2 * 64 + 1
    return 262 + 11 + 8 * adds + 64 * 4 * 8 + 4, adds, 2


def windowed_phase(reg, rounds, mask, sample, oracle, imad_per_s: float):
    """The windowed oracle path (``CUDAVerifier(comb=False)``) on the verify
    phase's 4,096 rows: with the counters at 0 one merged dispatch, exactly
    80 ``padd_xx`` launches (15 table steps, 64 replayed walk steps, R +
    [k]A) and one ``pow22523``; its mask equal to the comb mask on every
    row and the host oracle on the sample; then the device program alone,
    eager and with the walk replayed from its step graph (equal masks),
    its torch ops and its bound. Returns the launches and the program's
    row."""
    import torch

    from dag_rider_tpu_torch.ops import cuda_group as CG, field as F, windowed
    from dag_rider_tpu_torch.verifier.cuda import CUDAVerifier

    flat = [v for rnd in rounds for v in rnd]
    total = len(flat)
    wv = CUDAVerifier(reg, comb=False)
    dev = wv.device
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = wv.verify_rounds(rounds)  # captures the walk's step graph at this width
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    reset_launch_counters()
    t0 = time.perf_counter()
    masks = wv.verify_rounds(rounds)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    launches = read_launch_counters()
    want = {"padd_xx": 80, "tree_sum_xyzt": 0, "finish_check": 0, "pow22523": 1,
            "field_mul": 0, "padd381_xx": 0, "horner381": 0, **NO_TABLES}
    if launches != want:
        fail(f"windowed dispatch launched {launches}, want {want}")
    wmask = flat_mask(masks)
    if wmask != mask:
        bad = [i for i in range(total) if wmask[i] != mask[i]]
        fail(f"windowed mask differs from the comb mask at rows {bad[:10]}")
    if flat_mask(first) != wmask or [wmask[i] for i in sample] != oracle:
        fail("windowed mask: the first dispatch or the host oracle's sample differs")

    args = [torch.from_numpy(a).to(dev) for a in wv.prepare_batch(flat)]
    one = F.const("ONE", dev).expand_as(args[2])
    point = (args[2], args[3], one, args[4])

    def run(graph):
        return windowed.verify(args[0], args[1], point, *args[5:], graph=graph)

    times, outs = {False: [], True: []}, {}
    for graph in (False, True, True, False):  # in turns
        torch.cuda.synchronize()
        t = time.perf_counter()
        outs[graph] = run(graph)
        torch.cuda.synchronize()
        times[graph].append(time.perf_counter() - t)
    if not torch.equal(outs[False], outs[True]) or outs[True].cpu().tolist() != wmask:
        fail("windowed: the eager and the step-graph programs differ, or differ from the mask")
    with OpCount() as eager_ops:
        run(False)
    with OpCount() as graph_ops:
        run(True)
    acc = torch.zeros((CG.ROWS, 2 * total), dtype=torch.int32, device=dev)
    with OpCount() as step_ops:
        windowed.step(acc, acc)
    kernels, busy_ms = device_kernels(lambda: run(True))
    general, adds, _ = windowed_products()
    nnz = {c: int((getattr(F, c) != 0).sum()) for c in ("D", "D2", "SQRT_M1")}
    imads = total * (general * IMAD_PER_PRODUCT + 22 * (adds * nnz["D2"] + nnz["D"]
                                                        + nnz["SQRT_M1"]))
    in_bytes = sum(a.numel() * a.element_size() for a in args) + total
    b_ms, b_by = bound(in_bytes, imads, imad_per_s)
    eager_s, graph_s = min(times[False]), min(times[True])
    print(f"windowed path (comb=False, {total} sigs): mask equal to the comb mask on every row "
          f"and the host oracle on {len(sample)}; dispatch {t_first * 1e3:.1f} ms first (step "
          f"graph captured), {t_warm * 1e3:.1f} ms warm; launches {launches}")
    print(f"  device program alone: eager {eager_s * 1e3:.1f} ms, walk from its step graph "
          f"{graph_s * 1e3:.1f} ms (runs eager {[round(t * 1e3, 1) for t in times[False]]}, graph "
          f"{[round(t * 1e3, 1) for t in times[True]]} ms); torch ops from the host a dispatch: "
          f"eager {eager_ops.ops}, with the graph {graph_ops.ops} ({step_ops.ops} a step, 64 "
          f"steps replayed); kernels on the card "
          f"{kernels if kernels is not None else 'not measured'}, device time "
          f"{f'{busy_ms:.2f} ms' if busy_ms is not None else 'not measured'}; "
          f"{general + adds + 2} field products a row, bound {b_ms:.4f} ms by {b_by}")
    return launches, {
        "name": "windowed.verify (CUDAVerifier(comb=False))", "replaces":
        "dag_rider_tpu/ops/curve.py:249 verify_core (jnp, no pallas_call)", "rows": total,
        "eager_ms": eager_s * 1e3, "graph_ms": graph_s * 1e3, "torch_ops_eager": eager_ops.ops,
        "torch_ops_graph": graph_ops.ops, "kernels": kernels, "device_ms": busy_ms,
        "launches": launches, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def round_step_phase(reg, rounds, mask, imad_per_s: float) -> list:
    """``make_round_step(mesh_from_env(), quorum=171)`` on round 4's 256
    signed vertices and wave 1 of the verify phase's DAG (rounds 1-4, each
    vertex's 171 strong edges), for three leaders: the accept mask equal to
    the comb (and windowed) mask of round 4, the votes and commit equal to
    the numpy twins ``reach_chain_np``/``leader_reach_np``, the launches
    exact; then ``wave_commit_votes`` alone on the card at n = 256 and
    1,024, timed beside its bound. Returns the two vote rows."""
    import numpy as np
    import torch

    from dag_rider_tpu_torch.ops import dag_kernels
    from dag_rider_tpu_torch.parallel.mesh import mesh_from_env
    from dag_rider_tpu_torch.parallel.round_step import make_round_step
    from dag_rider_tpu_torch.verifier.cuda import CUDAVerifier

    n, quorum = N_KEYS, STRONG_EDGES
    mesh = mesh_from_env()
    step = make_round_step(mesh, quorum=quorum)
    strong = np.zeros((5, n, n), dtype=bool)
    for r in range(1, 5):
        for i, v in enumerate(rounds[r - 1]):
            for e in v.strong_edges:
                strong[r, i, e.source] = True
    strong_wave = np.ascontiguousarray(strong[[4, 3, 2]])
    args = CUDAVerifier(reg, comb=False).prepare_batch(rounds[3])
    want = mask[3 * n : 4 * n]
    exists_r4 = np.array(want, dtype=bool)
    reach = dag_kernels.reach_chain_np(strong_wave)
    step(*args, strong_wave, exists_r4, 0)  # the walk's step graph at this width
    reset_launch_counters()
    leaders, walls = (0, n // 2 + 1, n - 1), []
    for leader in leaders:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        accept, commit, votes = step(*args, strong_wave, exists_r4, leader)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        host = reach[:, leader] & exists_r4
        if accept[:n].cpu().tolist() != want:
            fail(f"round step (leader {leader}): accept mask differs from round 4's mask")
        if not (votes.cpu().numpy() == host).all() or bool(commit) != (host.sum() >= quorum):
            fail(f"round step (leader {leader}): votes or commit differ from reach_chain_np")
        if not (dag_kernels.leader_reach_np(strong_wave, leader) == reach[leader]).all():
            fail(f"round step: leader_reach_np({leader}) differs from reach_chain_np's row")
    launches = read_launch_counters()
    k = mesh.size
    expect = {"padd_xx": 80 * k * len(leaders), "tree_sum_xyzt": 0, "finish_check": 0,
              "pow22523": k * len(leaders), "field_mul": 0, "padd381_xx": 0, "horner381": 0,
              **NO_TABLES}
    if launches != expect:
        fail(f"round step launches {launches}, want {expect}")
    print(f"round step ({mesh!r}, quorum {quorum}, round 4's {n} vertices, wave 1 of the verify "
          f"DAG, leaders {leaders}): accept equal to the mask, votes and commit equal to the "
          f"numpy twins (commit {bool(commit)}, {int(votes.sum())} votes); wall "
          f"{[round(w * 1e3, 1) for w in walls]} ms; launches {launches}")
    rows = []
    vrng = np.random.default_rng(SEED + 6)
    for size in (n, N1024):
        if size == n:
            wave, exists = strong_wave, exists_r4
        else:
            wave = vrng.random((3, size, size)) < 2 / 3
            exists = np.ones(size, dtype=bool)
        wave_d = torch.from_numpy(wave).cuda()
        exists_d = torch.from_numpy(exists).cuda()
        q = 2 * (size // 3) + 1
        commit, votes = dag_kernels.wave_commit_votes(wave_d, exists_d, 5, quorum=q)
        host = dag_kernels.reach_chain_np(wave)[:, 5] & exists
        if not (votes.cpu().numpy() == host).all():
            fail(f"wave_commit_votes at n = {size} differs from reach_chain_np")

        def votes_fn():
            return dag_kernels.wave_commit_votes(wave_d, exists_d, 5, quorum=q)

        ms = cuda_ms(votes_fn, 20)
        g_ms = graph_ms(votes_fn, 20)
        # two float32 n x n x n products (2 n^3 operations each) over the
        # card's float32 rate outside the tensor cores (67 TFLOP/s)
        b_ms, b_by = bound(3 * size * size + 2 * size, 0, imad_per_s)
        t_ops = 4 * size**3 / 67e12 * 1e3
        if t_ops > b_ms:
            b_ms, b_by = t_ops, "operations"
        print(f"  wave_commit_votes at n = {size}: {ms:.4f} ms, {g_ms:.4f} ms in a CUDA graph "
              f"(bound {b_ms:.4f} ms by {b_by}); votes equal to reach_chain_np")
        rows.append({"name": f"dag_kernels.wave_commit_votes n={size}", "replaces":
                     "dag_rider_tpu/ops/dag_kernels.py:135 (jnp matmuls, no pallas_call)",
                     "ms": ms, "graph_ms": g_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": None})
    return rows


def sharded_verify_phase(ver, rounds, mask) -> None:
    """The sharded verifier at n = 256 through ``VerifierPipeline(depth=2,
    warmup=True)`` with one round a dispatch, as ``bench.py:3430-3470``
    drives it, on one card (a fresh ``CUDAVerifier``), on
    ``mesh_from_env()`` and on ``virtual_mesh(4)``, all three with the
    default prep engine and the same tables: masks equal to the merged comb
    dispatch's, launches exactly k per chunk, sigs/s (the three timed in
    turns), the shard gauges and the tables' bytes per distinct device;
    then one merged dispatch on ``virtual_mesh(5)`` (an uneven split)."""
    import torch

    from dag_rider_tpu_torch.parallel.mesh import mesh_from_env, virtual_mesh
    from dag_rider_tpu_torch.parallel.sharded_verifier import ShardedCUDAVerifier
    from dag_rider_tpu_torch.verifier.cuda import CUDAVerifier
    from dag_rider_tpu_torch.verifier.pipeline import VerifierPipeline

    total = sum(len(r) for r in rounds)
    chunks = -(-total // N_KEYS)
    tables = ver.comb_tables()
    verifiers = {"one card (CUDAVerifier)": CUDAVerifier(ver.registry)}
    for name, mesh in (("mesh_from_env()", mesh_from_env()), ("virtual_mesh(4)", virtual_mesh(4))):
        verifiers[f"{name} = {mesh!r}"] = ShardedCUDAVerifier(ver.registry, mesh)
    try:
        pipes, walls = {}, {}
        for name, v in verifiers.items():
            v._tables = tables  # the same registry's tables, not a second build
            v.fixed_bucket = N_KEYS
            pipes[name] = pipe = VerifierPipeline(v, depth=2, warmup=True)
            k = getattr(v, "mesh_devices", 1)
            reset_launch_counters()
            got = pipe.verify_rounds(rounds)
            launches = read_launch_counters()
            want = {"padd_xx": 0, "tree_sum_xyzt": chunks * k, "finish_check": chunks * k,
                    "pow22523": 0, "field_mul": 0, "padd381_xx": 0, "horner381": 0,
                    **NO_TABLES}
            if flat_mask(got) != mask:
                fail(f"sharded verify on {name}: masks differ from the merged dispatch's")
            if launches != want:
                fail(f"sharded verify on {name}: launches {launches}, want {want}")
            walls[name] = []
        for _ in range(3):  # the three in turns
            for name, pipe in pipes.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pipe.verify_rounds(rounds)
                torch.cuda.synchronize()
                walls[name].append(time.perf_counter() - t0)
        for name, v in verifiers.items():
            k = getattr(v, "mesh_devices", 1)
            extra = (f"; last_shard_batch {v.last_shard_batch}, last_shard_imbalance "
                     f"{v.last_shard_imbalance:.3f}, tables {v.table_bytes()} B"
                     if hasattr(v, "mesh") else "")
            print(f"sharded verify, {name} ({total} sigs, {chunks} chunks of {N_KEYS}, depth 2): masks "
                  f"equal; {total / statistics.median(walls[name]):.0f} sigs/s median (runs "
                  f"{[round(w * 1e3, 1) for w in walls[name]]} ms, in turns); launches exactly "
                  f"{chunks * k} tree_sum_xyzt and finish_check{extra}")
    finally:
        for v in verifiers.values():
            v.fixed_bucket = None
    sv5 = ShardedCUDAVerifier(ver.registry, virtual_mesh(5))
    sv5._tables = tables
    reset_launch_counters()
    got = sv5.verify_rounds(rounds)
    launches = read_launch_counters()
    if flat_mask(got) != mask or (launches["tree_sum_xyzt"], launches["finish_check"]) != (5, 5):
        fail(f"sharded verify on virtual_mesh(5): masks differ or launches {launches}")
    print(f"sharded verify, virtual_mesh(5), one merged dispatch: masks equal; padded size "
          f"{sv5._size_for(total)}, last_shard_batch {sv5.last_shard_batch}, "
          f"last_shard_imbalance {sv5.last_shard_imbalance:.4f}; launches {launches}")


def _sign_rows_worker(args):
    """Signatures of rows [lo, hi) of round ``r`` of the n-vertex committee
    (bench.py's ``_signed_round``: 2f + 1 strong edges, the block
    ``r{r}-tx-{i}`` twice), in a spawn worker that imports no JAX."""
    seeds, n, quorum, r, lo, hi = args
    from dag_rider_tpu_torch.verifier.base import VertexSigner

    return [VertexSigner(seeds[i]).sign_vertex(committee_vertex(n, quorum, r, i)).signature
            for i in range(lo, hi)]


def committee_vertex(n: int, quorum: int, r: int, i: int, signature=None):
    from dag_rider_tpu_torch.core.types import Block, Vertex, VertexID

    return Vertex(id=VertexID(r, i), block=Block((f"r{r}-tx-{i}".encode() * 2,)),
                  strong_edges=tuple(VertexID(r - 1, s) for s in range(min(n, quorum))),
                  signature=signature)


def signed_rounds(seeds, n: int, rounds: int):
    """``bench.py:163`` ``_build_batches(n, rounds)``'s signed rounds,
    signed in spawn workers (at most 8) over row slices."""
    import concurrent.futures as cf
    import multiprocessing as mp

    quorum = 2 * ((n - 1) // 3) + 1
    workers = min(8, os.cpu_count() or 1)
    step = -(-n // workers)
    jobs = [(seeds, n, quorum, r, lo, min(lo + step, n))
            for r in range(1, rounds + 1) for lo in range(0, n, step)]
    with cf.ProcessPoolExecutor(max_workers=workers, mp_context=mp.get_context("spawn")) as ex:
        parts = list(ex.map(_sign_rows_worker, jobs))
    out = []
    for r in range(1, rounds + 1):
        sigs = [sig for (_, _, _, rr, _, _), part in zip(jobs, parts) if rr == r for sig in part]
        rnd = [committee_vertex(n, quorum, r, i, sig) for i, sig in enumerate(sigs)]
        for v in rnd:
            v.digest()  # fills the signing-bytes memo, as bench.py's rounds arrive
        out.append(rnd)
    return out


def sharded_msm_adds(points: int, k: int) -> int:
    """padd381_xx launches of one ShardedMSM over ``points`` on k entries:
    15 table steps and log2(T/k) tree levels per entry, one per fold
    level (odd counts carry)."""
    from dag_rider_tpu_torch.parallel.msm import padded_size

    per = padded_size(points, k) // k
    levels, d = 0, k
    while d > 1:
        d, levels = d // 2 + d % 2, levels + 1
    return k * (15 + per.bit_length() - 1) + levels


def n1024_phase(imad_per_s: float, builds: list):
    """BASELINE config #5 at n = 1,024 ("1024-node full-wave MSM"): the
    comb table build (``table_build_gate``, its record appended to
    ``builds``), 4
    rounds of 1,024 vertices with 683 strong edges (``bench.py:163``), 64
    corrupted, verified by ``ShardedCUDAVerifier`` on ``mesh_from_env()``
    in one merged dispatch; the T = 1,024 MSM of ``bench.py:3734-3744``
    through ``ShardedMSM()``; 683 certificate signatures summed by
    ``CertVerifier(msm="sharded")``. The counters are 0 just before those
    three calls and read just after, and must be exact. The masks equal
    ``CUDAVerifier``'s and a host oracle sample, the MSM ``bls_msm.msm`` on
    the card, the host group law and ``ShardedMSM`` on ``virtual_mesh(4)``,
    the aggregate the host group law's. Returns the launches and the MSM's
    program row."""
    import hashlib
    import random

    import numpy as np
    import torch

    from dag_rider_tpu_torch.crypto import bls12381 as bls
    from dag_rider_tpu_torch.ops import bls_msm, cuda_group381 as G, field381 as F381
    from dag_rider_tpu_torch.parallel.mesh import mesh_from_env, split_rows, virtual_mesh
    from dag_rider_tpu_torch.parallel.msm import ShardedMSM, padded_size
    from dag_rider_tpu_torch.parallel.sharded_verifier import ShardedCUDAVerifier
    from dag_rider_tpu_torch.verifier.base import KeyRegistry
    from dag_rider_tpu_torch.verifier.cert import CertVerifier
    from dag_rider_tpu_torch.verifier.cpu import CPUVerifier
    from dag_rider_tpu_torch.verifier.cuda import CUDAVerifier

    n = N1024
    quorum = 2 * ((n - 1) // 3) + 1  # 683
    t0 = time.perf_counter()
    reg, seeds = KeyRegistry.generate(n)
    t_keys = time.perf_counter() - t0
    t0 = time.perf_counter()
    rounds = signed_rounds(seeds, n, N1024_ROUNDS)
    t_sign = time.perf_counter() - t0
    corrupted = corrupt_rounds(rounds, n, np.random.default_rng(SEED + 5))
    flat = [v for rnd in rounds for v in rnd]
    total = len(flat)
    mesh = mesh_from_env()
    print(f"config #5 (n {n}): mesh_from_env() = {mesh!r}; keys {t_keys:.2f} s, signing {total} "
          f"vertices ({quorum} strong edges) in {min(8, os.cpu_count() or 1)} workers "
          f"{t_sign:.2f} s, {len(corrupted)} corrupted")
    sv = ShardedCUDAVerifier(reg, mesh)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    _, rec = table_build_gate("config #5, n = 1,024", sv, imad_per_s)
    builds.append(rec)
    t0 = time.perf_counter()
    sv._comb_tables_dev()  # the built tables, one copy a distinct device
    torch.cuda.synchronize()
    t_tables = rec["wall_ms"] / 1e3 + time.perf_counter() - t0
    print(f"  comb tables: built in {t_tables:.4f} s, {sv.table_bytes()} B per distinct device, "
          f"device memory +{torch.cuda.memory_allocated() - mem0} B")
    t_warm = sv.warmup(total)
    # the MSM's inputs (bench.py:3734-3744) and the certificate's shares
    mrng = random.Random(3)
    acc = bls.g1_mul(mrng.randrange(1, bls.R))
    pts = []
    for _ in range(MSM_T):  # cheap distinct points: repeated doubling
        pts.append(acc)
        acc = bls.g1_double(acc)
    ks = [mrng.randrange(0, bls.R) for _ in range(MSM_T)]
    cert_sks = [int.from_bytes(hashlib.sha256(b"n1024|bls|%d" % i).digest(), "big") % bls.R
                for i in range(quorum)]
    digests = [hashlib.sha512(b"round-9|" + i.to_bytes(4, "little")).digest()
               for i in range(quorum)]
    sigs = bls.sign_many(cert_sks, digests, backend="native")
    # a CertVerifier needs a registry with BLS keys; aggregation reads none
    creg = KeyRegistry.generate_with_cert(4)[0]
    cert_sharded = CertVerifier(creg, quorum, msm="sharded")
    sm = ShardedMSM()

    # -- the main path: counters at 0, the merged verify, the MSM, the aggregate
    reset_launch_counters()
    t0 = time.perf_counter()
    masks = sv.verify_rounds(rounds)
    torch.cuda.synchronize()
    t_verify = time.perf_counter() - t0
    t0 = time.perf_counter()
    msm_out = sm(ks, pts)
    t_msm = time.perf_counter() - t0
    agg = cert_sharded.aggregate(sigs)
    launches = read_launch_counters()
    k = mesh.size
    want = {"padd_xx": 0, "tree_sum_xyzt": k, "finish_check": k, "pow22523": 0, "field_mul": 0,
            "padd381_xx": sharded_msm_adds(MSM_T, sm.n_shards)
            + sharded_msm_adds(quorum, cert_sharded._sharded.n_shards),
            "horner381": 2, **NO_TABLES}
    if launches != want:
        fail(f"config #5: launches {launches}, want {want}")

    mask = flat_mask(masks)
    single = CUDAVerifier(reg)
    single._tables = sv.comb_tables()  # the same registry's tables
    if flat_mask(single.verify_rounds(rounds)) != mask:
        fail("config #5: the sharded masks differ from CUDAVerifier's")
    rng = np.random.default_rng(SEED + 7)
    sample = sorted(corrupted) + sorted(int(i) for i in rng.choice(
        sorted(set(range(total)) - corrupted), N_VALID_SAMPLE, replace=False))
    if [mask[i] for i in sample] != CPUVerifier(reg).verify_batch([flat[i] for i in sample]):
        fail("config #5: the sharded mask differs from the host oracle's sample")
    if not all(mask[i] for i in range(total) if i not in corrupted):
        fail("config #5: a valid signature outside the corrupted set was rejected")
    walls, preps, devs = [], [], []
    for _ in range(PATH_REPEATS):
        p0, d0 = span_s(sv, PREP), span_s(sv, *ENQUEUE_TO_MASK)
        t0 = time.perf_counter()
        if flat_mask(sv.verify_rounds(rounds)) != mask:
            fail("config #5: a repeated dispatch returned another mask")
        walls.append(time.perf_counter() - t0)
        preps.append(span_s(sv, PREP) - p0)
        devs.append(span_s(sv, *ENQUEUE_TO_MASK) - d0)
    wall = statistics.median(walls)
    print(f"  verify: {sum(mask)} accepted of {total}; masks equal to CUDAVerifier's and the host "
          f"oracle on {len(sample)} rows; warmup {t_warm:.2f} s, first merged dispatch "
          f"{t_verify * 1e3:.1f} ms; warm (median of {PATH_REPEATS}) {wall * 1e3:.1f} ms = host "
          f"prep {statistics.median(preps) * 1e3:.1f} ms + device "
          f"{statistics.median(devs) * 1e3:.1f} ms; {total / wall:.0f} sigs/s; "
          f"last_shard_batch {sv.last_shard_batch}")

    host_msm = bls.g1_msm(ks, pts)
    if msm_out != host_msm or bls_msm.msm(ks, pts) != host_msm:
        fail("config #5: the T = 1024 MSM differs from the host group law or bls_msm.msm")
    sm4 = ShardedMSM(virtual_mesh(4))
    if sm4(ks, pts) != host_msm:
        fail("config #5: ShardedMSM on virtual_mesh(4) differs from the host group law")
    host_agg = CertVerifier(creg, quorum, msm="host", pair="host").aggregate(sigs)
    if agg is None or agg != host_agg:
        fail("config #5: the sharded certificate aggregate differs from msm='host'")
    msm_walls = {}
    for name, fn in (("ShardedMSM()", lambda: sm(ks, pts)),
                     ("virtual_mesh(4)", lambda: sm4(ks, pts)),
                     ("bls_msm.msm", lambda: bls_msm.msm(ks, pts))):
        w = []
        for _ in range(MSM_REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            w.append(time.perf_counter() - t0)
        msm_walls[name] = statistics.median(w)
    # the device split on virtual_mesh(4): one entry's window sums (T/4
    # points), the fold of the 4 partials, the Horner chain
    t = padded_size(MSM_T, sm4.n_shards)
    nib, px, py, pz = (torch.from_numpy(split_rows(a, sm4.n_shards)[0]).cuda()
                       for a in bls_msm.pack_inputs(ks, pts, t))
    lm = torch.cat([px, py, pz], dim=-1).t().contiguous()
    partials = sm4.window_partials(ks, pts)
    folded = bls_msm.tree_reduce(partials)[0].contiguous()
    parts = {"window sums of one of 4 entries": lambda: bls_msm.window_sums(nib, lm),
             "fold of 4 partials": lambda: bls_msm.tree_reduce(partials),
             "horner381 incl. canonical": lambda: G.horner381(folded)}
    split = {name: cuda_ms(fn, 5) for name, fn in parts.items()}
    gsplit = {name: graph_ms(fn, 5) for name, fn in parts.items()}
    imads_per_add = 12 * (F381.LIMBS * F381.LIMBS + int((F381.FOLD != 0).sum())) + 2 * F381.LIMBS
    adds = 15 * t + 64 * (t - 1) + 320
    b_ms, b_by = bound(4 * (t * (64 + 3 * F381.LIMBS) + 3 * F381.LIMBS), adds * imads_per_add,
                       imad_per_s)
    print(f"  MSM (T = {MSM_T}, {sm.n_shards} entries): equal to bls_msm.msm, the host group law "
          f"and virtual_mesh(4); wall median {msm_walls['ShardedMSM()'] * 1e3:.2f} ms (first "
          f"{t_msm * 1e3:.2f} ms), virtual_mesh(4) {msm_walls['virtual_mesh(4)'] * 1e3:.2f} ms, "
          f"bls_msm.msm {msm_walls['bls_msm.msm'] * 1e3:.2f} ms; device split on virtual_mesh(4) "
          f"(CUDA events / CUDA graph): "
          + ", ".join(f"{k2} {split[k2]:.3f} / {gsplit[k2]:.3f} ms" for k2 in parts)
          + f"; {adds} additions, bound {b_ms:.4f} ms by {b_by}")
    print(f"  certificate aggregation ({quorum} signatures, CertVerifier(msm='sharded')): bytes "
          f"equal to msm='host'; config #5 launches {launches}")
    return launches, {
        "name": "parallel.msm.ShardedMSM T=1024", "replaces":
        "dag_rider_tpu/parallel/msm.py:66 (shard_map of bls_msm, no new pallas_call)",
        "entries": sm.n_shards, "wall_ms": msm_walls["ShardedMSM()"] * 1e3,
        "virtual4_wall_ms": msm_walls["virtual_mesh(4)"] * 1e3,
        "single_msm_wall_ms": msm_walls["bls_msm.msm"] * 1e3, "split_ms": split,
        "split_graph_ms": gsplit, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def sharded_consensus_phase(ref) -> dict:
    """Phase 8's cluster (n = 256, threshold coin, ``propose_empty``) with
    ``Simulation(verifier="sharded")`` — a shared ``ShardedCUDAVerifier``
    over ``mesh_from_env()`` — and the same number of ``run`` calls as the
    ``"device"`` run in ``ref``: logs, leaders, decided waves and messages
    byte-identical to it, nothing contained, launches exactly k per
    pipeline dispatch and the coin MSMs'. Returns its launches."""
    from dag_rider_tpu_torch import Config

    n = CONS_N
    cfg = Config(n=n, coin="threshold_bls", propose_empty=True, gc_depth=24)
    msm_sizes = []
    sim, oracle, msgs, calls, wall, spent, _ = drive_cluster(
        cfg, ref["keys"], ref["signers"], msm_recorder(msm_sizes, []), named="sharded",
        calls=ref["calls"])
    launches = read_launch_counters()
    shared = sim.processes[0].verifier
    pipe = sim._verify_pipe
    k = shared.mesh_devices
    rs = pipe.resilience_stats()
    contained = {c: rs[c] for c in ("poisoned_windows", "quarantined", "quarantine_rejected")}
    if any(contained.values()):
        fail(f"sharded consensus: the pipeline contained faults {contained}")
    want = want_launches(pipe.dispatches * k, msm_sizes)
    if pipe.dispatches <= 0 or launches != want:
        fail(f"sharded consensus: launches {launches}, want {want}")
    logs = [[(v.id.round, v.id.source, v.digest()) for v in d] for d in sim.deliveries]
    if logs != ref["logs"]:
        bad = [i for i, (a, b) in enumerate(zip(logs, ref["logs"])) if a != b]
        fail(f"sharded consensus: logs differ from the device run's at views {bad[:10]}")
    if oracle._sigma != ref["sigma"] or msgs != ref["msgs"] or (
            [p.decided_wave for p in sim.processes] != ref["decided"]):
        fail("sharded consensus: leaders, messages or decided waves differ from the device run")
    applied = sum(p.metrics.verify_sigs_total for p in sim.processes)
    st = pipe.stats()
    print(f"consensus with verifier='sharded' ({shared.mesh!r}): {calls} runs, logs of all {n} "
          f"views, {len(oracle._sigma)} leaders and decided waves byte-identical to the device "
          f"run; wall {wall:.2f} s (device run {ref['wall']:.2f} s); {applied / wall:.0f} applied "
          f"sigs/s; {pipe.dispatches} dispatches, mesh_devices {st['mesh_devices']}, shard_batch "
          f"{st['shard_batch']}, shard_imbalance {st['shard_imbalance']}; launches {launches}; "
          f"host split: {split_line(spent)}")
    return launches


# -- phases A-F: the mempool front door, lanes, Byzantine suite, snapshots, DKG


def msm_recorder(sizes: list, walls: list):
    """A coin ``msm`` that runs ``bls_msm.msm`` on the card and records each
    MSM's point count and wall."""
    from dag_rider_tpu_torch.ops import bls_msm

    def card_msm(scalars, points):
        sizes.append(len(points))
        t = time.perf_counter()
        out = bls_msm.msm(scalars, points)
        walls.append(time.perf_counter() - t)
        return out

    return card_msm


@contextlib.contextmanager
def recorded_msms(sizes: list):
    """Route ``bls_msm.msm`` through a recorder of each MSM's point count
    for a block: coins built inside it (``msm="device"``) resolve the
    recorder, which calls the card's MSM."""
    from dag_rider_tpu_torch.ops import bls_msm

    orig = bls_msm.msm

    def msm(scalars, points, **kw):
        sizes.append(len(points))
        return orig(scalars, points, **kw)

    try:
        bls_msm.msm = msm
        yield
    finally:
        bls_msm.msm = orig


def profiled(fn):
    """``(fn(), kernels, device ms)``: ``fn`` run under the CUDA profiler;
    kernels and ms are None when the profiler records no device activity
    (``fn`` then runs all the same)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    try:
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
    except Exception as exc:  # a machine may refuse CUPTI tracing; then not measured
        print(f"  profiler: no device trace ({type(exc).__name__}: {exc})")
        return fn(), None, None
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        prof.__exit__(None, None, None)
    try:
        evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    except Exception as exc:  # the trace could not be read back; then not measured
        print(f"  profiler: no device trace ({type(exc).__name__}: {exc})")
        evs = []
    if not evs:
        return out, None, None
    return out, len(evs), sum(e.device_time_total for e in evs) / 1e3


def want_launches(dispatches: int, msm_sizes) -> dict:
    """The launches of ``dispatches`` comb verify dispatches and MSMs over
    ``msm_sizes`` points: one ``tree_sum_xyzt`` and one ``finish_check`` a
    dispatch, the MSMs' ``padd381_xx``/``horner381``, nothing else."""
    return {"tree_sum_xyzt": dispatches, "finish_check": dispatches, "padd_xx": 0,
            "pow22523": 0, "field_mul": 0, **NO_TABLES, **msm_launches(msm_sizes)}


def check_contained(pipe, what: str) -> None:
    rs = pipe.resilience_stats()
    contained = {k: rs[k] for k in ("poisoned_windows", "quarantined", "quarantine_rejected")}
    if any(contained.values()):
        fail(f"{what}: the verify pipeline contained faults {contained}")


def add_launches(total: dict, launches: dict) -> None:
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def ingest_cluster(keys, signers, card_ver, spent, msm_sizes, msm_walls):
    """Phase A's cluster and load: the port's ``Simulation`` at ``INGEST_N``
    with the shared ``CUDAVerifier`` and card-MSM threshold coins over one
    oracle's books, fronted by one ``Mempool`` a process, and the
    ``mempool_e2e`` load driven on the wall clock. The mempools' admission
    and batching time lands in ``spent``."""
    from dag_rider_tpu_torch import Config
    from dag_rider_tpu_torch.config import MempoolConfig
    from dag_rider_tpu_torch.mempool.loadgen import ClusterLoadDriver, LoadGenerator

    cfg = Config(n=INGEST_N, coin="threshold_bls", propose_empty=True, gc_depth=24)
    sim, oracle = timed_cluster(cfg, keys, signers, msm_recorder(msm_sizes, msm_walls), spent,
                                verifier_factory=lambda i: card_ver)
    gen = LoadGenerator(clients=32, rate=4000.0, tx_bytes=32, seed=10, profile="poisson")
    drv = ClusterLoadDriver(sim, gen, mcfg=MempoolConfig(cap=65536, batch_bytes=4096), wall=True)
    for mp in drv.mempools:
        mp.submit = timed(mp.submit, spent, "admission and batching")
        mp.build_blocks = timed(mp.build_blocks, spent, "admission and batching")
    monitor = sim.attach_invariant_monitor()
    return sim, oracle, drv, monitor


def ingest_phase() -> dict:
    """Phase A: client transactions into DAG-Rider at n = 256 through the
    mempool front door (``bench.py``'s ``mempool_e2e`` rung: 32 clients,
    4,000 tx/s Poisson, 32-byte transactions, ``cap`` 65,536,
    ``batch_bytes`` 4,096, 20 s of load and a drain of at most 30 s, on the
    wall clock), with the shared ``CUDAVerifier`` and card-MSM threshold
    coins in place of the rung's null verifier. Fails unless the views
    agree, no accepted transaction is lost or delivered twice, something
    committed, the launches are exactly those of the dispatches and MSMs
    that ran, and nothing was contained. Prints committed tx/s,
    submit→deliver p50/p99, batch fill, the host split and the card's busy
    share (CUDA profiler); then a shorter traced run (``DAGRIDER_TRACE=1``)
    whose ``obs.report`` attribution and Perfetto trace it prints and
    writes under ``build/``. Returns the main run's launches."""
    import torch

    from dag_rider_tpu_torch.crypto import threshold as th
    from dag_rider_tpu_torch.obs import export, report as obs_report
    from dag_rider_tpu_torch.verifier.base import KeyRegistry, VertexSigner
    from dag_rider_tpu_torch.verifier.cuda import CUDAVerifier

    n = INGEST_N
    t_phase = time.perf_counter()
    keys = th.ThresholdKeys.generate(n, n // 3 + 1)
    reg, seeds = KeyRegistry.generate(n)
    signers = [VertexSigner(s) for s in seeds]
    card_ver = CUDAVerifier(reg)
    card_ver.comb_tables()  # the tables, before the counters go to 0
    torch.cuda.synchronize()
    keys_spent = ["admission and batching", "vertex signing", "coin share signing",
                  "coin combine + pairing check"]
    spent = dict.fromkeys(keys_spent, 0.0)
    msm_sizes, msm_walls = [], []
    sim, oracle, drv, monitor = ingest_cluster(keys, signers, card_ver, spent, msm_sizes,
                                               msm_walls)
    load_s, drain_s = INGEST_LOAD_S, INGEST_DRAIN_S
    print(f"ingest set-up (n {n}): keys, device tables and {n} mempools "
          f"{time.perf_counter() - t_phase:.2f} s")
    disp0 = card_ver.total_dispatches
    reset_launch_counters()
    t = time.perf_counter()
    rep, kernels, device_ms = profiled(lambda: drv.run(load_s, drain_s=drain_s))
    wall = time.perf_counter() - t
    launches = read_launch_counters()
    dispatches = card_ver.total_dispatches - disp0
    sim.check_agreement()
    if monitor.observed == 0:
        fail("ingest: the invariant monitor observed no delivery")
    audit = rep["audit"]
    if audit["lost"] or audit["duplicates"]:
        fail(f"ingest: audit {audit}; want no lost and no duplicate transaction")
    if rep["committed_tx"] <= 0:
        fail(f"ingest: nothing committed: {rep}")
    pipe = sim._verify_pipe
    check_contained(pipe, "ingest")
    want = want_launches(dispatches, msm_sizes)
    if dispatches <= 0 or not msm_sizes or launches != want:
        fail(f"ingest: launches {launches}, want {want} ({dispatches} dispatches, MSMs of "
             f"{msm_sizes} points)")
    spent["verify seam"] = sum(p.metrics.verify_seconds_total for p in sim.processes)
    spent["the rest (pump, proposals, ordering)"] = wall - sum(spent.values())
    rounds = [p.round for p in sim.processes]
    busy = "not measured" if device_ms is None else (
        f"{device_ms:.1f} ms in {kernels} kernels, {device_ms / 1e3 / wall:.4%} of the wall")
    print(f"ingest (card; n {n}, {load_s:.0f} s of load, drain <= {drain_s:.0f} s, wall clock): "
          f"{drv.cycles} load cycles, rounds {min(rounds)}-{max(rounds)}, waves decided "
          f"{min(p.decided_wave for p in sim.processes)}, wall {wall:.2f} s")
    print(f"  transactions: {rep['offered_tx']} offered, {rep['accepted_tx']} accepted, "
          f"{rep['shed_tx']} shed, {rep['committed_tx']} committed = "
          f"{rep['committed_tx_per_sec']} committed tx/s of the load window; submit->deliver "
          f"p50 {rep.get('submit_deliver_p50_ms')} ms, p99 {rep.get('submit_deliver_p99_ms')} "
          f"ms; {rep['blocks_built']} blocks, batch fill {rep['batch_fill']}; audit {audit}")
    print(f"  verify: {pipe.sigs_dispatched} signatures in {dispatches} dispatches "
          f"({pipe.dispatches} through the pipeline), seam "
          f"{pipe.seam_s:.3f} s; coin: {len(msm_sizes)} MSMs of {sorted(set(msm_sizes))} points, "
          f"{sum(msm_walls) * 1e3:.1f} ms; launches {launches}")
    print(f"  host split: {split_line(spent)}; the card's busy time (CUDA profiler): {busy}")

    # -- the traced run: obs.report's attribution and the Perfetto trace --------
    trace_spent = dict.fromkeys(keys_spent, 0.0)
    with env(DAGRIDER_TRACE="1", DAGRIDER_TRACE_SAMPLE=str(INGEST_TRACE_SAMPLE),
             DAGRIDER_TRACE_RING=str(INGEST_TRACE_RING), DAGRIDER_FLIGHT_DIR=""):
        tsim, _, tdrv, _ = ingest_cluster(keys, signers, card_ver, trace_spent, [], [])
    if tsim.recorder is None:
        fail("ingest: DAGRIDER_TRACE=1 did not wire the trace recorder")
    t = time.perf_counter()
    trep = tdrv.run(INGEST_TRACE_S, drain_s=INGEST_TRACE_DRAIN_S)
    twall = time.perf_counter() - t
    tsim.check_agreement()
    if trep["audit"]["lost"] or trep["audit"]["duplicates"]:
        fail(f"ingest (traced): audit {trep['audit']}")
    events = tsim.recorder.events()
    attribution = obs_report.decompose(events)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    trace_path = os.path.join(ROOT, "build", "ingest_trace.json")
    export.write_chrome_trace(events, trace_path)
    with open(trace_path) as fh:
        n_trace = len(json.load(fh)["traceEvents"])
    if not events or n_trace != len(events):
        fail(f"ingest (traced): {len(events)} events recorded, {n_trace} in the Perfetto trace")
    print(f"ingest traced ({INGEST_TRACE_S:.0f} s of load, drain <= {INGEST_TRACE_DRAIN_S:.0f} s, "
          f"sample {INGEST_TRACE_SAMPLE}): wall "
          f"{twall:.2f} s, {trep['committed_tx']} committed, {len(events)} events "
          f"({tsim.recorder.dropped} dropped), "
          f"Perfetto trace {n_trace} events -> build/ingest_trace.json")
    print("  " + obs_report.format_report(attribution).replace("\n", "\n  "))
    print(f"ingest phase wall (set-up, both runs, checks): {time.perf_counter() - t_phase:.2f} s")
    return launches


def chaos_run(device: bool):
    """One side of phase B: ``bench.py``'s ``mempool_chaos`` rung at n = 64
    (delay and duplicate faults, 128 clients bursting at 40,000 tx/s into
    a 512-transaction pool, 1 s on the virtual clock, ``dt`` 0.02) with
    threshold coins over one oracle's books, the sync cooldowns pinned to
    0 and the drain run without a wall budget; ``device`` takes the named
    ``"device"`` verifier and card-MSM coins, else ``"cpu"`` and
    ``msm="host"``."""
    from dag_rider_tpu_torch import Config
    from dag_rider_tpu_torch.config import MempoolConfig
    from dag_rider_tpu_torch.consensus.coin import ThresholdCoin
    from dag_rider_tpu_torch.consensus.simulator import Simulation
    from dag_rider_tpu_torch.crypto import threshold as th
    from dag_rider_tpu_torch.mempool.loadgen import ClusterLoadDriver, LoadGenerator
    from dag_rider_tpu_torch.transport.faults import FaultPlan, FaultyTransport

    n = CHAOS_N
    cfg = Config(n=n, coin="threshold_bls", propose_empty=True, gc_depth=24,
                 sync_request_cooldown_s=0.0, sync_serve_cooldown_s=0.0)
    keys = th.ThresholdKeys.generate(n, cfg.f + 1)
    sizes, walls = [], []
    make, oracle = shared_coin_factory(ThresholdCoin, keys, n,
                                       msm=msm_recorder(sizes, walls) if device else "host")
    sim = Simulation(cfg, transport=FaultyTransport(FaultPlan(delay=0.05, duplicate=0.02,
                                                              seed=10)),
                     verifier="device" if device else "cpu", coin_factory=make)
    ver = sim.processes[0].verifier
    if device:
        ver.comb_tables()  # the tables, before the counters go to 0
    gen = LoadGenerator(clients=2 * n, rate=40_000.0, tx_bytes=32, seed=10, profile="burst")
    drv = ClusterLoadDriver(sim, gen, mcfg=MempoolConfig(cap=512, batch_bytes=512,
                                                         max_batch_txs=64), dt=0.02)
    disp0 = getattr(ver, "total_dispatches", 0)
    reset_launch_counters()
    t = time.perf_counter()
    rep = drv.run(CHAOS_S, drain_s=None)
    wall = time.perf_counter() - t
    launches = read_launch_counters()
    dispatches = getattr(ver, "total_dispatches", 0) - disp0
    sim.check_agreement()
    return sim, drv, rep, wall, launches, sizes, oracle, dispatches


def chaos_phase() -> dict:
    """Phase B: the mempool under chaos at n = 64 on the card, byte for byte
    against the host oracle's run (``CPUVerifier``, host coins). Fails
    unless every view's delivered transactions and ``(round, source)`` log
    are byte-identical between the runs, the pool shed, nothing was lost or
    delivered twice, the card's launches are exact and nothing was
    contained. Returns the card run's launches."""
    t_phase = time.perf_counter()
    sim, drv, rep, wall, launches, sizes, oracle, dispatches = chaos_run(True)
    check_contained(sim._verify_pipe, "mempool chaos")
    want = want_launches(dispatches, sizes)
    if dispatches <= 0 or not sizes or launches != want:
        fail(f"mempool chaos: launches {launches}, want {want}")
    hsim, hdrv, hrep, hwall, _, _, horacle, _ = chaos_run(False)
    n = sim.cfg.n
    for name, r in (("card", rep), ("host", hrep)):
        if r["audit"]["lost"] or r["audit"]["duplicates"] or r["shed_tx"] <= 0:
            fail(f"mempool chaos ({name}): audit {r['audit']}, shed {r['shed_tx']}; want no "
                 f"loss, no duplicate and a shed")
    logs = [[(v.id.round, v.id.source) for v in d] for d in sim.deliveries]
    if not any(logs) or logs != [[(v.id.round, v.id.source) for v in d] for d in hsim.deliveries]:
        fail("mempool chaos: the card run's (round, source) logs differ from the host oracle's")
    txs = [drv.delivered_txs(i) for i in range(n)]
    if txs != [hdrv.delivered_txs(i) for i in range(n)] or rep != hrep:
        fail("mempool chaos: delivered transactions or the report differ from the host oracle's")
    if oracle._sigma != horacle._sigma:
        fail("mempool chaos: the coins' group signatures differ from the host oracle's")
    print(f"mempool chaos (n {n}, {CHAOS_S:g} s virtual, delay 0.05 / duplicate 0.02): card "
          f"wall {wall:.2f} s, host oracle wall {hwall:.2f} s; {rep['offered_tx']} offered, "
          f"{rep['accepted_tx']} accepted, {rep['shed_tx']} shed, {rep['committed_tx']} "
          f"committed; faults {dict(sim.transport.stats)}; {dispatches} card dispatches, "
          f"{len(sizes)} coin MSMs; logs, transactions and leaders of all {n} views "
          f"byte-identical to the host oracle; launches {launches}; phase wall "
          f"{time.perf_counter() - t_phase:.2f} s")
    return launches


def lane_side(n, seed, adversary, pump, lanes, cycles):
    """One side of phase C: ``bench.py``'s lanes identity cluster with the
    named ``"device"`` verifier. Returns per honest view the commit order
    and the SHA-256 of the delivered transaction bytes, the simulation, the
    Byzantine count, the launches and the verifier's dispatches (the
    scalar pump dispatches through the pipeline, the vector pump a batch
    a process)."""
    import hashlib

    from dag_rider_tpu_torch import Config
    from dag_rider_tpu_torch.consensus.adversary import ByzantineProcess, make_behavior
    from dag_rider_tpu_torch.consensus.process import Process
    from dag_rider_tpu_torch.consensus.simulator import Simulation

    cfg = Config(n=n, coin="round_robin", propose_empty=True, pump=pump, lanes=lanes,
                 lane_batch_bytes=256, sync_request_cooldown_s=0.0, sync_serve_cooldown_s=0.0,
                 sync_patience=1)
    nbyz = cfg.f if adversary else 0
    behaviors = {i: make_behavior(adversary, seed=seed + 1000 + i) for i in range(nbyz)}

    def factory(pcfg, i, ptp, **kwargs):
        if i in behaviors:
            return ByzantineProcess(pcfg, i, ptp, behavior=behaviors[i], **kwargs)
        return Process(pcfg, i, ptp, **kwargs)

    sim = Simulation(cfg, process_factory=factory if behaviors else None, verifier="device")
    ver = sim.processes[0].verifier
    ver.comb_tables()  # the tables, before the counters go to 0
    sim.submit_blocks(2, tx_bytes=600)  # above the 256-byte lane floor
    disp0 = ver.total_dispatches
    reset_launch_counters()
    for _ in range(cycles):
        sim.run(max_messages=n * (n - 1))
    launches = read_launch_counters()
    dispatches = ver.total_dispatches - disp0
    orders, digests = [], []
    for view in sim.deliveries[nbyz:]:
        orders.append([(v.id.round, v.id.source) for v in view])
        h = hashlib.sha256()
        for v in view:
            for tx in v.block.transactions:
                h.update(len(tx).to_bytes(4, "little"))
                h.update(tx)
        digests.append(h.hexdigest())
    return orders, digests, sim, nbyz, launches, dispatches


def lanes_phase() -> dict:
    """Phase C: dissemination lanes against inline payloads on the card,
    ``bench.py``'s identity matrix (n, seed, adversary, cycles) with both
    pumps, every vertex verified by the card. Fails unless the commit order
    and the delivered payload digests are identical per honest view, the
    inline side delivered something, the lanes really certified batches,
    and each side launched one ``tree_sum_xyzt`` and one ``finish_check`` a
    dispatch and nothing else. Returns the launches summed over all
    sides."""
    total = {}
    t_phase = time.perf_counter()
    for n, seed, adversary, cycles in LANE_MATRIX:
        for pump in LANE_PUMPS:
            t = time.perf_counter()
            ref_o, ref_d, ref, nbyz, l_ref, d_ref = lane_side(n, seed, adversary, pump, False,
                                                              cycles)
            lane_o, lane_d, sim, _, l_lane, d_lane = lane_side(n, seed, adversary, pump, True,
                                                               cycles)
            what = f"lanes n={n} {adversary} {pump}"
            if not any(ref_o):
                fail(f"{what}: the inline oracle delivered nothing")
            if ref_o != lane_o or ref_d != lane_d:
                fail(f"{what}: the commit order or the delivered payload bytes differ from "
                     f"the inline oracle's")
            certified = sum(p.metrics.counters.get("lane_batches_certified", 0)
                            + p.metrics.counters.get("lane_publish_degraded", 0)
                            for p in sim.processes)
            if certified <= 0:
                fail(f"{what}: the lane path never ran")
            for side, s, got, dispatches in (("inline", ref, l_ref, d_ref),
                                             ("lanes", sim, l_lane, d_lane)):
                want = want_launches(dispatches, [])
                if dispatches <= 0 or got != want:
                    fail(f"{what} ({side}): launches {got}, want {want}")
                if s._verify_pipe is not None:
                    check_contained(s._verify_pipe, f"{what} ({side})")
                add_launches(total, got)
            print(f"lanes n {n} {adversary or 'honest'} {pump}: {cycles} cycles, "
                  f"{len(ref_o[0])} deliveries a view, commit order and payload digests of "
                  f"{n - nbyz} honest views identical to inline; {certified} batches "
                  f"certified or degraded; card dispatches {d_ref} / {d_lane}; "
                  f"{time.perf_counter() - t:.2f} s")
    print(f"lanes phase wall: {time.perf_counter() - t_phase:.2f} s; launches {total}")
    return total


def byzantine_phase() -> dict:
    """Phase D: the Byzantine suite at n = 32 (``bench.py``'s byzantine rung
    plan); ``run_scenario`` raises on any broken invariant. The
    ``garbage_coin`` scenario runs the threshold coin with its MSM on the
    card (launches exact, shares filtered). Prints each scenario's
    detection counters. Returns the launches summed over the suite."""
    from dag_rider_tpu_torch.consensus.scenarios import Scenario, run_scenario

    total = {}
    t_phase = time.perf_counter()
    for kw in BYZ_PLAN:
        sizes = []
        name = f"{kw.get('adversary') or 'clean'}/{kw.get('wan', 'lan')}"
        t = time.perf_counter()
        with recorded_msms(sizes):
            reset_launch_counters()
            r = run_scenario(Scenario(n=BYZ_N, seed=0, **kw))
            launches = read_launch_counters()
        want = want_launches(0, sizes)
        if launches != want:
            fail(f"byzantine {name}: launches {launches}, want {want}")
        if kw.get("adversary") == "garbage_coin" and (not sizes or r["coin_filtered"] <= 0):
            fail(f"byzantine {name}: {len(sizes)} card MSMs, coin_filtered "
                 f"{r['coin_filtered']}; want both > 0")
        add_launches(total, launches)
        print(f"byzantine {name} (n {BYZ_N}, {r['cycles']} cycles): invariants held; waves "
              f"{r['decided_waves']}, equivocations_detected {r['equivocations_detected']}, "
              f"edge_rejects {r['edge_rejects']}, coin_filtered {r['coin_filtered']}, "
              f"sync_served {r['sync_served']}, behaviour {r['behavior']}, transport "
              f"{r['transport']}; card MSMs {len(sizes)}; {time.perf_counter() - t:.2f} s")
    print(f"byzantine phase wall: {time.perf_counter() - t_phase:.2f} s; launches {total}")
    return total


def swap_in(sim, index: int, restore, on_deliver):
    """Replace ``sim``'s process ``index`` by a fresh ``Process`` wired as
    the old one was (verifier, signers, coin, log) but delivering to
    ``on_deliver``, after ``restore(process)`` filled it; the transport's
    handler for ``index`` is the new process's. Returns the new process
    and what ``restore`` returned."""
    from dag_rider_tpu_torch.consensus.process import Process
    from dag_rider_tpu_torch.transport.memory import InMemoryTransport

    old = sim.processes[index]
    proc = Process(sim.cfg, index, InMemoryTransport(), coin=old.coin, verifier=old.verifier,
                   signer=old.signer, cert_signer=old.cert_signer,
                   cert_verifier=old.cert_verifier, on_deliver=on_deliver, log=old.log)
    got = restore(proc)
    if got is False:
        return proc, got
    proc.transport = sim.transport
    with sim.transport._lock:
        sim.transport._handlers[index] = proc.on_message
    sim.processes[index] = proc
    return proc, got


def snapshot_phase() -> dict:
    """Phase E: checkpoint and attested snapshot join on the card. An n = 64
    cluster with aggregate certificates and ``cert_span`` 4 (certificate
    MSM and pairing on the card, every vertex through the shared
    ``CUDAVerifier``) runs until quiet; process 0 is saved with
    ``checkpoint.save`` and restored into a fresh process, which takes its
    place; a fresh process for the last index first refuses a snapshot
    with one vertex changed (state intact, ``snapshot_attest_rejects``
    counted), then joins from ``attested_snapshot_bytes`` of process 1
    through ``restore_from_snapshot`` with the shared verifier and the
    card ``CertVerifier``, and takes its place; the cluster then runs on
    until quiet. Fails unless the restored state equals the donor's, the
    restored processes' later deliveries equal the cluster's, and the
    launches are exact. Returns the launches of the join and the run on."""
    import dataclasses
    import shutil

    from dag_rider_tpu_torch import Config
    from dag_rider_tpu_torch.consensus.simulator import Simulation
    from dag_rider_tpu_torch.core.types import Block
    from dag_rider_tpu_torch.utils import checkpoint
    from dag_rider_tpu_torch.verifier.cert import CertVerifier

    t_phase = time.perf_counter()
    n = SNAP_N
    cfg = Config(n=n, coin="round_robin", propose_empty=False, gc_depth=SNAP_GC,
                 cert_span=SNAP_SPAN)
    sim = Simulation(cfg, verifier="device", cert=True)
    cv = sim.cert_verifier
    card_ver = sim.processes[0].verifier
    if (cv.msm, cv.pair, cv.device.type, card_ver.device.type) != (
            "device", "device", "cuda", "cuda"):
        fail(f"snapshot: certificate msm {cv.msm!r}, pairing {cv.pair!r} on {cv.device}, "
             f"verifier on {card_ver.device}; want all on the card")
    card_ver.comb_tables()  # the tables, before the counters go to 0
    cert_sizes = []
    sum_points = cv._sum_points

    def recorded_sum(points):
        cert_sizes.append(len(points))
        return sum_points(points)

    cv._sum_points = recorded_sum
    sim.submit_blocks(per_process=SNAP_BLOCKS)
    disp0 = card_ver.total_dispatches
    reset_launch_counters()
    t = time.perf_counter()
    sim.run(max_messages=10**9)
    grow_wall = time.perf_counter() - t
    launches = read_launch_counters()
    grow_dispatches = card_ver.total_dispatches - disp0
    want = want_launches(grow_dispatches, cert_sizes)
    if grow_dispatches <= 0 or launches != want:
        fail(f"snapshot: the cluster's launches {launches}, want {want}")
    check_contained(sim._verify_pipe, "snapshot cluster")
    sim.check_agreement()
    donor = sim.processes[1]
    if donor.dag.base_round <= 0 or not donor._span_chain:
        fail(f"snapshot: donor base round {donor.dag.base_round}, {len(donor._span_chain)} spans; "
             f"want a pruned window and a span chain")
    print(f"snapshot cluster (n {n}, certificates, cert_span {SNAP_SPAN}, gc_depth {SNAP_GC}, "
          f"{SNAP_BLOCKS} blocks a process, until quiet): wall {grow_wall:.2f} s, round "
          f"{donor.round}, base round {donor.dag.base_round}, {len(donor._span_chain)} spans, "
          f"{len(sim.deliveries[1])} deliveries a view; {grow_dispatches} dispatches, "
          f"{len(cert_sizes)} certificate MSMs; launches {launches}")

    # -- checkpoint round trip -------------------------------------------------
    p0 = sim.processes[0]
    path = os.path.join(ROOT, "build", "chip_smoke_checkpoint")
    shutil.rmtree(path, ignore_errors=True)
    t = time.perf_counter()
    checkpoint.save(p0, path)
    save_s = time.perf_counter() - t
    restored, _ = swap_in(sim, 0, lambda p: checkpoint.restore(p, path),
                          sim.deliveries[0].append)
    if (restored.delivered_log != p0.delivered_log or restored.round != p0.round
            or set(restored.dag.vertices) != set(p0.dag.vertices)):
        fail("snapshot: the restored checkpoint's state differs from the saved process's")
    print(f"checkpoint: saved process 0 (round {p0.round}, {len(p0.dag.vertices)} vertices, "
          f"{sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))} bytes) in "
          f"{save_s:.3f} s, restored into a fresh process with the same state")

    # -- a tampered snapshot, then the attested join -----------------------------
    last = n - 1
    victim = donor.dag.vertices_in_round(donor.dag.base_round + 1)[0]
    forged = dataclasses.replace(victim, block=Block((b"forged-payload",)),
                                 signature=victim.signature)
    del donor.dag.vertices[victim.id]
    donor.dag.vertices[forged.id] = forged
    try:
        forged_blob = checkpoint.attested_snapshot_bytes(donor)
    finally:
        del donor.dag.vertices[forged.id]
        donor.dag.vertices[victim.id] = victim
    blob = checkpoint.attested_snapshot_bytes(donor)
    joined = []
    # the joiner's own span verifiers on the card: the cluster's has every
    # span's verdict cached, a joining process has none
    reg = card_ver.registry

    def join(p):
        if checkpoint.restore_from_snapshot(p, forged_blob, verifier=card_ver,
                                            span_verifier=CertVerifier(reg, cfg.quorum)):
            fail("snapshot: a blob with one vertex changed was accepted")
        if p.dag.max_round != 0 or p.round != 0 or (
                p.metrics.counters.get("snapshot_attest_rejects", 0) != 1):
            fail("snapshot: the refused blob changed the victim's state or was not counted")
        span_ver = CertVerifier(reg, cfg.quorum)
        if (span_ver.pair, span_ver.device.type) != ("device", "cuda"):
            fail(f"snapshot: the joiner's span verifier pairs {span_ver.pair!r} on "
                 f"{span_ver.device}; want the card")
        disp0, sigs0 = card_ver.total_dispatches, card_ver.total_sigs_dispatched
        checks0 = p.metrics.counters.get("snapshot_pairing_checks", 0)
        reset_launch_counters()
        t0 = time.perf_counter()
        ok = checkpoint.restore_from_snapshot(p, blob, verifier=card_ver, span_verifier=span_ver)
        joined.extend([time.perf_counter() - t0, read_launch_counters(),
                       span_ver.stats["pairing_checks"], card_ver.total_dispatches - disp0,
                       card_ver.total_sigs_dispatched - sigs0,
                       p.metrics.counters.get("snapshot_pairing_checks", 0) - checks0])
        return ok

    later = []
    pj, ok = swap_in(sim, last, join, later.append)
    if ok is not True:
        fail("snapshot: restore_from_snapshot refused the donor's attested snapshot")
    join_s, join_launches, pairings, dispatches, sigs, checks = joined
    want = want_launches(dispatches, [])
    if join_launches != want:
        fail(f"snapshot: the join launched {join_launches}, want {want}")
    c = pj.metrics.counters
    if checks <= 0 or pairings != checks:
        fail(f"snapshot: {pairings} card pairings for {checks} span checks")
    if pj.dag.base_round != donor.dag.base_round or sorted(pj.dag.vertices) != sorted(
            donor.dag.vertices):
        fail("snapshot: the joined process's window differs from the donor's")
    print(f"snapshot join: attested blob {len(blob)} bytes, {c['snapshot_spans_verified']} spans "
          f"verified with {pairings} pairings on the card, {sigs} unattested signatures in "
          f"{dispatches} card dispatches, {join_s:.3f} s; launches {join_launches}; the blob with "
          f"one vertex changed refused, victim intact, snapshot_attest_rejects counted")

    # -- run on: both restored processes take part ---------------------------------
    mark = len(sim.deliveries[1])
    disp0, sizes0 = card_ver.total_dispatches, len(cert_sizes)
    for p in sim.processes:
        for k in range(SNAP_MORE):
            p.submit(Block((f"p{p.index}-after-{k}".encode().ljust(32, b"."),)))
    reset_launch_counters()
    t = time.perf_counter()
    sim.run(max_messages=10**9)
    on_wall = time.perf_counter() - t
    on_launches = read_launch_counters()
    want = want_launches(card_ver.total_dispatches - disp0, cert_sizes[sizes0:])
    if on_launches != want:
        fail(f"snapshot: the run on launched {on_launches}, want {want}")
    check_contained(sim._verify_pipe, "snapshot run on")
    cluster = [(v.id.round, v.id.source, v.digest()) for v in sim.deliveries[1]]
    joined_log = [(v.id.round, v.id.source, v.digest()) for v in later]
    # the joiner delivers the window's history above the snapshot's floor,
    # then what the cluster delivers after the join: a suffix of the
    # cluster's log that covers everything after the join
    if len(cluster) == mark:
        fail("snapshot: the cluster delivered nothing after the join")
    if len(joined_log) < len(cluster) - mark or joined_log != cluster[len(cluster) - len(
            joined_log):]:
        fail("snapshot: the joined process's deliveries are not the cluster's log from the "
             "snapshot's floor on")
    logs = [[(v.id.round, v.id.source, v.digest()) for v in d] for d in sim.deliveries[:last]]
    if any(log != logs[1] for log in logs):
        fail("snapshot: after the run on, the restored checkpoint's log differs from the "
             "cluster's")
    print(f"snapshot run on ({SNAP_MORE} blocks a process, until quiet): wall {on_wall:.2f} s, "
          f"{len(cluster) - mark} deliveries after the join; the joined process delivered "
          f"{len(joined_log)}, the cluster's log from round {joined_log[0][0]} on, and the "
          f"restored checkpoint's log equals every view's; launches {on_launches}; "
          f"phase wall {time.perf_counter() - t_phase:.2f} s")
    total = {}
    add_launches(total, join_launches)
    add_launches(total, on_launches)
    return total


def rotate_run(keys, op, epoch_on: bool, msm):
    """``bench.py``'s ``rotate_ab`` cluster: n = 4, 4-wave epochs, one
    ``rotate`` op, independent coin books over ``keys``, run until every
    view decided 5 waves (and, with epochs, crossed a boundary), with
    ``epoch_rotate="dkg"``."""
    from dag_rider_tpu_torch import Config
    from dag_rider_tpu_torch.consensus.coin import ThresholdCoin
    from dag_rider_tpu_torch.consensus.simulator import Simulation
    from dag_rider_tpu_torch.core.types import Block

    n = ROTATE_N
    cfg = Config(n=n, coin="threshold_bls", propose_empty=True, epoch=epoch_on, epoch_waves=4,
                 epoch_rotate="dkg")
    sim = Simulation(cfg, coin_factory=lambda i: ThresholdCoin(keys, i, n, msm=msm))
    sim.submit_blocks(per_process=2)
    sim.processes[0].submit(Block((op,)))
    for _ in range(900):
        if min(p.decided_wave for p in sim.processes) >= 5 and (
                not epoch_on or min(p.epoch_mgr.epoch for p in sim.processes) >= 1):
            break
        sim.run(max_messages=300)
    else:
        fail(f"rotate: the run (epoch {epoch_on}) never settled")
    sim.check_agreement()
    return sim


def rotate_phase() -> dict:
    """Phase F: DKG key rotation (``bench.py``'s ``rotate_ab`` cell with
    ``epoch_rotate="dkg"``, n = 4 as the reference's own DKG tests run it:
    the resharing is host math that grows as n^3), the coins' MSM on the
    card. Fails unless every process rotated and holds the same new group
    key, the log is byte-identical to the same run with host coins, the
    pre-boundary prefix equals the static run's, and the MSM launches are
    exact. Returns the card run's launches."""
    from dag_rider_tpu_torch.core import codec
    from dag_rider_tpu_torch.core.types import EpochOp
    from dag_rider_tpu_torch.crypto import threshold as th

    t_phase = time.perf_counter()
    n = ROTATE_N
    keys = th.ThresholdKeys.generate(n, (n - 1) // 3 + 1, seed=b"bench-ab")
    op = codec.encode_epoch_op(EpochOp("rotate", 0, 1, b""))
    sizes, walls = [], []
    reset_launch_counters()
    t = time.perf_counter()
    rot = rotate_run(keys, op, True, msm_recorder(sizes, walls))
    wall = time.perf_counter() - t
    launches = read_launch_counters()
    want = want_launches(0, sizes)
    if not sizes or launches != want:
        fail(f"rotate: launches {launches}, want {want}")
    host = rotate_run(keys, op, True, "host")
    static = rotate_run(keys, op, False, "host")
    rotations = [p.metrics.counters.get("epoch_rotations", 0) for p in rot.processes]
    if min(rotations) < 1:
        fail(f"rotate: rotations per process {rotations}")
    group = {p.coin.keys.group_pk for p in rot.processes}
    if len(group) != 1 or keys.group_pk in group:
        fail("rotate: the processes do not hold one new group key after the rotation")
    logs = [[(v.id.round, v.id.source, v.digest()) for v in d] for d in rot.deliveries]
    if logs != [[(v.id.round, v.id.source, v.digest()) for v in d] for d in host.deliveries]:
        fail("rotate: the card coins' log differs from the host coins' run")
    cut = rot.processes[0].epoch_mgr.history[-1].boundary_wave * 4

    def prefix(sim):
        return [(v.id.round, v.id.source, v.digest()) for v in sim.deliveries[0]
                if v.id.round <= cut]

    if not prefix(rot) or prefix(rot) != prefix(static):
        fail("rotate: the pre-boundary prefix differs from the static run's")
    print(f"rotate (n {n}, DKG resharing, 4-wave epochs): card coins wall {wall:.2f} s, "
          f"{min(p.decided_wave for p in rot.processes)} waves decided, boundary wave "
          f"{cut // 4}, rotations {rotations}, one new group key; {len(sizes)} card MSMs "
          f"({sum(walls) * 1e3:.1f} ms); log byte-identical to the host coins' run, "
          f"{len(prefix(rot))}-vertex prefix equal to the static run's; launches {launches}; "
          f"phase wall {time.perf_counter() - t_phase:.2f} s")
    return launches


def host_layer_phases() -> dict:
    """Phases A-F in order; returns each phase's launches by letter."""
    out = {}
    for letter, phase in (("A", ingest_phase), ("B", chaos_phase), ("C", lanes_phase),
                          ("D", byzantine_phase), ("E", snapshot_phase), ("F", rotate_phase)):
        t = time.perf_counter()
        out[letter] = phase()
        print(f"phase {letter} wall: {time.perf_counter() - t:.2f} s")
    return out



# -- phase G: the degradation ladder over the card; phase H: the checkers


class CardTier:
    """A ladder tier over a card verifier: answers through it, counts the
    calls it answered, their rows and the dispatches they made (the inner
    verifier's own ``total_dispatches``), and while ``broken`` raises
    ``VerifierUnavailableError`` and reads unhealthy to the ladder's probe
    (the ``_FlakyTier`` recipe of ``tests/test_resilient.py``, over the
    card). The quarantine slot is the card verifier's own, so the ladder
    wires its next tier into the card's containment."""

    def __init__(self, inner):
        self.inner = inner
        self.broken = False
        self.raised = self.answered = self.rows = self.dispatches = self.probes = 0

    @property
    def quarantine_verifier(self):
        return self.inner.quarantine_verifier

    @quarantine_verifier.setter
    def quarantine_verifier(self, tier):
        self.inner.quarantine_verifier = tier

    def ping(self) -> bool:
        self.probes += 1
        return not self.broken

    def _answer(self, call, rows: int):
        from dag_rider_tpu_torch.verifier.base import VerifierUnavailableError

        if self.broken:
            self.raised += 1
            raise VerifierUnavailableError("the card tier is down (seeded)")
        d0 = self.inner.total_dispatches
        out = call()
        self.answered += 1
        self.rows += rows
        self.dispatches += self.inner.total_dispatches - d0
        return out

    def verify_batch(self, vertices):
        return self._answer(lambda: self.inner.verify_batch(vertices), len(vertices))

    def verify_rounds(self, rounds):
        return self._answer(lambda: self.inner.verify_rounds(rounds),
                            sum(len(r) for r in rounds))


class FloorTier:
    """The ladder's floor, a ``CPUVerifier``, counting apart the rows it
    verified as the ladder's fallback (``verify_rounds``, the ladder's
    entry) and as the card's quarantine tier (``verify_batch``)."""

    def __init__(self, registry):
        from dag_rider_tpu_torch.verifier.cpu import CPUVerifier

        self.cpu = CPUVerifier(registry)
        self.fallback_rows = self.quarantine_rows = 0

    def verify_batch(self, vertices):
        self.quarantine_rows += len(vertices)
        return self.cpu.verify_batch(vertices)

    def verify_rounds(self, rounds):
        self.fallback_rows += sum(len(r) for r in rounds)
        return [self.cpu.verify_batch(r) for r in rounds]


def contained(ver) -> tuple:
    return ver.poisoned_windows, ver.quarantined_chunks, ver.quarantine_rejected


def make_ladder(card, floor):
    from dag_rider_tpu_torch.verifier.resilient import ResilientVerifier

    return ResilientVerifier([card, floor], retries=1, seed=SEED, backoff_s=0.001,
                             probe_interval_s=LADDER_PROBE_S)


def wait_promoted(ladder, what: str) -> float:
    """Seconds until the probe promoted tier 0 back; fails after 10 s."""
    t0 = time.perf_counter()
    while not ladder.tier_health()[0]:
        if time.perf_counter() - t0 > 10.0:
            fail(f"{what}: the probe never promoted the card tier back")
        time.sleep(0.005)
    return time.perf_counter() - t0


def ladder_flaky_run(inner, registry, rounds, mask, what: str) -> dict:
    """G1's flaky run: ``rounds`` in calls of ``LADDER_ROUNDS_PER_CALL``
    rounds through the ladder, the card tier down for a seeded window of
    ``LADDER_WINDOW`` calls, then the window cleared and the promotion
    awaited. Gates: the masks equal ``mask``; one retry and one fallback (the
    window's first call, retries=1), the card tier raised exactly twice, the
    floor's rows exactly the window's, nothing quarantined; no fall before
    the window; the call after the promotion launched on the card; the
    launches equal the card tier's answered dispatches times the shards."""
    import numpy as np

    calls = [rounds[i:i + LADDER_ROUNDS_PER_CALL]
             for i in range(0, len(rounds), LADDER_ROUNDS_PER_CALL)]
    start = int(np.random.default_rng(SEED + 2).integers(1, len(calls) - LADDER_WINDOW))
    window = range(start, start + LADDER_WINDOW)
    k = getattr(inner, "mesh_devices", 1)
    inner.verify_batch(rounds[0][:8])  # the card tier launches before the ladder exists
    card, floor = CardTier(inner), FloorTier(registry)
    g0 = contained(inner)
    got, promoted_s = [], None
    try:
        ladder = make_ladder(card, floor)  # wires the floor into inner's quarantine slot
        reset_launch_counters()
        for j, call in enumerate(calls):
            card.broken = j in window
            if j == window.stop:
                promoted_s = wait_promoted(ladder, what)
                before = read_launch_counters()["tree_sum_xyzt"]
            got.extend(ladder.verify_rounds(call))
            if j < start and (ladder.fallbacks_total or ladder.retries_total
                              or ladder.last_tier):
                fail(f"{what}: the ladder fell a tier at call {j}, before any fault")
            if j == window.stop:
                after = read_launch_counters()["tree_sum_xyzt"]
                if ladder.last_tier != 0 or after - before != k:
                    fail(f"{what}: the call after the promotion went to tier "
                         f"{ladder.last_tier} with {after - before} tree launches, want the "
                         f"card's {k}")
        launches = read_launch_counters()
    finally:
        inner.quarantine_verifier = None
    win_rows = sum(len(r) for j in window for r in calls[j])
    want = want_launches(card.dispatches * k, [])
    gauges = {"retries": ladder.retries_total, "fallbacks": ladder.fallbacks_total,
              "exhausted": ladder.exhausted_total, "raised": card.raised,
              "floor_rows": floor.fallback_rows, "quarantine_rows": floor.quarantine_rows,
              "answered": card.answered, "dispatches": card.dispatches}
    plan = {"retries": 1, "fallbacks": 1, "exhausted": 0, "raised": 2, "floor_rows": win_rows,
            "quarantine_rows": 0, "answered": len(calls) - LADDER_WINDOW,
            "dispatches": len(calls) - LADDER_WINDOW}
    if flat_mask(got) != mask:
        fail(f"{what}: the ladder's masks differ from the oracle-checked mask")
    if gauges != plan or contained(inner) != g0:
        fail(f"{what}: gauges {gauges}, want the seeded plan's {plan}; contained "
             f"{contained(inner)} (was {g0})")
    if launches != want or ladder.tier_health() != [True, True]:
        fail(f"{what}: launches {launches}, want {want}; health {ladder.tier_health()}")
    print(f"  {what}: {len(calls)} calls of {LADDER_ROUNDS_PER_CALL} rounds, the card tier down "
          f"for calls {window.start}-{window.stop - 1} (seeded): masks equal; retries 1, "
          f"fallbacks 1, the floor verified {win_rows} rows, the card {card.rows}; promoted "
          f"{promoted_s * 1e3:.0f} ms after the window (probe every "
          f"{LADDER_PROBE_S * 1e3:.0f} ms, {card.probes} probes) and the next call launched on "
          f"the card; launches {launches}")
    return launches


def ladder_verify_phase(ver, rounds, mask) -> dict:
    """Phase G1: the verify phase's 4,096 rows through
    ``ResilientVerifier([card tier over ver, CPUVerifier floor], retries=1)``:
    streamed in chunks of ``STREAM_BUCKET`` with the verify phase's
    containment faults armed on the card (two ``dispatch_raise``, then two ``resolve_raise``):
    the card's containment quarantines exactly the plan's chunks onto the
    ladder's floor, the ladder itself sees no exception; then the flaky-tier
    run on ``ver`` and on a ``ShardedCUDAVerifier`` over ``mesh_from_env()``.
    Returns each run's launches."""
    from dag_rider_tpu_torch.parallel.mesh import mesh_from_env
    from dag_rider_tpu_torch.parallel.sharded_verifier import ShardedCUDAVerifier
    from dag_rider_tpu_torch.verifier.faults import VerifierFaultInjector, VerifierFaultPlan

    t_phase = time.perf_counter()
    total = sum(len(r) for r in rounds)
    chunks = -(-total // STREAM_BUCKET)
    out = {}
    print(f"phase G1, the ladder over the card ({total} rows, {len(rounds)} rounds):")
    depth0 = ver.pipeline_depth
    try:
        ver.fixed_bucket = STREAM_BUCKET
        ver.pipeline_depth = 2
        card, floor = CardTier(ver), FloorTier(ver.registry)
        ladder = make_ladder(card, floor)
        if ver.quarantine_verifier is not floor:
            fail("G1: the ladder did not wire its floor into the card's quarantine slot")
        # the seeded plan at depth 2: the two dispatch faults each poison a
        # window with nothing in flight and quarantine their own chunk, which
        # never launched; the first resolve fault poisons the window and its
        # salvage of the next in-flight chunk takes the second, so both chunks
        # (already launched) are quarantined
        plans = {"dispatch_raise": ((2, 2, 0), chunks - 2), "resolve_raise": ((1, 2, 0), chunks)}
        for kind, seed in (("dispatch_raise", SEED), ("resolve_raise", SEED + 1)):
            g0, q0, d0 = contained(ver), floor.quarantine_rows, card.dispatches
            inj = VerifierFaultInjector(VerifierFaultPlan(**{kind: 1.0}, max_faults=2, seed=seed))
            reset_launch_counters()
            try:
                inj.arm(ver)
                got = ladder.verify_rounds(rounds)
            finally:
                inj.disarm()
            launches = read_launch_counters()
            g = tuple(a - b for a, b in zip(contained(ver), g0))
            q_rows, dispatched = floor.quarantine_rows - q0, card.dispatches - d0
            (want_g, want_d) = plans[kind]
            if flat_mask(got) != mask:
                fail(f"G1 {kind}: the ladder's masks differ from the oracle-checked mask")
            if (inj.faults_injected, g, q_rows, dispatched) != (2, want_g, 2 * STREAM_BUCKET, want_d):
                fail(f"G1 {kind}: faults {inj.faults_injected}, contained {g}, floor quarantine "
                     f"rows {q_rows}, dispatches {dispatched}; want 2, {want_g}, "
                     f"{2 * STREAM_BUCKET}, {want_d}")
            if (ladder.retries_total, ladder.fallbacks_total, ladder.last_tier,
                    floor.fallback_rows) != (0, 0, 0, 0):
                fail(f"G1 {kind}: the ladder fell a tier (retries {ladder.retries_total}, "
                     f"fallbacks {ladder.fallbacks_total}) for a fault the card contained")
            if launches != want_launches(dispatched, []):
                fail(f"G1 {kind}: launches {launches}, want {want_launches(dispatched, [])}")
            out[f"G1 {kind}"] = launches
            print(f"  containment {kind} (max_faults 2, seed {seed}): masks equal; windows "
                  f"poisoned {g[0]}, chunks quarantined {g[1]}: {q_rows} rows re-verified on the "
                  f"floor, {total - q_rows} on the card; rejected {g[2]}; the ladder saw no "
                  f"exception; launches {launches}")
    finally:
        ver.fixed_bucket = None
        ver.pipeline_depth = depth0
        ver.quarantine_verifier = None
    out["G1 flaky"] = ladder_flaky_run(ver, ver.registry, rounds, mask, "flaky card tier")
    sharded = ShardedCUDAVerifier(ver.registry, mesh_from_env())
    sharded._tables = ver.comb_tables()
    out["G1 flaky sharded"] = ladder_flaky_run(sharded, ver.registry, rounds, mask,
                                               f"flaky tier on {sharded.mesh!r}")
    print(f"phase G1 wall: {time.perf_counter() - t_phase:.2f} s")
    return out


def ladder_consensus_phase(ref) -> dict:
    """Phase G2: phase 8's cluster (n = 256, card-MSM coins, ``CONS_WAVES`` decided waves,
    the same number of ``run`` calls) with ``ResilientVerifier([card tier
    over the phase's CUDAVerifier, CPUVerifier floor], retries=1)`` as its
    shared verifier (the simulator takes the ladder's synchronous
    ``verify_rounds`` path). The card tier is down for ``LADDER_DOWN``
    seeded cycles mid-run, then cleared and promoted. Gates: logs, leaders,
    decided waves and messages byte-identical to the host-oracle log phase
    8 checked; one retry and one fallback; ``verify_fallback_tier`` 1 in the
    process metrics at the end of the stretch; after the promotion the card
    answers every remaining cycle and the floor none; launches exactly the
    card tier's dispatches and the coin MSMs'; nothing contained."""
    import numpy as np

    from dag_rider_tpu_torch import Config

    t_phase = time.perf_counter()
    n = CONS_N
    cfg = Config(n=n, coin="threshold_bls", propose_empty=True, gc_depth=24)
    ver = ref["verifier"]
    calls = ref["calls"]
    start = int(np.random.default_rng(SEED + 3).integers(2, max(3, calls // 2)))
    stop = start + LADDER_DOWN
    card, floor = CardTier(ver), FloorTier(ver.registry)
    g0 = contained(ver)
    seen = {}

    def between(done, sim):
        if done < start and (ladder.fallbacks_total or ladder.retries_total):
            fail(f"G2: the ladder fell a tier after call {done}, before any fault")
        if done == start:
            card.broken = True
        elif done == stop:
            seen["tier_in_metrics"] = sim.processes[0].metrics.snapshot().get(
                "verify_fallback_tier")
            seen["floor_rows"] = floor.fallback_rows
            card.broken = False
            seen["promoted_s"] = wait_promoted(ladder, "G2")
            seen["answered"] = card.answered
            seen["tree"] = read_launch_counters()["tree_sum_xyzt"]

    msm_sizes = []
    try:
        ladder = make_ladder(card, floor)  # wires the floor into ver's quarantine slot
        sim, oracle, msgs, done, wall, spent, _ = drive_cluster(
            cfg, ref["keys"], ref["signers"], msm_recorder(msm_sizes, []), verifier=ladder,
            calls=calls, between=between)
        launches = read_launch_counters()
    finally:
        ver.quarantine_verifier = None
    logs = [[(v.id.round, v.id.source, v.digest()) for v in d] for d in sim.deliveries]
    if logs != ref["logs"]:
        bad = [i for i, (a, b) in enumerate(zip(logs, ref["logs"])) if a != b]
        fail(f"G2: logs differ from the host oracle's at views {bad[:10]}")
    if oracle._sigma != ref["sigma"] or msgs != ref["msgs"] or (
            [p.decided_wave for p in sim.processes] != ref["decided"]):
        fail("G2: leaders, messages or decided waves differ from the host oracle's")
    gauges = (ladder.retries_total, ladder.fallbacks_total, ladder.exhausted_total, card.raised,
              floor.quarantine_rows)
    if gauges != (1, 1, 0, 2, 0) or contained(ver) != g0:
        fail(f"G2: retries, fallbacks, exhausted, raised, quarantined rows {gauges}, want "
             f"(1, 1, 0, 2, 0); contained {contained(ver)} (was {g0})")
    if seen.get("tier_in_metrics") != 1 or "verify_fallback_tier" not in (
            sim.processes[0].metrics.snapshot()):
        fail(f"G2: verify_fallback_tier {seen.get('tier_in_metrics')} in the process metrics "
             f"at the end of the stretch, want 1")
    after = card.answered - seen["answered"]
    if (floor.fallback_rows != seen["floor_rows"] or after <= 0
            or launches["tree_sum_xyzt"] <= seen["tree"] or ladder.last_tier != 0):
        fail(f"G2: after the promotion the card answered {after} calls, the floor "
             f"{floor.fallback_rows - seen['floor_rows']} rows, last tier {ladder.last_tier}")
    want = want_launches(card.dispatches, msm_sizes)
    if launches != want:
        fail(f"G2: launches {launches}, want {want} ({card.dispatches} card dispatches)")
    print(f"phase G2, consensus through the ladder (n {n}, {done} runs, the card tier down "
          f"for runs {start + 1}-{stop}, seeded): logs of all {n} views, "
          f"{len(oracle._sigma)} leaders and decided waves byte-identical to the host oracle's; "
          f"retries 1, fallbacks 1, verify_fallback_tier 1 at the stretch's end; the floor "
          f"verified {floor.fallback_rows} rows; promoted {seen['promoted_s'] * 1e3:.0f} ms "
          f"after, then the card answered {after} calls ({card.dispatches} dispatches in all); "
          f"launches {launches}; wall {wall:.2f} s (phase 8's card run {ref['wall']:.2f} s); "
          f"host split: {split_line(spent)}")
    print(f"phase G2 wall: {time.perf_counter() - t_phase:.2f} s")
    return launches


def checkers_phase() -> None:
    """Phase H: the port's checkers (``python -m dag_rider_tpu_torch.analysis
    --budget-s 30``) in a subprocess on this machine (no JAX): exit 0 and
    ``clean``. Launches nothing."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "dag_rider_tpu_torch.analysis", "--budget-s",
                           "30"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    lines = proc.stdout.strip().splitlines()
    for line in lines:
        print(f"  checkers: {line}")
    if proc.returncode != 0 or not lines or not lines[-1].startswith("clean"):
        fail(f"H: the checkers exited {proc.returncode}: {proc.stderr.strip()[-2000:]}")
    print(f"phase H wall: {time.perf_counter() - t0:.2f} s")


# -- phase I: the networked deployment (sidecar, nodes over sockets, cluster)


class SidecarBackend:
    """The sidecar's backend: a card ``CUDAVerifier`` that records the bit
    it answered for each distinct row (keyed by the row's encoding, the
    signature included, so no row is checked on the host twice) and its
    wall in ``verify_batch``. ``warmup`` is the card verifier's, so the
    server warms the card up before its port opens."""

    def __init__(self, inner):
        self.inner = inner
        self.bits = {}
        self.conflicts = 0
        self.rows = 0
        self.busy_s = 0.0

    def warmup(self, bucket=None) -> float:
        return self.inner.warmup(bucket)

    def verify_batch(self, vertices):
        from dag_rider_tpu_torch.core import codec

        t = time.perf_counter()
        out = self.inner.verify_batch(vertices)
        self.busy_s += time.perf_counter() - t
        self.rows += len(vertices)
        for v, ok in zip(vertices, out):
            if self.bits.setdefault(codec.encode_vertex(v), ok) != ok:
                self.conflicts += 1
        return out


def sidecar_load_phase(server, backend, rounds, mask, ver) -> dict:
    """I1: the verify phase's 16 rounds (n = 256, 64 corrupted rows) shipped
    to the sidecar as whole-round batches by a ``RemoteVerifier``, with the
    counters set to 0 just before and read just after: the masks equal the
    phase's (the in-process ``CUDAVerifier``'s, checked against the host
    oracle), one ``tree_sum_xyzt`` and one ``finish_check`` launch a
    sidecar dispatch. Then the RPC wall against the in-process dispatch
    wall, round by round, in turns; returns the launches."""
    from dag_rider_tpu_torch.verifier import sidecar as sc

    card = backend.inner
    remote = sc.RemoteVerifier(server.address, timeout=60.0)
    try:
        d0 = card.total_dispatches
        reset_launch_counters()
        got = [remote.verify_batch(rnd) for rnd in rounds]
        launches = read_launch_counters()
        dispatches = card.total_dispatches - d0
        if [bit for mk in got for bit in mk] != mask:
            bad = [i for i, (a, b) in enumerate(zip((b for mk in got for b in mk), mask))
                   if a != b]
            fail(f"I1: the sidecar's masks differ from the phase's at rows {bad[:10]}")
        want = want_launches(dispatches, [])
        if dispatches != len(rounds) or launches != want or remote.rpc_failures:
            fail(f"I1: {dispatches} sidecar dispatches for {len(rounds)} RPCs, "
                 f"{remote.rpc_failures} RPC failures, launches {launches}, want {want}")
        parts = {k: [] for k in ("rpc", "encode", "prep", "device", "local", "local_prep",
                                 "local_device")}
        for _ in range(3):
            for rnd in rounds:
                t = time.perf_counter()
                sc._encode_batch(rnd)
                parts["encode"].append(time.perf_counter() - t)
                p0, d0 = span_s(card, PREP), span_s(card, *ENQUEUE_TO_MASK)
                t = time.perf_counter()
                remote.verify_batch(rnd)
                parts["rpc"].append(time.perf_counter() - t)
                parts["prep"].append(span_s(card, PREP) - p0)
                parts["device"].append(span_s(card, *ENQUEUE_TO_MASK) - d0)
                p0, d0 = span_s(ver, PREP), span_s(ver, *ENQUEUE_TO_MASK)
                t = time.perf_counter()
                ver.verify_batch(rnd)
                parts["local"].append(time.perf_counter() - t)
                parts["local_prep"].append(span_s(ver, PREP) - p0)
                parts["local_device"].append(span_s(ver, *ENQUEUE_TO_MASK) - d0)
    finally:
        remote.close()
    med = {k: statistics.median(v) * 1e3 for k, v in parts.items()}
    rest = med["rpc"] - med["encode"] - med["prep"] - med["device"]
    print(f"phase I1, the sidecar (gRPC, one server thread, warmed up in "
          f"{server.warmup_compile_s * 1e3:.1f} ms before its port opened): {len(rounds)} "
          f"whole-round batches of {len(rounds[0])} rows, masks equal to the in-process "
          f"CUDAVerifier's "
          f"and the host oracle's sample; {dispatches} dispatches, launches {launches}")
    print(f"  per round (median of {len(parts['rpc'])}): RPC wall {med['rpc']:.2f} ms = encode "
          f"{med['encode']:.2f} + host prep {med['prep']:.2f} + device {med['device']:.2f} + "
          f"transport and decode {rest:.2f} ms; in-process dispatch {med['local']:.2f} ms "
          f"(host prep {med['local_prep']:.2f} + device {med['local_device']:.2f} ms)")
    return launches


def sockets_worker(cfgs, conn, go, stop, waves, rounds) -> None:
    """One OS process of I2: builds its ``Node``s (ports bound), warms the
    card with one MSM, counts the ``ShardedMSM`` calls its coins make (and
    their walls) and records each node's decided leaders; reports ready,
    starts the nodes on ``go``, publishes each node's decided wave and
    round in ``waves`` and ``rounds`` until ``stop``, stops the nodes and
    sends back their logs, leaders, gauges, its launches and the MSM
    plan."""
    sys.path.insert(0, ROOT)
    import hashlib

    from dag_rider_tpu_torch import node as node_mod
    from dag_rider_tpu_torch.core.types import Block
    from dag_rider_tpu_torch.crypto import bls12381 as bls
    from dag_rider_tpu_torch.parallel import msm as pmsm
    from dag_rider_tpu_torch.utils.slog import EventLog
    from dag_rider_tpu_torch.verifier.resilient import ResilientVerifier

    pmsm.ShardedMSM()([1], [bls.G1_GEN])  # the CUDA context, the library, the tables
    sizes, walls = [], []
    call = pmsm.ShardedMSM.__call__

    def counted(self, scalars, points):
        sizes.append((len(points), self.n_shards))
        t = time.perf_counter()
        try:
            return call(self, scalars, points)
        finally:
            walls.append(time.perf_counter() - t)

    pmsm.ShardedMSM.__call__ = counted
    leaders = {cfg["index"]: {} for cfg in cfgs}

    def sink_of(i):
        return lambda rec: leaders[i].__setitem__(rec["wave"], rec["leader"])

    nodes = [node_mod.Node(cfg, log=EventLog(sink_of(cfg["index"]), clock=time.perf_counter,
                                             names=frozenset({"wave_decided"})))
             for cfg in cfgs]
    for nd in nodes:
        i = nd.process.index
        for k in range(I2_BLOCKS):
            nd.submit(Block((hashlib.sha256(f"i2|{i}|{k}".encode()).digest(),)))
    reset_launch_counters()
    conn.send("ready")
    go.wait()

    for nd in nodes:
        nd.start()
    while not stop.is_set():
        for nd in nodes:
            waves[nd.process.index] = nd.process.decided_wave
            rounds[nd.process.index] = nd.process.round
        stop.wait(0.05)
    for nd in nodes:
        nd.stop()
    launches = read_launch_counters()
    out = []
    for nd in nodes:
        p, ver = nd.process, nd.process.verifier
        ladder = isinstance(ver, ResilientVerifier)
        remote = ver.tiers[0] if ladder else ver
        out.append({
            "index": p.index, "decided": p.decided_wave, "round": p.round,
            "log": [(v.id.round, v.id.source, v.digest().hex()) for v in nd.delivered],
            "txs": [len(v.block.transactions) for v in nd.delivered],
            "leaders": leaders[p.index],
            "counters": {k: v for k, v in p.metrics.counters.items()
                         if k.startswith(("net_", "sync_"))},
            "ladder": (ver.retries_total, ver.fallbacks_total, ver.exhausted_total,
                       ver.last_tier) if ladder else None,
            "remote": (remote.rpc_failures, remote.retries_total),
            "verify_s": p.metrics.verify_seconds_total,
            "commit_s": list(p.metrics.wave_commit_seconds),
        })
    conn.send({"nodes": out, "launches": launches, "msms": sizes, "msm_s": sum(walls)})


def sockets_phase(server, backend, seeds) -> dict:
    """I2: ``BASELINE.json`` config #2's committee, n = 16, over real sockets:
    16 ``Node``s, each on its own ``127.0.0.1`` port, Bracha RBC and frame
    auth on, ``verifier: "remote"`` to I1's sidecar with ``verify_fallback:
    "cpu"`` (the ladder), ``coin: "threshold_bls"`` with ``coin_msm:
    "device"``, ``propose_empty``, ``net_batch`` (each node's frames to a
    peer go out once a pump pass as one RPC), one one-transaction block a
    vertex. The
    Ed25519 identities are the first 16 of the verify phase's registry,
    which the sidecar holds. The nodes run in ``I2_WORKERS`` OS processes
    (one process is held to ~800 gRPC sends a second by its interpreter
    lock, and RBC at n = 16 sends ~8,000 a round). Counters set to 0 just
    before the start and read after every node stopped. Gates: every node
    decides ``I2_WAVES`` waves within ``I2_DEADLINE_S``; the 16 logs pass
    the audit's agreement and commit-uniqueness checks; each decided wave's
    leader equals the host coin's (``ThresholdCoin(msm="host")``); every
    distinct row the sidecar answered gets the same bit from one
    ``CPUVerifier`` pass; no frame refused, no RPC failure, no ladder
    retry, fallback or exhaustion; launches exactly the sidecar's
    dispatches (comb kernels) and the nodes' ``ShardedMSM`` plans
    (``padd381_xx``, ``horner381``). Returns the launches."""
    import hashlib
    import multiprocessing as mp
    import shutil
    import tempfile

    from dag_rider_tpu_torch import node as node_mod
    from dag_rider_tpu_torch.cluster.directory import allocate_addresses
    from dag_rider_tpu_torch.consensus import invariants
    from dag_rider_tpu_torch.consensus.coin import ThresholdCoin
    from dag_rider_tpu_torch.core import codec
    from dag_rider_tpu_torch.crypto import threshold as th
    from dag_rider_tpu_torch.verifier.cpu import CPUVerifier

    n = I2_N
    card = backend.inner
    root = tempfile.mkdtemp(prefix="dagrider-i2-")
    keys_path = os.path.join(root, "keys.json")
    blob = node_mod.generate_keys(n, n // 3 + 1, seed=f"chip-smoke-i2-{SEED}")
    blob["ed25519_public"] = [pk.hex() for pk in card.registry.public_keys[:n]]
    blob["ed25519_seeds"] = [s.hex() for s in seeds[:n]]
    node_mod._dump_secret_file(keys_path, blob)
    reg, _, coin_keys = node_mod.load_keys(blob)
    addrs = allocate_addresses(root, n, "tcp")
    cfgs = [{"index": i, "n": n, "listen": addrs[i], "keys": keys_path,
             "peers": {str(j): addrs[j] for j in range(n) if j != i},
             "rbc": True, "auth_master": hashlib.sha256(f"i2|{SEED}".encode()).hexdigest(),
             "verifier": "remote", "verifier_address": server.address,
             "verifier_timeout_s": 60.0, "verify_fallback": "cpu",
             "coin": "threshold_bls", "coin_msm": "device", "propose_empty": True,
             "sync_patience": I2_SYNC_PATIENCE, "net_batch": I2_NET_BATCH}
            for i in range(n)]
    ctx = mp.get_context("spawn")
    waves, rounds = ctx.Array("i", n), ctx.Array("i", n)
    go, stop = ctx.Event(), ctx.Event()
    procs, conns = [], []
    t_boot = time.perf_counter()
    try:
        for w in range(I2_WORKERS):
            parent, child = ctx.Pipe()
            proc = ctx.Process(target=sockets_worker, daemon=True, args=(
                [cfgs[i] for i in range(w, n, I2_WORKERS)], child, go, stop, waves, rounds))
            proc.start()
            procs.append(proc)
            conns.append(parent)
        for w, conn in enumerate(conns):
            if not conn.poll(180.0) or conn.recv() != "ready":
                fail(f"I2: worker {w} did not come up")
        boot = time.perf_counter() - t_boot
        d0, rows0, busy0 = card.total_dispatches, len(backend.bits), backend.busy_s
        sent0, card_s0 = backend.rows, span_s(card, *ENQUEUE_TO_MASK)
        reset_launch_counters()
        t0 = last = time.perf_counter()
        go.set()
        while min(waves[:]) < I2_WAVES and time.perf_counter() - t0 <= I2_DEADLINE_S:
            if time.perf_counter() - last >= 10.0:
                last = time.perf_counter()
                print(f"  I2 at {last - t0:.0f} s: rounds {min(rounds[:])}-{max(rounds[:])}, "
                      f"decided waves {min(waves[:])}-{max(waves[:])}, "
                      f"{card.total_dispatches - d0} sidecar dispatches", flush=True)
            time.sleep(0.05)
        wall = time.perf_counter() - t0
        stop.set()
        results = []
        for w, conn in enumerate(conns):
            if not conn.poll(120.0):
                fail(f"I2: worker {w} sent no result")
            results.append(conn.recv())
        launches = read_launch_counters()
        dispatches = card.total_dispatches - d0
    finally:
        stop.set()
        go.set()
        for proc in procs:
            proc.join(timeout=30.0)
            if proc.is_alive():
                proc.kill()
                proc.join()
        shutil.rmtree(root, ignore_errors=True)
    nodes = sorted((nd for r in results for nd in r["nodes"]), key=lambda nd: nd["index"])

    if [nd["index"] for nd in nodes] != list(range(n)) or min(
            nd["decided"] for nd in nodes) < I2_WAVES:
        fail(f"I2: decided waves {[nd['decided'] for nd in nodes]} after {wall:.0f} s, want "
             f"{I2_WAVES} at all {n}; rounds {[nd['round'] for nd in nodes]}; "
             f"{dispatches} sidecar dispatches; node 0: {nodes[0]['counters']}, ladder "
             f"{nodes[0]['ladder']}, RPC (failures, retries) {nodes[0]['remote']}")
    logs = {nd["index"]: [(r, s, bytes.fromhex(d)) for r, s, d in nd["log"]] for nd in nodes}
    try:
        invariants.check_agreement(logs)
        invariants.check_commit_uniqueness(logs)
    except invariants.InvariantViolation as exc:
        fail(f"I2: the delivery logs disagree: {exc}")
    host = ThresholdCoin(coin_keys, 0, n, msm="host")
    decided = sorted({w for nd in nodes for w in nd["leaders"]})
    for w in decided:
        for j in range(coin_keys.threshold):
            host.observe_share(w, j, th.sign_share(coin_keys.share_sks[j], w))
        if not host.ready(w):
            fail(f"I2: the host coin is not ready for wave {w}")
        bad = [nd["index"] for nd in nodes if nd["leaders"].get(w, host.choose_leader(w))
               != host.choose_leader(w)]
        if bad:
            fail(f"I2: wave {w}'s leader at nodes {bad} differs from the host coin's "
                 f"{host.choose_leader(w)}")
    rows = list(backend.bits)[rows0:]
    answered = [backend.bits[k] for k in rows]
    oracle = CPUVerifier(reg).verify_batch([codec.decode_vertex(k)[0] for k in rows])
    if not rows or oracle != answered or backend.conflicts:
        fail(f"I2: {len(rows)} rows answered by the sidecar, "
             f"{sum(a != b for a, b in zip(oracle, answered))} differ from the host oracle, "
             f"{backend.conflicts} answered twice with different bits")
    gauges = {nd["index"]: (nd["counters"].get("net_auth_rejects", 0), nd["ladder"],
                            nd["remote"]) for nd in nodes}
    if any(g != (0, (0, 0, 0, 0), (0, 0)) for g in gauges.values()):
        fail(f"I2: auth rejects, ladder (retries, fallbacks, exhausted, last tier) and RPC "
             f"(failures, retries) {gauges}; want none")
    msms = [sz for r in results for sz in r["msms"]]
    worker = {}
    for r in results:
        add_launches(worker, r["launches"])
    total = dict(launches)
    add_launches(total, worker)
    want = want_launches(dispatches, [])
    want["padd381_xx"] = sum(sharded_msm_adds(pts, k) for pts, k in msms)
    want["horner381"] = len(msms)
    if launches["padd381_xx"] or launches["horner381"] or any(
            worker[k] for k in ("tree_sum_xyzt", "finish_check", "padd_xx")):
        fail(f"I2: launches in the sidecar's process {launches}, in the nodes' {worker}")
    if dispatches <= 0 or not msms or total != want:
        fail(f"I2: launches {total}, want {want} ({dispatches} sidecar dispatches, "
             f"{len(msms)} coin MSMs)")

    delivered = min(len(nd["log"]) for nd in nodes)
    committed_tx = sum(nodes[0]["txs"][:delivered])
    commit = [x for nd in nodes for x in nd["commit_s"]]
    card_s = span_s(card, *ENQUEUE_TO_MASK) - card_s0
    msm_s = sum(r["msm_s"] for r in results)
    busy = (f"at most {(card_s + msm_s) / wall:.3%} of the wall, bounded by host walls around "
            f"its work (the CUDA profiler is not run across these processes): the sidecar's "
            f"dispatches {card_s:.3f} s from enqueue to mask, the {len(msms)} coin MSMs "
            f"{msm_s:.3f} s from call to return")
    print(f"phase I2, config #2 over sockets (n {n}, {I2_WORKERS} processes of "
          f"{n // I2_WORKERS} nodes, RBC, frame auth, remote verifier with the CPU floor, "
          f"card-MSM threshold coins): {I2_WAVES} waves at every node in {wall:.2f} s "
          f"(boot {boot:.2f} s); decided waves {min(nd['decided'] for nd in nodes)}-"
          f"{max(nd['decided'] for nd in nodes)}, rounds "
          f"{min(nd['round'] for nd in nodes)}-{max(nd['round'] for nd in nodes)}")
    print(f"  {delivered} vertices delivered by every node, logs agreeing; {committed_tx} "
          f"transactions in the common prefix = {committed_tx / wall:.1f} committed tx/s; "
          f"wave commit p50 "
          f"{statistics.median(commit) * 1e3 if commit else float('nan'):.3f} ms "
          f"({len(commit)} samples); leaders of waves {decided[0]}-{decided[-1]} equal to the "
          f"host coin's; {len(rows)} distinct rows answered, each equal to the host oracle's "
          f"bit ({sum(answered)} accepted)")
    print(f"  sidecar: {dispatches} dispatches, {(backend.rows - sent0) / dispatches:.1f} rows "
          f"a dispatch, {backend.busy_s - busy0:.2f} s in its backend; the nodes' verify seam "
          f"(the RPC wall) {sum(nd['verify_s'] for nd in nodes):.2f} s summed over {n} nodes; "
          f"{len(msms)} coin MSMs of {sorted({p for p, _ in msms})} points; net RPCs "
          f"{sum(nd['counters'].get('net_sends', 0) for nd in nodes)}, auth rejects 0, ladder "
          f"retries and fallbacks 0; launches {total}; the card busy {busy}")
    return total


def fail_closed_check(server, rounds) -> None:
    """I1's last gate, after I2: with the server stopped, a ``RemoteVerifier``
    reads every row as rejected and counts the failure; one built with
    ``raise_on_unavailable`` raises ``VerifierUnavailableError``."""
    from dag_rider_tpu_torch.verifier import sidecar as sc
    from dag_rider_tpu_torch.verifier.base import VerifierUnavailableError

    addr = server.address
    server.stop()
    remote = sc.RemoteVerifier(addr, timeout=2.0)
    strict = sc.RemoteVerifier(addr, timeout=2.0, raise_on_unavailable=True)
    try:
        got = remote.verify_batch(rounds[0][:8])
        if got != [False] * 8 or remote.rpc_failures != 1:
            fail(f"I1: a stopped sidecar answered {got} ({remote.rpc_failures} RPC failures)")
        try:
            strict.verify_batch(rounds[0][:1])
        except VerifierUnavailableError:
            pass
        else:
            fail("I1: a stopped sidecar did not raise VerifierUnavailableError")
    finally:
        remote.close()
        strict.close()
    print("  I1 with the server stopped: the RemoteVerifier failed closed (8 rows rejected, "
          "1 RPC failure; raise_on_unavailable raised)")


def cluster_phase() -> None:
    """I3: the port's cluster command, ``python -m
    dag_rider_tpu_torch.scripts.cluster --n 4 --seconds 6 --rate 300 --kill
    auto`` (the copy of ``scripts/cluster.py``), as a subprocess with a
    60 s boot window: 4 OS processes of ``python -m
    dag_rider_tpu_torch.cluster.runner`` over UDS (``verifier: "cpu"``, as
    ``build_cluster`` writes them), wire-level load at 300 tx/s for 6 s, one
    seeded kill -9 and the rejoin from checkpoint, then ``audit_cluster``.
    The gates read the command's exit code and the audit JSON it prints:
    agreement, no lost or duplicated transaction, liveness, no
    flight-recorder dump, the kill and the restart executed, no runner
    SIGKILLed at stop. The runners are processes of their own with CPU
    verifiers: the phase's output is its audit, not a launch count."""
    t_phase = time.perf_counter()
    cmd = [sys.executable, "-m", "dag_rider_tpu_torch.scripts.cluster", "--n", str(I3_N),
           "--seconds", f"{I3_LOAD_S:g}", "--rate", f"{I3_RATE:g}", "--kill", "auto",
           "--boot-timeout", f"{I3_BOOT_S:g}"]
    # the runners import this checkout's package, wherever they start
    path = os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH")) if p)
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": path})
    try:
        report = json.loads(proc.stdout)
    except ValueError:
        report = None
    if proc.returncode != 0 or report is None:
        fail(f"I3: {' '.join(cmd[1:])} exited {proc.returncode}: "
             f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    if not report["ok"] or report["lost_tx"] or report["duplicate_tx"] or report[
            "flight_dump_files"] or not report["decided_waves"]:
        fail(f"I3: audit {json.dumps(report, default=repr)[:3000]}; stderr "
             f"{proc.stderr[-2000:]}")
    # the load gate reads the audit's ledger of acknowledged transactions: the
    # command joins its loader for --seconds + 30 s only, and at 300 tx/s of
    # ~10-20 ms submit RPCs its backlog can outlast that (its "load" is then {})
    executed, load = report["fault_plan"], report["load"]
    if [ev["action"] for ev in executed] != ["kill", "restart"] or not report["kills"] or \
            not report["accepted_tx"]:
        fail(f"I3: fault plan {executed}, kills {report['kills']}, {report['accepted_tx']} "
             f"accepted, load {load}; stderr {proc.stderr[-2000:]}")
    if report["forced_stops"]:
        fail(f"I3: runners SIGKILLed at stop {report['forced_stops']}")
    victim = executed[0]["node"]
    print(f"phase I3, the cluster command ({' '.join(cmd[2:])}: n {I3_N} OS processes over "
          f"UDS, {I3_RATE:.0f} tx/s for {I3_LOAD_S:.0f} s, kill -9 of node {victim} at "
          f"{executed[0]['t']:.1f} s, restart at {executed[1]['t']:.1f} s): exit 0; "
          f"{report['accepted_tx']} accepted (the loader's count {load.get('accepted')} of "
          f"{load.get('offered')} offered; none when it outlasts its join), "
          f"{report['delivered_tx']} delivered, 0 lost, 0 duplicated, in flight "
          f"{report['in_flight_tx']}; submit->deliver p50 {report['submit_deliver_p50_ms']} "
          f"ms; decided waves {report['decided_waves']}; rejoined {report.get('rejoined')}; "
          f"log lengths {report['log_lengths']}; agreement held, no flight dump; phase wall "
          f"{time.perf_counter() - t_phase:.2f} s")


def networked_phases(ver, rounds, mask, seeds) -> dict:
    """Phase I (I1-I3, with the sidecar's fail-closed gate after I2);
    returns the launches of I1 and I2 (I3 launches in its runners'
    processes, none of them on the card)."""
    from dag_rider_tpu_torch.verifier import sidecar as sc
    from dag_rider_tpu_torch.verifier.cuda import CUDAVerifier

    t_phase = time.perf_counter()
    card = CUDAVerifier(ver.registry)  # on the card: the sidecar has no other
    card._tables = ver._tables  # the verify phase's n = 256 comb tables, already built
    backend = SidecarBackend(card)
    server = sc.VerifierSidecarServer(backend, "127.0.0.1:0")
    if server.warmup_compile_s <= 0 or not card._warm:
        fail("I1: the sidecar's card verifier was not warmed up before its port opened")
    out = {}
    try:
        t = time.perf_counter()
        out["I1"] = sidecar_load_phase(server, backend, rounds, mask, ver)
        print(f"phase I1 wall: {time.perf_counter() - t:.2f} s")
        t = time.perf_counter()
        out["I2"] = sockets_phase(server, backend, seeds)
        print(f"phase I2 wall: {time.perf_counter() - t:.2f} s")
    finally:
        fail_closed_check(server, rounds)
    t = time.perf_counter()
    cluster_phase()
    print(f"phase I3 wall: {time.perf_counter() - t:.2f} s")
    print(f"phase I wall: {time.perf_counter() - t_phase:.2f} s")
    return out


# -- phase J: the driver entry points (graft_entry)


def entry_phase() -> dict:
    """Phase J: the port's twin of ``__graft_entry__.py``. J1, the flagship
    step: ``graft_entry.entry()`` on the card (its table build launches
    exactly ``key_tables``' two kernels), then ``fn(*args)`` with the
    counters at 0: its mask equals ``CPUVerifier``'s over the same vertices
    (8 accepted, 8 padded rows rejected) and ``fn`` over CPU copies of the
    arguments (the plain versions), with exactly one ``tree_sum_xyzt``, one
    ``finish_check`` and no table launch. J2, ``dryrun_multichip(8,
    mesh=virtual_mesh(8))``: its four paths pass (round step, ``ShardedMSM``,
    sharded comb, the pipeline over it), launching the windowed walk, both
    BLS kernels and the comb kernels, each exactly (32 tree and finish
    launches: four sharded dispatches of 8 shards). J3, ``python -m
    dag_rider_tpu_torch.graft_entry --mesh virtual`` as a subprocess: exit 0
    and both OK lines. Returns the launches of J1 and J2."""
    import torch

    from dag_rider_tpu_torch import graft_entry
    from dag_rider_tpu_torch.parallel.mesh import virtual_mesh
    from dag_rider_tpu_torch.verifier.cpu import CPUVerifier

    t_phase = time.perf_counter()
    out = {}
    reset_launch_counters()
    t0 = time.perf_counter()
    fn, args = graft_entry.entry()
    torch.cuda.synchronize()
    t_entry = time.perf_counter() - t0
    built = read_launch_counters()
    if built != {**{k: 0 for k in built}, "key_tables": 2}:
        fail(f"J1: entry()'s table build launched {built}")
    if not all(a.is_cuda for a in args) or fn.__name__ != "device_verify_comb":
        fail(f"J1: entry() gave {fn.__name__} over {[str(a.device) for a in args]}")
    ver, _, vs = graft_entry.example_batch(comb=True, device="cpu")
    oracle = CPUVerifier(ver.registry).verify_batch(vs)
    oracle += [False] * (args[0].shape[0] - len(oracle))
    reset_launch_counters()
    t0 = time.perf_counter()
    mask = fn(*args)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    out["J1"] = launches = read_launch_counters()
    plain = fn(*(a.cpu() for a in args))
    got = mask.cpu().tolist()
    if not (got == plain.tolist() == oracle == [True] * 8 + [False] * 8):
        fail(f"J1: the flagship step's mask {got}, plain {plain.tolist()}, oracle {oracle}")
    want = {**{k: 0 for k in launches}, "tree_sum_xyzt": 1, "finish_check": 1}
    if launches != want:
        fail(f"J1: the flagship step launched {launches}, not {want}")
    print(f"phase J1, the flagship step (graft_entry.entry(), 16 rows of 4 keys): entry() "
          f"{t_entry:.3f} s (its table build 2 launches), fn(*args) {step_ms:.3f} ms to a "
          f"synchronised card; mask = plain = CPUVerifier (8 accepted, 8 padding rejected); "
          f"launches {launches}")
    reset_launch_counters()
    t0 = time.perf_counter()
    rec = graft_entry.dryrun_multichip(J_MESH, mesh=virtual_mesh(J_MESH))
    torch.cuda.synchronize()
    t_dry = time.perf_counter() - t0
    out["J2"] = dry = read_launch_counters()
    # the round step: a windowed verify a shard, 80 padd_xx and one pow22523 each (one
    # padd_xx more where the walk's step graph is captured at this width); the MSM:
    # sharded_msm_adds and one horner381; the sharded comb: one table build and four
    # dispatches (verify_batch, warmup, dispatch_batch, the pipeline) of J_MESH shards
    want = {**{k: 0 for k in dry}, "tree_sum_xyzt": 4 * J_MESH, "finish_check": 4 * J_MESH,
            "key_tables": 2, "padd381_xx": sharded_msm_adds(J_MESH, J_MESH), "horner381": 1,
            "pow22523": J_MESH, "padd_xx": dry["padd_xx"]}
    if dry != want or dry["padd_xx"] not in (80 * J_MESH, 80 * J_MESH + 1):
        fail(f"J2: the dry run launched {dry}, not {want} with {80 * J_MESH} padd_xx "
             f"(+1 at a new walk width)")
    if not rec["mesh"].startswith("virtual Mesh(batch: cuda"):
        fail(f"J2: the dry run ran on {rec['mesh']}")
    print(f"phase J2, dryrun_multichip({J_MESH}, mesh=virtual_mesh({J_MESH})): four paths "
          f"passed (accepted {int(rec['accept'].sum())}, commit {rec['commit']}, MSM of "
          f"{rec['msm_points']} = host, comb and pipeline masks {sum(rec['comb_mask'])}/"
          f"{len(rec['comb_mask'])}, {rec['async_shards']} shards of {rec['shard_batch']}) "
          f"in {t_dry:.2f} s; launches {dry}")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "dag_rider_tpu_torch.graft_entry", "--mesh",
                           "virtual"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or "entry OK: 8" not in lines or not any(
            ln.startswith("dryrun_multichip OK: mesh=virtual Mesh(") for ln in lines):
        fail(f"J3: python -m dag_rider_tpu_torch.graft_entry --mesh virtual exited "
             f"{proc.returncode}: {proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    print(f"phase J3, python -m dag_rider_tpu_torch.graft_entry --mesh virtual: exit 0 in "
          f"{time.perf_counter() - t0:.2f} s; {' | '.join(lines)}")
    print(f"phase J wall: {time.perf_counter() - t_phase:.2f} s (budget {J_BUDGET_S:.0f} s)")
    return out


if __name__ == "__main__":
    sys.exit(main())
