#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one NVIDIA card.

Two paths, each through the hand-written CUDA kernels. The main path is
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
   and spill report;
2. builds the n = 256 registry, the device comb tables, and the signed
   rounds, with a seeded subset corrupted (bad signature bit, another
   vertex's signature, out-of-range source, s >= L, non-canonical R,
   missing signature, tampered block);
3. kernel phase: each kernel against its plain torch version on the card
   at the path's widths, exactly, timed with CUDA events beside the plain
   version and a lower bound on the card's time: the per-lane addition
   ``padd_xx`` (the tree's unit kernel), the one-launch comb tree
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
5. BLS phases: the cooperative ``padd381_xx`` against its plain version
   on real curve points at 1, 128, 4,096, 8,192 and 65,536 lanes, and
   ``horner381`` (the Horner chain and the canonical form in one launch)
   against its plain version on the coin's and the certificate's real
   window sums, exactly, timed beside their bounds; then, with the
   counters set to 0 before each and read after, one coin wave (sigma and
   leader byte-identical to the host coin), one wave with a corrupted
   share (the same ``filtered`` count, sigma and leader as the host coin),
   and one certificate (``agg_sig`` byte-identical to the host group law,
   and verified by the host pairing), each MSM with exactly 15 + log2 T
   ``padd381_xx`` launches and one ``horner381``; the MSM's wall time and
   its device split into tables, gather, tree and ``horner381``, launched
   from the host and replayed as a CUDA graph (the card's time alone);
6. prints ``{"kernels": [...]}``, the card line again, and as the last
   line ``{"ok": true, "device": {...}}``.

Any failure exits non-zero before the last line. Run it from the root of
the repository: ``python3 chip_smoke.py`` (one card, no arguments).
"""

from __future__ import annotations

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
MSM_REPEATS = 5

# Published H100 SXM peak memory rate (NVIDIA data sheet), used for the
# byte side of each kernel's bound.
HBM_BYTES_PER_S = 3.35e12
# Assumed int32 multiply-add rate: 64 lanes per SM per clock (Hopper's
# INT32 units) x the SM count x the card's maximum SM clock.
INT32_LANES_PER_SM_CLOCK = 64
IMAD_PER_PRODUCT = 22 * 22  # one general 22-limb schoolbook product


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


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        from dag_rider_tpu_torch.core.types import Block, Vertex, VertexID
        from dag_rider_tpu_torch.crypto import ed25519
        from dag_rider_tpu_torch.ops import comb, cuda_field, cuda_group as CG, field as F
        from dag_rider_tpu_torch.utils import build
        from dag_rider_tpu_torch.verifier.base import KeyRegistry, VertexSigner
        from dag_rider_tpu_torch.verifier.cpu import CPUVerifier
        from dag_rider_tpu_torch.verifier.cuda import CUDAVerifier, unpack
    except ImportError as exc:
        print(f"chip_smoke: the dag_rider_tpu_torch package is missing: {exc}",
              file=sys.stderr)
        return 2
    import dataclasses

    card = smi("name,power.limit")
    print(card)
    max_sm_mhz = float(smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    imad_per_s = INT32_LANES_PER_SM_CLOCK * sms * max_sm_mhz * 1e6
    print(f"bound model: {HBM_BYTES_PER_S / 1e12} TB/s; int32 IMAD "
          f"{INT32_LANES_PER_SM_CLOCK} x {sms} SMs x {max_sm_mhz:.0f} MHz = "
          f"{imad_per_s / 1e12:.2f} T/s")

    # -- build ------------------------------------------------------------
    t0, wall0 = time.perf_counter(), time.time()
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

    # -- set-up: registry, device tables, signed rounds ---------------------
    t0 = time.perf_counter()
    reg, seeds = KeyRegistry.generate(N_KEYS)
    signers = [VertexSigner(s) for s in seeds]
    t_keys = time.perf_counter() - t0
    ver = CUDAVerifier(reg)  # on the card: there is no other default
    dev = ver.device
    t0 = time.perf_counter()
    tables, b_tab = ver.comb_tables()
    torch.cuda.synchronize()
    t_tables = time.perf_counter() - t0
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
    flat_idx = rng.choice(total, N_CORRUPT, replace=False)
    corrupted = set()
    for k, fi in enumerate(flat_idx):
        r, i = divmod(int(fi), N_KEYS)
        v = rounds[r][i]
        sig = v.signature
        mode = k % 7
        if mode == 0:  # one flipped signature bit
            b = bytearray(sig)
            b[int(rng.integers(64))] ^= 1 << int(rng.integers(8))
            v = dataclasses.replace(v, signature=bytes(b))
        elif mode == 1:  # another vertex's signature
            v = dataclasses.replace(v, signature=rounds[r][(i + 1) % N_KEYS].signature)
        elif mode == 2:  # out-of-range source
            v = dataclasses.replace(v, id=VertexID(v.round, N_KEYS + i))
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
    print(f"set-up: keys {t_keys:.2f} s, device tables {t_tables:.2f} s "
          f"({tables.numel() * 4 / 2**20:.0f} MiB), signing {total} vertices "
          f"{t_sign:.2f} s, {len(corrupted)} corrupted")

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
    record("padd_xx", "dag_rider_tpu/ops/pallas_group.py:211", got, want,
           cuda_ms(lambda: CG.padd_xx(p, q), 20), cuda_ms(lambda: CG.padd_xx_plain(p, q), 3, 1),
           3 * 88 * 4 * half, half * (8 * IMAD_PER_PRODUCT + 22 * d2_nnz), half)

    # the whole comb tree in one launch: 2 * 4096 groups of 64 entries,
    # 63 additions each, read from the gather's own output
    acc = CG.tree_sum_xyzt(entries)
    acc_plain = comb.tree_sum_packed(entries)
    tree_adds = flat_n * (m - 1)
    record("tree_sum_xyzt", "dag_rider_tpu/ops/pallas_group.py:211", acc, acc_plain,
           cuda_ms(lambda: CG.tree_sum_xyzt(entries), 20),
           cuda_ms(lambda: comb.tree_sum_packed(entries), 2, 1),
           4 * (entries.numel() + acc.numel()),
           tree_adds * (8 * IMAD_PER_PRODUCT + 22 * d2_nnz), flat_n)
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
    launches = {**CG.LAUNCHES, **cuda_field.LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    print(f"path launches: {launches}")
    if (launches["tree_sum_xyzt"], launches["finish_check"], launches["padd_xx"]) != (1, 1, 0):
        fail(f"the dispatch launched {launches}; want one tree_sum_xyzt, one finish_check "
             f"and no padd_xx")
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
        t0 = time.perf_counter()
        again = ver.verify_rounds(rounds)
        walls.append(time.perf_counter() - t0)
        preps.append(ver.last_prepare_s)
        devs.append(ver.last_dispatch_s)
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

    report.extend(bls_phases(dev, imad_per_s))

    print(json.dumps({"kernels": report}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def msm_launches(sizes) -> dict:
    """Kernel launches of MSMs over ``sizes`` points: per MSM over T padded
    points, 15 table steps and the log2 T tree levels through padd381_xx,
    and the Horner chain with its canonical tail in one horner381."""
    from dag_rider_tpu_torch.ops import bls_msm

    ts = [bls_msm._pad(n) for n in sizes]
    return {"padd381_xx": sum(15 + t.bit_length() - 1 for t in ts), "horner381": len(ts)}


def bls_phases(dev, imad_per_s: float) -> list:
    """The BLS12-381 MSM path at n = 256 through ``padd381_xx`` and
    ``horner381``; returns their report rows. Fails on any mismatch."""
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
    t0 = time.perf_counter()
    ok = cv.verify_certificate(cert)
    verify_s = time.perf_counter() - t0
    if not ok:
        fail("the card-aggregated certificate does not verify")
    if cv.verify_certificate(dataclasses.replace(cert, signers=cert.signers[:-1])):
        fail("a certificate below quorum verified")
    print(f"certificate (n {BLS_N}, quorum {CERT_QUORUM}): agg_sig {cert.agg_sig.hex()[:16]}... "
          f"equal to the host group law; launches {cert_launches}; "
          f"make_certificate {make_wall * 1e3:.1f} ms; host pairing verify {verify_s:.2f} s")
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
    return [row, hrow]


if __name__ == "__main__":
    sys.exit(main())
