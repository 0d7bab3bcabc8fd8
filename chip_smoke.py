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
   version and a lower bound on the card's time;
4. path phase: launch counters set to 0, one ``verify_rounds`` call, the
   counters read; the mask must equal the host oracle on the corrupted
   rows and a seeded sample of the valid ones, and the all-plain torch
   path on the card on every row; then the dispatch time (median of
   several, host prep and device split), sigs/s, peak device memory, and
   the device time split into copies, gather, tree and finish;
5. BLS phases: ``padd381_xx`` against its plain version on real curve
   points at 1, 4,096, 8,192 and 65,536 lanes, exactly, timed beside its
   bound; then, with the counters set to 0 before each and read after,
   one coin wave (sigma and leader byte-identical to the host coin), one
   wave with a corrupted share (the same ``filtered`` count, sigma and
   leader as the host coin), and one certificate (``agg_sig``
   byte-identical to the host group law, and verified by the host
   pairing); the MSM's wall time and its device split into tables,
   gather, tree, Horner and canonical;
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

    acc = CG.tree_sum_xyzt(entries)
    acc_plain = comb.tree_sum_packed(entries)
    if not torch.equal(acc, acc_plain):
        fail("tree_sum_xyzt (6 padd launches) disagrees with comb.tree_sum_packed")
    tree_ms = cuda_ms(lambda: CG.tree_sum_xyzt(entries), 5)
    print(f"tree_sum_xyzt: equal to the plain tree; {tree_ms:.3f} ms for 6 levels "
          f"(plain {cuda_ms(lambda: comb.tree_sum_packed(entries), 2, 1):.3f} ms)")

    got = CG.finish_check(x.r_y, x.r_sign, acc)
    want = CG.finish_check_plain(x.r_y, x.r_sign, acc)
    # finish: 285 general products + the D, SQRT_M1 and D2 constant products
    finish_imads = 285 * IMAD_PER_PRODUCT + 22 * (
        int((F.D != 0).sum()) + int((F.SQRT_M1 != 0).sum()) + d2_nnz)
    record("finish_check", "dag_rider_tpu/ops/pallas_group.py:273", got, want,
           cuda_ms(lambda: CG.finish_check(x.r_y, x.r_sign, acc), 20),
           cuda_ms(lambda: CG.finish_check_plain(x.r_y, x.r_sign, acc), 2, 1),
           (22 + 1 + 176 + 1) * 4 * total, total * finish_imads, total)

    zr = np.random.default_rng(SEED + 1)
    z = torch.from_numpy(zr.integers(-4095, 4096, (22, total), dtype=np.int32)).to(dev)
    got = CG.pow22523(z)
    record("pow22523", "dag_rider_tpu/ops/pallas_group.py:264", got, CG.pow22523_plain(z),
           cuda_ms(lambda: CG.pow22523(z), 20), cuda_ms(lambda: CG.pow22523_plain(z), 2, 1),
           2 * 22 * 4 * total, total * 262 * IMAD_PER_PRODUCT, total)

    a = torch.from_numpy(zr.integers(-4095, 4096, (total, 22), dtype=np.int32)).to(dev)
    b = torch.from_numpy(zr.integers(-4095, 4096, (total, 22), dtype=np.int32)).to(dev)
    got = cuda_field.mul(a, b)
    record("field_mul", "dag_rider_tpu/ops/pallas_field.py:43", got, cuda_field.mul_plain(a, b),
           cuda_ms(lambda: cuda_field.mul(a, b), 50), cuda_ms(lambda: cuda_field.mul_plain(a, b), 5),
           3 * 22 * 4 * total, total * IMAD_PER_PRODUCT, total)
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
    for name in ("padd_xx", "finish_check"):
        if launches[name] == 0:
            fail(f"the main path did not launch {name}")
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

    report.append(bls_phases(dev, imad_per_s))

    print(json.dumps({"kernels": report}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def msm_launches(t: int) -> int:
    """padd381_xx launches of one MSM over T points: 15 table steps, the
    log2 T tree levels, 64 x 5 Horner steps."""
    return 15 + t.bit_length() - 1 + 320


def bls_phases(dev, imad_per_s: float) -> dict:
    """The BLS12-381 MSM path at n = 256 through ``padd381_xx``; returns
    the kernel's report row. Fails on any mismatch."""
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
    # (4,096 and 8,192 lanes at n = 256), a doubling on one lane (as in the
    # Horner chain), and WIDE_LANES pairs drawn from the certificate's 4,096
    # table entries (1/16 of them the identity, 1/16 of the pairs doublings).
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
    operands[WIDE_LANES] = (flat[:, idx_p], flat[:, idx_q])
    widths = {}
    for lanes_n in sorted(operands):
        p, q = operands[lanes_n]
        got = G.padd381_xx(p, q)
        want = G.padd381_xx_plain(p, q)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max().item())
        ms = cuda_ms(lambda: G.padd381_xx(p, q), 50 if lanes_n < WIDE_LANES else 20)
        plain_ms = cuda_ms(lambda: G.padd381_xx_plain(p, q), 3, 1)
        b_ms, b_by = bound(3 * G.ROWS * 4 * lanes_n, imads_per_lane * lanes_n, imad_per_s)
        print(f"kernel padd381_xx: lanes {lanes_n}, equal {err == 0}, {ms:.4f} ms "
              f"(plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms by {b_by})")
        if err != 0:
            fail(f"padd381_xx disagrees with its plain version at {lanes_n} lanes "
                 f"(max abs err {err})")
        widths[lanes_n] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                           "bound_ms": b_ms, "bound_by": b_by}
    row = {"name": "padd381_xx", "route": "cuda", "source": G.SOURCE,
           "replaces": "dag_rider_tpu/ops/pallas_group381.py:150", "launches": None,
           **widths[cert_width], "library_ms": None, "lanes": cert_width,
           "widths": {str(k): v for k, v in widths.items()}}

    # -- coin path: n = 256, f + 1 = 86 shares, an honest and a Byzantine wave --
    def coin_wave(wave, want_sizes):
        """One wave through a card coin and a host coin; the card coin's
        MSMs must have the sizes ``want_sizes`` lists, in order, and the
        wave must launch exactly the additions those MSMs hold."""
        sizes = []

        def card_msm(scalars, points):
            sizes.append(len(points))
            return bls_msm.msm(scalars, points)

        host = ThresholdCoin(keys, 0, BLS_N)
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
        launches = G.LAUNCHES["padd381_xx"]
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
        want = sum(msm_launches(bls_msm._pad(n)) for n in want_sizes)
        if sizes != want_sizes or launches != want:
            fail(f"coin wave {wave}: MSMs of {sizes} points with {launches} padd381 "
                 f"launches, want {want_sizes} with {want}")
        print(f"coin wave {wave} (n {BLS_N}, threshold {BLS_THRESHOLD}): sigma "
              f"{card._sigma[wave].hex()[:16]}... and leader {leader} equal to the host "
              f"coin; filtered {card.filtered}; MSMs of {sizes} points, padd381 "
              f"launches {launches}; ready() "
              f"{wall * 1e3:.1f} ms on the card path, {host_wall * 1e3:.1f} ms host")
        return card.filtered, launches

    cert_t = msm_inputs["certificate"]["t"]
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
    cert_launches = G.LAUNCHES["padd381_xx"]
    host_cert = CertVerifier(reg, CERT_QUORUM, msm="host").make_certificate(7, entries)
    if cert is None or cert.agg_sig != host_cert.agg_sig:
        fail("certificate agg_sig differs from the host group law's")
    if cert_launches != msm_launches(cert_t):
        fail(f"certificate MSM launched padd381_xx {cert_launches} times, "
             f"want {msm_launches(cert_t)}")
    t0 = time.perf_counter()
    ok = cv.verify_certificate(cert)
    verify_s = time.perf_counter() - t0
    if not ok:
        fail("the card-aggregated certificate does not verify")
    if cv.verify_certificate(dataclasses.replace(cert, signers=cert.signers[:-1])):
        fail("a certificate below quorum verified")
    print(f"certificate (n {BLS_N}, quorum {CERT_QUORUM}): agg_sig {cert.agg_sig.hex()[:16]}... "
          f"equal to the host group law; padd381 launches {cert_launches}; "
          f"make_certificate {make_wall * 1e3:.1f} ms; host pairing verify {verify_s:.2f} s")
    row["launches"] = coin_launches + byz_launches + cert_launches
    print(f"bls path launches: coin {coin_launches}, Byzantine coin wave {byz_launches}, "
          f"certificate {cert_launches}")

    # -- MSM wall time and device split -----------------------------------------
    for name, m in msm_inputs.items():
        scalars, pts, t, nib, lm, tables, lanes = (
            m[k] for k in ("scalars", "points", "t", "nib", "lm", "tables", "lanes"))
        walls = []
        for _ in range(MSM_REPEATS):
            t0 = time.perf_counter()
            res = bls_msm.msm(scalars, pts)
            walls.append(time.perf_counter() - t0)
        if res != bls.g1_msm(scalars, pts):
            fail(f"{name} MSM differs from the host group law")
        w = G.tree_sum_xyz381(lanes, t)
        acc = bls_msm.horner_combine(w)
        xyz = torch.stack([acc[:F.LIMBS, 0], acc[F.LIMBS:2 * F.LIMBS, 0], acc[2 * F.LIMBS:, 0]])
        split = {
            "tables": cuda_ms(lambda: bls_msm._point_tables(lm), 5),
            "gather": cuda_ms(lambda: bls_msm.gather_windows(nib, tables), 5),
            "tree": cuda_ms(lambda: G.tree_sum_xyz381(lanes, t), 5),
            "horner": cuda_ms(lambda: bls_msm.horner_combine(w), 3, 1),
            "canonical": cuda_ms(lambda: F.canonical(xyz), 3, 1),
        }
        parts = ", ".join(f"{k} {v:.3f} ms" for k, v in split.items())
        print(f"{name} MSM (T = {t}, {len(pts)} points): wall median "
              f"{statistics.median(walls) * 1e3:.2f} ms (runs "
              f"{[round(x * 1e3, 2) for x in walls]} ms); device split (CUDA events): "
              f"{parts}; sum {sum(split.values()):.3f} ms")
    return row


if __name__ == "__main__":
    sys.exit(main())
