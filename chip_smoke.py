#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA card.

The main path is round signature verification: a committee of n = 256
validators, 16 DAG rounds of 256 signed vertices (171 strong edges each),
verified by ``CUDAVerifier.verify_rounds`` as one merged 4,096-signature
dispatch through the hand-written CUDA kernels. The script:

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
5. prints ``{"kernels": [...]}``, the card line again, and as the last
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
    t0 = time.perf_counter()
    build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc {build.last_build_s:.1f} s)")
    for line in build.ptxas_report("ed25519_group"):
        print(f"  ptxas: {line}")

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

    print(json.dumps({"kernels": report}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
