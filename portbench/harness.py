"""One run of one cell: set-up, the measured window over the program's
verify entry, the trace, and the judgement of every mask the window
produced.

The entry the window drives is ``VerifierPipeline.run_coalesced`` over
one ``CUDAVerifier`` with the program's defaults. Each request is handed
in when the previous mask has returned (one closed-loop caller, as a node
verifies what it admits), and is timed from hand-in to mask. The pool of
signed rows is made once from the seed (``workgen``) and replayed.

After the window the plain reference (``ed25519_ref``, in spawn workers)
gives the verdict of every pool row, and every row of every request the
window handed in is compared with it.
"""

from __future__ import annotations

import gc
import importlib.util
import math
import multiprocessing as mp
import os
import resource
import sys
import time
import types
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

from portbench import devtrace, workgen

METRICS_DIR = Path(__file__).resolve().parent / "metrics"


def log(*parts) -> None:
    print("portbench:", *parts, file=sys.stderr, flush=True)


def reader(name: str) -> Callable:
    """The ``read(ctx, name)`` of metric ``name``, in ``metrics/<name>.py``."""
    path = METRICS_DIR / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no reader for metric {name!r} under {METRICS_DIR}")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def port_program(registry, chunk: int, device: str):
    """The system under test: the program's verify window over one
    verifier, every knob at its default, dispatches of ``chunk`` rows."""
    from dag_rider_tpu_torch.verifier.cuda import CUDAVerifier
    from dag_rider_tpu_torch.verifier.pipeline import VerifierPipeline

    verifier = CUDAVerifier(registry, device=device)
    verifier.comb_tables()
    return VerifierPipeline(verifier, fixed_bucket=chunk)


def counters(pipe) -> Dict[str, float]:
    """The program's own counters that the checks and readers use."""
    v = getattr(pipe, "verifier", None)
    native = sys.modules.get("dag_rider_tpu_torch.utils.native")
    hashed = dict(native.ROWS_HASHED) if native is not None else {}
    return {
        "wait_s": pipe.wait_s,
        "seam_s": pipe.seam_s,
        "dispatches": pipe.dispatches,
        "sigs_dispatched": pipe.sigs_dispatched,
        "contained": pipe.poisoned_windows + pipe.quarantined
        + getattr(v, "poisoned_windows", 0) + getattr(v, "quarantined_chunks", 0),
        "prepare_s": getattr(v, "total_prepare_s", 0.0),
        "prepared_sigs": getattr(v, "total_sigs_dispatched", 0),
        "rows_native": hashed.get("native", 0),
        "rows_hashlib": hashed.get("hashlib", 0),
    }


def traced(fn: Callable, name: str) -> Callable:
    import torch

    def call(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)

    return call


class _PrepFuture:
    """A prep future whose ``result()`` (the window waiting for a chunk's
    host prep, which runs on the prep engine's thread) is a host span."""

    def __init__(self, fut, name: str):
        self._fut, self._name = fut, name

    def result(self, *args, **kwargs):
        import torch

        with torch.profiler.record_function(self._name):
            return self._fut.result(*args, **kwargs)


def add_spans(pipe) -> None:
    """Host spans around the calls into the verifier's layers (prep, the
    copy and launch, the wait for the mask), for the trace."""
    v = pipe.verifier
    for attr, name in (("prep_batch", "prep"), ("dispatch_prepped", "dispatch"),
                       ("resolve_batch", "wait")):
        setattr(v, attr, traced(getattr(v, attr), devtrace.SPAN_PREFIX + name))
    submit = v.prep_batch_async
    v.prep_batch_async = lambda chunk: _PrepFuture(submit(chunk), devtrace.SPAN_PREFIX + "prep")


def nearest_rank(values: Sequence[float], q: float) -> float:
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q * len(ordered)) - 1)]


def _pool(workers: int) -> ProcessPoolExecutor:
    return ProcessPoolExecutor(max_workers=workers, mp_context=mp.get_context("spawn"))


def workers_for(n: int) -> int:
    """Spawn workers for signing and the reference: a core is left to the
    main process."""
    return max(1, min(8, (os.cpu_count() or 2) - 1, n))


def host_sample() -> Dict[str, float]:
    """This process's CPU seconds, and the machine's stolen and total CPU
    ticks (``/proc/stat``, where it exists)."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    out = {"cpu_s": ru.ru_utime + ru.ru_stime, "steal_ticks": 0, "ticks": 0}
    try:
        with open("/proc/stat") as fh:
            ticks = [int(x) for x in fh.readline().split()[1:]]
        out["steal_ticks"], out["ticks"] = (ticks[7] if len(ticks) > 7 else 0), sum(ticks)
    except OSError:
        pass
    return out


def rate_by_slice(lat: Sequence[float], rows_per_request: int, start: float,
                  slice_s: float = 5.0) -> List[float]:
    """Rows a second completed in each ``slice_s`` of the window (the last,
    partial slice left out): how the host's pace moved over the run."""
    done, t, out = 0, start, []
    edge = start + slice_s
    for dt in lat:
        t += dt
        while t >= edge:
            out.append(done / slice_s)
            done, edge = 0, edge + slice_s
        done += rows_per_request
    return out


def drive(pipe, reqs: List[list], seconds: float, span: Optional[str] = None):
    """The closed loop: hand in request k + 1 when request k's mask is back,
    until ``seconds`` have passed; each request in the host span ``span``
    when one is named. Returns (masks, latencies, start, end) on the
    perf_counter clock."""
    masks, lat = [], []
    call = pipe.run_coalesced if span is None else traced(pipe.run_coalesced, span)
    start = now = time.perf_counter()
    deadline = start + seconds
    k = 0
    while now < deadline:
        masks.append(call(reqs[k % len(reqs)]))
        done = time.perf_counter()
        lat.append(done - now)
        now = done
        k += 1
    return masks, lat, start, now


def run(cell: workgen.Cell, e2e: Sequence[dict], per_layer: Sequence[dict], seed: int,
        seconds: float, trace: bool, device: str = "cuda", program: Callable = port_program,
        t0: Optional[float] = None) -> dict:
    """One run of ``cell``. Returns the result line's object; the checks
    come last under ``checks``."""
    t0 = time.perf_counter() if t0 is None else t0
    pool = _pool(workers_for(cell.config["n"]))
    try:
        return _run(cell, e2e, per_layer, seed, seconds, trace, device, program, t0, pool)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def _run(cell, e2e, per_layer, seed, seconds, trace, device, program, t0, pool) -> dict:
    cfg, traffic = cell.config, cell.traffic
    n = cfg["n"]
    # signing runs in spawn workers while this process imports the program
    workers = workers_for(n)
    shares = workgen.shares(n, workers)
    sign_futs = [pool.submit(workgen.sign_sources, seed, cfg, share) for share in shares]
    parts: Dict[str, float] = {}
    mark = [t0]

    def part(name: str) -> None:
        now = time.perf_counter()
        parts[name] = now - mark[0]
        mark[0] = now

    import torch

    from dag_rider_tpu_torch import config as program_config
    from dag_rider_tpu_torch.core.types import Block, Vertex, VertexID
    from dag_rider_tpu_torch.utils import native
    from dag_rider_tpu_torch.verifier.base import KeyRegistry

    for knob, value in cfg.get("knobs", {}).items():
        if knob not in program_config.KNOBS or os.environ.get(knob) != value:
            raise ValueError(f"knob {knob}={value!r}: not a knob of the program, or not set "
                             "before the program was imported")
    part("imports")
    if device == "cuda":
        torch.cuda.init()
        torch.empty(1, device=device)
    part("context")

    rows = workgen.pool_rows(seed, cfg)
    part("inputs")

    pubs: Dict[int, bytes] = {}
    sigs: Dict[tuple, bytes] = {}
    for fut in sign_futs:
        p, s = fut.result()
        pubs.update(p)
        sigs.update(s)
    pool.shutdown()
    part("signing")

    registry = KeyRegistry(tuple(pubs[i] for i in range(n)))
    chunk = workgen.chunk_rows(cfg, traffic)
    native.reset_rows()
    pipe = program(registry, chunk, device)
    part("tables_warmup")

    rounds = range(1, cfg["pool_rounds"] + 1)
    strong = {r: tuple(VertexID(*e) for e in workgen.strong_edges(cfg, r)) for r in rounds}
    weak = {r: tuple(VertexID(*e) for e in workgen.weak_edges(cfg, r)) for r in rounds}
    vertices = []
    for row in rows:
        v = Vertex(id=VertexID(row.rnd, row.source), block=Block(workgen.transactions(cfg, row.data)),
                   strong_edges=strong[row.rnd], weak_edges=weak[row.rnd],
                   signature=sigs[(row.rnd, row.source)], coin_share=row.share or None)
        v.digest()  # admission leaves the digest (and the signing bytes) computed
        vertices.append(v)
    reqs = [[vertices[i] for i in req] for req in workgen.requests(cfg, traffic)]
    fp = workgen.fingerprint(cfg, traffic, [len(v.signing_bytes()) for v in vertices],
                             [r.corrupted for r in rows])
    log("fingerprint", fp)
    gc.collect()
    gc.freeze()  # the pool is the benchmark's input, not the program's state
    part("vertices")

    drive(pipe, reqs, traffic["warm_s"])
    prof = None
    if trace:
        add_spans(pipe)
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
        prof = profile(activities=acts)
        prof.start()
    part("warm_traffic")
    setup_s = time.perf_counter() - t0
    log("setup_s", setup_s, "parts", parts)

    before = counters(pipe)
    host0 = host_sample()
    ns0 = time.time_ns()
    masks, lat, start, end = drive(pipe, reqs, seconds,
                                   devtrace.SPAN_PREFIX + "request" if trace else None)
    ns1 = time.time_ns()
    host1 = host_sample()
    after = counters(pipe)
    window_s = end - start
    tr = None
    if prof is not None:
        if device == "cuda":
            torch.cuda.synchronize()
        prof.stop()
        tr = devtrace.from_profiler(prof, ns0, ns1)
        del prof
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    delta = {k: after[k] - before[k] for k in after}

    # free the program's state before the reference runs
    del pipe, vertices, reqs
    gc.unfreeze()
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = reference(seed, cfg, pubs, sigs, workers, shares)
    log("reference_s", time.perf_counter() - t_ref)
    expected = [[ref[(rows[i].rnd, rows[i].source)] for i in req]
                for req in workgen.requests(cfg, traffic)]
    wrong = short = failed = 0
    for k, mask in enumerate(masks):
        want = expected[k % len(expected)]
        bad = sum(a != b for a, b in zip(mask, want))
        missing = max(0, len(want) - len(mask))
        wrong += bad
        short += missing
        failed += bad + missing + max(0, len(mask) - len(want)) > 0
    handed = sum(len(expected[k % len(expected)]) for k in range(len(masks)))
    want_dispatches = len(masks) * fp["dispatches_per_request"]
    checks = {
        "mismatched_rows": {"value": wrong, "limit": 0},
        "unanswered_rows": {"value": short, "limit": 0},
        "hashlib_rows": {"value": after["rows_hashlib"], "limit": 0},
        "contained_faults": {"value": after["contained"], "limit": 0},
        "dispatch_gap": {"value": abs(delta["dispatches"] - want_dispatches)
                         + abs(delta["sigs_dispatched"] - handed), "limit": 0},
    }
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    log("latency_ms p50", nearest_rank(lat, 0.5) * 1e3, "p95", nearest_rank(lat, 0.95) * 1e3,
        "samples", len(lat), "rows", handed, "window_s", window_s)
    log("prep_us_per_sig", 1e6 * delta["prepare_s"] / max(1, delta["prepared_sigs"]),
        "wait_s", delta["wait_s"], "seam_s", delta["seam_s"])
    ticks = max(1, host1["ticks"] - host0["ticks"])
    log("host over the window: cpu_s", host1["cpu_s"] - host0["cpu_s"],
        "steal_pct", 100.0 * (host1["steal_ticks"] - host0["steal_ticks"]) / ticks)
    log("rows_per_s by 5 s of the window",
        [round(r) for r in rate_by_slice(lat, fp["rows_per_request"], start)])

    ctx = types.SimpleNamespace(
        cell=cell.name, config=cfg, traffic=traffic, fingerprint=fp, latencies_s=lat,
        window_s=window_s, rows=handed, requests=len(masks), setup_s=setup_s, delta=delta,
        trace=tr)
    metrics = {}
    for m in (per_layer if trace else e2e):
        value = reader(m["name"])(ctx, m["name"])
        if value is None:
            if not trace:
                raise RuntimeError(f"end-to-end metric {m['name']} has no reading")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": len(masks), "failed": failed,
           "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = devtrace.busy_s(tr)
        dev["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": devtrace.device_ops(tr),
                            "idle_gaps": devtrace.idle_by_span(tr)}
    out["checks"] = checks
    return out


def reference(seed: int, cfg: dict, pubs: Dict[int, bytes], sigs: Dict[tuple, bytes],
              workers: int, shares: List[List[int]]) -> Dict[tuple, bool]:
    """The plain reference's verdict of every pool row, from the
    benchmark's own inputs, in spawn workers."""
    out: Dict[tuple, bool] = {}
    with _pool(workers) as pool:
        futs = []
        for share in shares:
            keep = set(share)
            futs.append(pool.submit(
                workgen.verdicts, seed, cfg, share, {s: pubs[s] for s in share},
                {k: v for k, v in sigs.items() if k[1] in keep}))
        for fut in futs:
            out.update(fut.result())
    return out
