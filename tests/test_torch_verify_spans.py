"""The verify path's spans (``dag_rider_tpu_torch/obs/spans.py``).

A ``VerifierPipeline`` over ``CUDAVerifier(device="cpu")`` books one span
of each kind per chunk and one per request into the verifier's book; the
sub-spans of a chunk fit inside their parent; row blocks on the prep
pool book every block; every span the package opens is a known one;
with the profiler off no profiler range is entered, and under the
profiler the dispatching thread's spans are ranges of the trace carrying
the request's and the chunk's ids, while the process's ``TRACED`` book
also holds the spans of the prep engine's seam thread. The benchmark's
six readers of the spans read a synthetic window.
"""

import ast
import collections
import dataclasses
import sys
import threading
import types
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

from dag_rider_tpu_torch.core.types import Block, Vertex, VertexID
from dag_rider_tpu_torch.obs import spans
from dag_rider_tpu_torch.obs.spans import KNOWN_SPANS, SpanBook
from dag_rider_tpu_torch.verifier.base import KeyRegistry, VertexSigner
from dag_rider_tpu_torch.verifier.cpu import CPUVerifier
from dag_rider_tpu_torch.verifier.cuda import CUDAVerifier
from dag_rider_tpu_torch.verifier.pipeline import VerifierPipeline
from portbench import harness

N = 4
CHUNK = 16
PER_CHUNK = ("prep", "dispatch", "copy_in", "launch", "wait", "copy_out")
PREP_PARTS = ("prep.rows", "prep.checks", "prep.hash", "prep.pack")


def s(name):
    return "dagrider.verify." + name


@pytest.fixture(scope="module")
def keys():
    return KeyRegistry.generate(N)


@pytest.fixture(scope="module")
def tables(keys):
    return CUDAVerifier(keys[0], device="cpu").comb_tables()


@pytest.fixture(scope="module")
def pool(keys):
    """64 signed vertices, every fifth with a zeroed signature."""
    reg, seeds = keys
    signers = [VertexSigner(sd) for sd in seeds]
    out = []
    for j in range(4 * CHUNK):
        src = j % N
        v = Vertex(id=VertexID(1 + j // N, src), block=Block((b"tx%d" % j,)))
        v = signers[src].sign_vertex(v)
        if j % 5 == 4:
            v = dataclasses.replace(v, signature=bytes(64))
        out.append(v)
    return out


def pipe_over(keys, tables, depth, **attrs):
    v = CUDAVerifier(keys[0], device="cpu")
    v._tables = tables
    for k, val in attrs.items():
        setattr(v, k, val)
    return VerifierPipeline(v, depth=depth, fixed_bucket=CHUNK, warmup=False)


def test_depth2_request_books_each_span_once_a_chunk(keys, tables, pool):
    pipe = pipe_over(keys, tables, depth=2)
    assert pipe.spans is pipe.verifier.spans
    assert pipe.run_coalesced(pool) == CPUVerifier(keys[0]).verify_batch(pool)
    book = pipe.spans.totals()
    assert book[s("request")][1] == 1
    for name in PER_CHUNK + PREP_PARTS + ("prep_stall",):
        assert book[s(name)][1] == 4, name
    assert set(book) == KNOWN_SPANS
    # the prep span's wall time is the prep accounting, one timer
    assert pipe.verifier.total_prepare_s == pytest.approx(book[s("prep")][0], rel=1e-12)
    assert pipe.stats()["spans"] == book


def test_sub_spans_fit_in_their_parents(keys, tables, pool):
    pipe = pipe_over(keys, tables, depth=2)
    pipe.run_coalesced(pool)
    pipe.run_coalesced(pool[: 2 * CHUNK])
    book = {name: sec for name, (sec, _) in pipe.spans.totals().items()}
    assert sum(book[s(p)] for p in PREP_PARTS) <= book[s("prep")]
    assert book[s("copy_in")] + book[s("launch")] <= book[s("dispatch")]
    per_request = book[s("dispatch")] + book[s("wait")] + book[s("copy_out")]
    assert per_request + book[s("prep_stall")] <= book[s("request")]


def test_row_blocks_book_every_block(keys, tables, pool):
    """Four workers fill 64-row dispatches in four concurrent blocks each;
    the book counts every block of every chunk."""
    v = CUDAVerifier(keys[0], device="cpu")
    v._tables, v.prep_workers, v.fixed_bucket = tables, 4, 4 * CHUNK
    pipe = VerifierPipeline(v, depth=2, warmup=False)
    assert pipe.run_coalesced(pool + pool[:40]) == CPUVerifier(keys[0]).verify_batch(
        pool + pool[:40])
    eng = v._prep()
    blocks = len(eng.plan(64)) + len(eng.plan(64))  # 104 rows: 64 + 40 (a bucket of 64)
    assert blocks == 8 and eng.dispatches_parallel == 2
    book = v.spans.totals()
    for part in PREP_PARTS:
        assert book[s(part)][1] == blocks, part
    assert book[s("prep")][1] == 2


def test_book_loses_no_update_under_contention():
    book = SpanBook()
    threads, each = 16, 500
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [
            threading.Thread(target=lambda: [book.span("x").__enter__().__exit__()
                                             for _ in range(each)])
            for _ in range(threads)
        ]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(old)
    assert book.totals()["x"][1] == threads * each


def test_every_span_the_package_opens_is_known():
    root = Path(__file__).resolve().parents[1] / "dag_rider_tpu_torch"
    opened = set()
    for path in root.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "span"
                and node.args
                and isinstance(node.args[0], ast.Constant)
            ):
                opened.add(node.args[0].value)
    assert opened == KNOWN_SPANS


def test_profiler_off_enters_no_profiler_range(keys, tables, pool, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a profiler range was entered with the profiler off")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    pipe = pipe_over(keys, tables, depth=2)
    before = spans.TRACED.totals()
    assert pipe.run_coalesced(pool) == CPUVerifier(keys[0]).verify_batch(pool)
    assert pipe.spans.totals()[s("request")][1] == 1
    assert spans.TRACED.totals() == before


def _verify_events(prof):
    return [e for e in prof.profiler.kineto_results.events()
            if e.name().startswith("dagrider.verify.")]


def test_round_under_the_profiler_is_in_the_trace_with_its_ids(keys, tables, pool):
    """One chunk a request, prep inline: every span is on the dispatching
    thread, in the trace, with the request's and the chunk's ids, and a
    chunk's sub-spans lie inside their parent."""
    pipe = pipe_over(keys, tables, depth=2)
    pipe.run_coalesced(pool[:CHUNK])  # request 1, before the profiler
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        pipe.run_coalesced(pool[CHUNK : 2 * CHUNK])
    events = _verify_events(prof)
    assert {e.name() for e in events} == KNOWN_SPANS - {s("prep_stall")}
    assert {e.start_thread_id() for e in events} == {events[0].start_thread_id()}
    for e in events:
        assert e.kwinputs()["req"] == 2, e.name()
        if e.name() != s("request"):
            assert e.kwinputs()["chunk"] == 0, e.name()
    dur = collections.Counter()
    for e in events:
        dur[e.name()] += e.duration_ns()
    assert sum(dur[s(p)] for p in PREP_PARTS) <= dur[s("prep")]
    assert dur[s("copy_in")] + dur[s("launch")] <= dur[s("dispatch")]


def test_seam_thread_spans_reach_the_traced_book(keys, tables, pool):
    """Four chunks at depth 2: prep runs ahead on the seam thread, which
    the profiler does not record, yet its spans are in ``TRACED``."""
    pipe = pipe_over(keys, tables, depth=2)
    before = spans.TRACED.totals()
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        pipe.run_coalesced(pool)
    main = {(e.name(), e.kwinputs().get("chunk")) for e in _verify_events(prof)}
    for name in ("prep_stall", "dispatch", "copy_in", "launch", "wait", "copy_out"):
        assert {(s(name), k) for k in range(4)} <= main, name
    after = spans.TRACED.totals()
    for name in PER_CHUNK + PREP_PARTS + ("prep_stall",):
        got = after[s(name)][1] - before.get(s(name), (0.0, 0))[1]
        assert got == 4, name


def _ctx(**delta):
    return types.SimpleNamespace(delta=delta, trace=None)


READERS = {
    # metric: (booked spans {name: (seconds, count)}, window delta, reading)
    "prep_rows_us_per_sig": ({"prep.rows": (0.5, 8)}, {"prepared_sigs": 50_000}, 10.0),
    "prep_hash_us_per_sig": ({"prep.hash": (1.0, 8)}, {"prepared_sigs": 50_000}, 20.0),
    "prep_pack_us_per_sig": ({"prep.checks": (0.1, 8), "prep.pack": (0.15, 8)},
                             {"prepared_sigs": 50_000}, 5.0),
    "copy_in_ms_per_dispatch": ({"copy_in": (0.02, 40), "dispatch": (1.0, 40)}, {}, 0.5),
    "launch_ms_per_dispatch": ({"launch": (0.2, 40), "dispatch": (1.0, 40)}, {}, 5.0),
    "prep_stall_pct": ({"prep_stall": (3.0, 40)}, {"seam_s": 12.0}, 25.0),
}


@pytest.mark.parametrize("metric", sorted(READERS))
def test_span_readers_on_a_synthetic_window(metric, monkeypatch):
    booked, delta, want = READERS[metric]
    book = SpanBook()
    for name, (sec, count) in booked.items():
        for _ in range(count):
            book.add(s(name), sec / count)
    monkeypatch.setattr(spans, "TRACED", book)
    read = harness.reader(metric)
    assert read(_ctx(**delta), metric) == pytest.approx(want)
    # nothing booked, or a program without the span book: no reading
    monkeypatch.setattr(spans, "TRACED", SpanBook())
    assert read(_ctx(**delta), metric) is None
    monkeypatch.delitem(sys.modules, spans.__name__)
    assert read(_ctx(**delta), metric) is None
