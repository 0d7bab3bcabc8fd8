"""Spans of the verify path: where a dispatch's host wall time goes.

One primitive times the blocks of host work on the port's verify path
(``verifier/cuda.py``, ``verifier/pipeline.py``): ``SpanBook.span(name,
**ids)``, a context manager that

- always adds the block's wall seconds and one count to its book under
  the book's lock (two ``perf_counter`` reads and a locked add, plus one
  check that the profiler is off);
- only while ``torch.profiler`` records on the calling thread, also makes
  the block a range of the profiler's trace, on the clock of the device
  trace, named ``name``, with the span's ids (the request's sequence
  number, the chunk's index) as its keyword inputs, which the trace keeps
  when the profiler records shapes. The range is a function-scope record,
  not a user annotation, so the profiler makes no device-side copy of it.

Each ``CUDAVerifier`` owns one book (``verifier.spans``); a
``VerifierPipeline`` books into the book of the verifier it wraps. The
spans are not ``slog`` events: at thousands of dispatches a second they
would overwrite the consensus trace ring within seconds.

Ids and the profiler's state cross threads with the work they time:
:func:`carry` takes the calling thread's span context and :func:`adopt`
puts it on the thread that does the work (the prep engine's seam thread,
its row-block pool). A span whose work was caused under the profiler is
also booked in the process's :data:`TRACED` book, whichever thread ran
it, so a traced window's totals include the threads the profiler does
not record.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Tuple

import torch

#: every span name of the verify path
KNOWN_SPANS = frozenset(
    {
        "dagrider.verify.request",
        "dagrider.verify.prep",
        "dagrider.verify.prep.rows",
        "dagrider.verify.prep.checks",
        "dagrider.verify.prep.hash",
        "dagrider.verify.prep.pack",
        "dagrider.verify.prep_stall",
        "dagrider.verify.dispatch",
        "dagrider.verify.copy_in",
        "dagrider.verify.launch",
        "dagrider.verify.wait",
        "dagrider.verify.copy_out",
    }
)

#: (ids, traced): a thread's span ids, and whether its work was caused
#: under the profiler
Context = Tuple[Dict[str, int], bool]


class _Here(threading.local):
    ids: Dict[str, int] = {}
    traced = False


_here = _Here()


def carry() -> Context:
    """The calling thread's span context, to hand to the thread that
    works on its behalf (:func:`adopt`)."""
    return _here.ids, _here.traced or torch.autograd._profiler_enabled()


class adopt:
    """Run the block under the span context ``ctx``. A class, not a
    generator, because it runs a few times a dispatch on the hot path."""

    __slots__ = ("_ctx", "_prev")

    def __init__(self, ctx: Context):
        self._ctx = ctx

    def __enter__(self) -> None:
        self._prev = _here.ids, _here.traced
        _here.ids, _here.traced = self._ctx

    def __exit__(self, *exc) -> None:
        _here.ids, _here.traced = self._prev


def tagged(**ids: int) -> adopt:
    """Run the block with ``ids`` added to the calling thread's span ids."""
    return adopt(({**_here.ids, **ids}, _here.traced))


class SpanBook:
    """Cumulative wall seconds and count per span name, thread-safe."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._book: Dict[str, list] = {}

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            entry = self._book.get(name)
            if entry is None:
                self._book[name] = [seconds, 1]
            else:
                entry[0] += seconds
                entry[1] += 1

    def span(self, name: str, **ids: int) -> "_Span":
        """Time the block as span ``name``; ``ids`` join the thread's."""
        return _Span(self, name, ids)

    def totals(self) -> Dict[str, Tuple[float, int]]:
        """span name -> (seconds, count), of the spans booked so far."""
        with self._lock:
            return {name: (s, n) for name, (s, n) in sorted(self._book.items())}

    def seconds(self, name: str) -> float:
        """Seconds booked so far under span ``name``."""
        with self._lock:
            return self._book.get(name, (0.0, 0))[0]


#: the process's spans whose work was caused under the profiler: what a
#: traced window of any verifier booked
TRACED = SpanBook()


class _Span:
    """One timed block; ``s`` holds its wall seconds once it has exited."""

    __slots__ = ("_book", "_name", "_ids", "_record", "_t0", "s")

    def __init__(self, book: SpanBook, name: str, ids: Dict[str, int]):
        self._book, self._name, self._ids = book, name, ids
        self.s = 0.0

    def __enter__(self) -> "_Span":
        self._record = None
        if torch.autograd._profiler_enabled():
            self._record = torch._C._profiler._RecordFunctionFast(
                self._name, (), {**_here.ids, **self._ids}
            )
            self._record.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.s = time.perf_counter() - self._t0
        if self._record is not None:
            self._record.__exit__(*exc)
        self._book.add(self._name, self.s)
        if self._record is not None or _here.traced:
            TRACED.add(self._name, self.s)
