"""Spans and counters of the sweep path, on the profiler's clock.

Tracing is on exactly while a ``torch.profiler`` session is recording
(``torch.autograd.profiler._is_profiler_enabled``); there is no other
switch. While it is on:

* :func:`span` opens a profiler range of its name (a record function, as
  ``torch.profiler.record_function`` opens), so the span's host event
  shares Kineto's clock with the kernels and the profiler records its
  parent span. It also adds its wall time to
  ``SPANS[name] = [count, total_ns, self_ns]``, self being the total less
  the time of the spans opened inside it.
* :func:`count` adds to ``COUNTS[name]``.

While it is off, :func:`span` is one flag read that returns a shared no-op
context, and :func:`count` returns at once: neither opens a range. Single
spans are not stored here; they live on the profiler's timeline
(``prof.export_chrome_trace``). :func:`reset` clears both tables. The spans
nest on one stack: the sweep path runs on one thread.

The names the sweep path uses are listed in docs/experiments.md
("Tracing"); besides them, ``run_sweep`` counts ``sweep.trace_digests``,
one a distinct trace object whose arrays it hashes for its cells' keys.
"""
from __future__ import annotations

import contextlib
import functools
import time

import torch
import torch.autograd.profiler as _profiler

#: name -> [count, total_ns, self_ns] of the spans closed while tracing
SPANS: dict[str, list[int]] = {}
#: name -> count, added to while tracing
COUNTS: dict[str, int] = {}

_OPEN: list["_Span"] = []
_OFF = contextlib.nullcontext()
#: The range a span opens: torch's C record function, the one its compiled
#: code opens. On an H100's host it costs 1.6 us a range, where the Python
#: ``record_function`` costs 11 us and leaves a copy of the range on the
#: device's timeline.
_record = torch._C._profiler._RecordFunctionFast


def reset() -> None:
    SPANS.clear()
    COUNTS.clear()


class _Span:
    __slots__ = ("name", "child_ns", "_rf", "_t0")

    def __init__(self, name: str):
        self.name = name

    # The clock is read outside the record_function, so that the table's
    # time holds the profiler's own cost of the span, as the window does.
    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter_ns()
        self.child_ns = 0
        _OPEN.append(self)
        self._rf = _record(self.name)
        self._rf.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._rf.__exit__(*exc)
        dt = time.perf_counter_ns() - self._t0
        _OPEN.pop()
        if _OPEN:
            _OPEN[-1].child_ns += dt
        row = SPANS.get(self.name)
        if row is None:
            row = SPANS[self.name] = [0, 0, 0]
        row[0] += 1
        row[1] += dt
        row[2] += dt - self.child_ns


def span(name: str):
    """A context that times ``name`` while tracing, and does nothing
    otherwise."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def spanned(name: str):
    """Decorate a function so that each call runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to ``COUNTS[name]`` while tracing."""
    if _profiler._is_profiler_enabled:
        COUNTS[name] = COUNTS.get(name, 0) + n


def wait(t: torch.Tensor) -> None:
    """While tracing, a ``sweep.wait`` span in which the host waits for the
    work queued on ``t``'s stream (nothing to wait for on the CPU), so that
    the copy to the host after it times host work alone. Off, the copy
    waits as it always did; the results and their order are the same."""
    if not _profiler._is_profiler_enabled:
        return
    with _Span("sweep.wait"):
        if t.is_cuda:
            torch.cuda.current_stream(t.device).synchronize()
