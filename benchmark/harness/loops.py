"""The serving loops: a closed loop and an open loop with one blocking server.

``serve(request)`` returns the request's answer on the host. Every request
gets a span around that call; an open-loop request's latency runs from the
time it was due, so a stall delays every request queued behind it.
"""

from __future__ import annotations

import contextlib
import sys
import time
import traceback
from typing import Callable, ContextManager, Iterable, Iterator, List, NamedTuple, Optional

import numpy as np

from .traffic import Request

#: How long past the window the open loop keeps serving a backlog.
DRAIN_S = 60.0
#: ``span(name)``: a context around a request ("bench.request") or a wait
#: ("bench.wait"); the traced span passes the profiler's ``record_function``.
Span = Callable[[str], ContextManager]


def no_span(name: str) -> ContextManager:
    return contextlib.nullcontext()


class Done(NamedTuple):
    index: int
    rows: int
    due: float            # absolute times, time.perf_counter()
    start: float
    end: float
    ok: bool
    answer: Optional[np.ndarray]


def _call(serve: Callable[[Request], np.ndarray], r: Request, span: Span) -> tuple:
    try:
        with span("bench.request"):
            return serve(r), True
    except Exception:  # a failed request is counted, the run goes on
        traceback.print_exc(file=sys.stderr)
        return None, False


def closed_loop(serve: Callable[[Request], np.ndarray], requests: Iterator[Request],
                seconds: float, keep: bool = True, span: Span = no_span,
                count: Optional[int] = None) -> tuple:
    """Serve requests back to back while the window is open; the window
    closes when the last request started in it has its answer (``count``:
    serve that many instead). Returns (list of Done, the window's seconds)."""
    done: List[Done] = []
    t0 = time.perf_counter()
    while (len(done) < count) if count is not None else (time.perf_counter() - t0 < seconds):
        r = next(requests)
        start = time.perf_counter()
        out, ok = _call(serve, r, span)
        done.append(Done(r.index, r.rows, start, start, time.perf_counter(), ok,
                         out if keep else None))
    return done, done[-1].end - t0


def wait_until(t: float) -> None:
    """Sleep to just before ``t``, then spin to it."""
    while True:
        left = t - time.perf_counter()
        if left <= 0:
            return
        if left > 0.002:
            time.sleep(left - 0.001)


def open_loop(serve: Callable[[Request], np.ndarray], requests: Iterable[Request],
              seconds: float, keep: bool = True, span: Span = no_span) -> tuple:
    """Serve each request at its due time, or as soon as the server is free.
    Requests still waiting ``DRAIN_S`` after the window's end fail unserved.
    Returns (list of Done, the window's seconds: ``seconds`` or, with a
    backlog, until the last answer)."""
    done: List[Done] = []
    t0 = time.perf_counter()
    for r in requests:
        due = t0 + r.due
        if time.perf_counter() > t0 + seconds + DRAIN_S:
            done.append(Done(r.index, r.rows, due, due, time.perf_counter(), False, None))
            continue
        with span("bench.wait"):
            wait_until(due)
        start = time.perf_counter()
        out, ok = _call(serve, r, span)
        done.append(Done(r.index, r.rows, due, start, time.perf_counter(), ok,
                         out if keep else None))
    end = max([d.end for d in done] + [t0 + seconds])
    return done, end - t0


def generator_lateness_s(done: List[Done]) -> List[float]:
    """How late each request that found the server idle was started: the
    generator's own delay, apart from any queue."""
    late, free_at = [], -np.inf
    for d in done:
        if free_at <= d.due:
            late.append(d.start - d.due)
        free_at = d.end
    return late
