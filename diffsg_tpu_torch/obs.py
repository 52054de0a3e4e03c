"""Spans and counters of the serving path and its set-up.

A span is a name, a start and an end in ns, its own id, its parent's id (0:
none), the id of the ``Solver.solve`` call it belongs to (0: set-up) and a
few attributes. Spans are stamped with ``time.time_ns()``, the clock
``torch.profiler`` stamps its events on (an event starts at
``trace_start_ns() + time_range.start * 1000``), so a span lines up with a
profiler's trace; they are never profiler ranges themselves, so recording
adds no event to a trace.

Spans of a request (``solve`` and its children, :data:`PARENT`, which cover
it but for the call's own bookkeeping) are recorded
only while recording is on: after :func:`enable` until :func:`disable`, or
while a ``torch.profiler`` records. Off, a span costs one test of a flag,
with no clock read and no allocation. They are kept in a ring of the newest
:data:`RING`. Set-up spans (``load``, ``capture``, ``kernels.build``,
``kernels.load``) are few a Solver and always recorded, apart from the
ring. Counters (:func:`counters`) are always on, the kernel wrappers'
launches among them; a count made while a CUDA graph is captured
(:func:`count`) is kept for the replays to add (:func:`captured`, :func:`add`).

Example (an operator's look at a serving process):

    from diffsg_tpu_torch import obs
    obs.enable()
    solver.solve(X)
    for s in obs.spans():
        print(s.name, (s.end_ns - s.start_ns) / 1e6, "ms", s.attrs)
    print(obs.counters())
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler

#: Per-request spans kept (as plain tuples until read): the newest, in the
#: order their requests closed.
RING = 65_536
#: Set-up spans kept: the newest.
SETUP = 4_096

#: A request span's parent, by name; the root ``solve`` has none. Each name
#: occurs at most once in a request.
PARENT = {
    "solve.stage": "solve",         # entry to just before the program runs
    "stage.host": "solve.stage",    # the numpy work: pad, unnormalize, mask
    "stage.copy": "solve.stage",    # pinned copies into the program's inputs
    "stage.noise": "solve.stage",   # the generator's seed, zero_ and normal_
    "solve.launch": "solve",        # graph replay, capture or eager enqueue
    "solve.wait": "solve",          # the host waiting for the device
    "solve.copy": "solve",          # the answer copied to the host
}


class Span(NamedTuple):
    name: str
    start_ns: int                # time.time_ns()
    end_ns: int
    id: int
    parent: int                  # the parent's id; 0 for a root
    request: int                 # the solve call's id (its root's); 0 for set-up
    attrs: Dict


class Counters:
    """Totals of this process, from every Solver; plain integer adds."""

    __slots__ = ("requests", "rows", "bucket_rows", "replays", "captures", "eager", "bytes_in",
                 "bytes_out", "hoisted_steps", "x0_steps", "decode_candidates",
                 "resblock_launches", "mega_launches", "mega_row_launches")

    def __init__(self):
        for name in self.__slots__:
            setattr(self, name, 0)


#: requests: solve calls (and solve_chunked chunks); rows: their real rows;
#: bucket_rows: the rows the program computed, pad included; replays: graph
#: replays; captures: graphs captured, one at the first call of each
#: (bucket, configuration), so a count that rises while serving means a
#: per-request value reached the graphs' key; eager: programs run without a
#: graph; bytes_in: request data copied into the program's inputs (pinned on
#: a card); bytes_out: answers copied to the host; hoisted_steps: denoiser
#: steps that read the condition prologue and the time table of the fused
#: backend's prepared path (``models.unet1d_fused.FusedApplyFn``), run
#: eagerly or by a graph's replay; x0_steps: denoiser steps whose x0 or v
#: output the sampler turned into epsilon; decode_candidates: candidate rows
#: that a condition-reading decoder scored (``tasks.msr``'s families: 6
#: softmax temperatures, and 5 simplex projections besides where it selects
#: by projection); resblock_launches, mega_launches: launches of the
#: residual-block kernel (``ops.resblock``) and of the mega kernel
#: (``ops.mega``), eager or by a graph's replay; mega_row_launches: those of
#: the mega kernel's row-resident design (``ops.mega.mega_path``).
COUNTS = Counters()
#: The same counts made while a CUDA graph was captured: that work runs at
#: each replay, not then, so whoever replays the graph adds them.
CAPTURED = Counters()

_ids = itertools.count(1)
_ring: collections.deque = collections.deque(maxlen=RING)
_setup: collections.deque = collections.deque(maxlen=SETUP)
_enabled = False


class _Open(threading.local):
    def __init__(self):
        self.stack: List[int] = []   # the thread's open set-up spans, innermost last


_open = _Open()


def enable() -> None:
    """Record request spans until :func:`disable`."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Record request spans only while a ``torch.profiler`` records."""
    global _enabled
    _enabled = False


class Request:
    """The spans of one ``solve`` call, held until :meth:`close` puts them in
    the ring. The call's root starts when this is made."""

    __slots__ = ("id", "start_ns", "last_ns", "attrs", "_spans")

    def __init__(self):
        self.id = next(_ids)
        self.start_ns = self.last_ns = time.time_ns()   # last_ns: the last child's end
        self.attrs: Dict = {}    # the root's
        self._spans: List[tuple] = []

    def span(self, name: str, start_ns: int, **attrs) -> int:
        """Record ``name`` (a key of :data:`PARENT`) from ``start_ns`` to now;
        return now, the next span's start."""
        end = self.last_ns = time.time_ns()
        self._spans.append((name, start_ns, end, attrs))
        return end

    def annotate(self, name: str, **attrs) -> None:
        """Add attributes to the recorded span ``name``, outside its time."""
        next(a for n, _, _, a in self._spans if n == name).update(attrs)

    def close(self) -> None:
        """End the root now, after its children, and keep the request's spans."""
        end, rid = time.time_ns(), self.id
        ids = {"solve": rid}
        for span in self._spans:
            ids[span[0]] = next(_ids)
        _ring.append(("solve", self.start_ns, end, rid, 0, rid, self.attrs))
        for name, s, e, attrs in self._spans:
            _ring.append((name, s, e, ids[name], ids.get(PARENT[name], 0), rid, attrs))


def request() -> Optional[Request]:
    """A recorder for a new ``solve`` call while recording is on, else None."""
    return Request() if _enabled or _profiler._is_profiler_enabled else None


@contextlib.contextmanager
def setup(name: str, **attrs) -> Iterator[Dict]:
    """Record a set-up span around the block, always; the block may add to
    the attributes it is given. Its parent is the innermost set-up span open
    on this thread."""
    stack = _open.stack
    sid, parent = next(_ids), (stack[-1] if stack else 0)
    stack.append(sid)
    start = time.time_ns()
    try:
        yield attrs
    finally:
        stack.pop()
        _setup.append(Span(name, start, time.time_ns(), sid, parent, 0, attrs))


def spans() -> List[Span]:
    """The set-up spans, then the ring's request spans, each in the order
    they closed."""
    return [*_setup, *map(Span._make, _ring)]


def clear() -> None:
    """Empty the ring of request spans."""
    _ring.clear()


def count(name: str, n: int, like: torch.Tensor) -> None:
    """Add ``n`` to counter ``name``, or to :data:`CAPTURED` while the
    current stream of ``like``'s device captures a CUDA graph."""
    c = CAPTURED if like.is_cuda and torch.cuda.is_current_stream_capturing() else COUNTS
    setattr(c, name, getattr(c, name) + n)


def captured() -> Dict[str, int]:
    """A snapshot of :data:`CAPTURED`."""
    return {name: getattr(CAPTURED, name) for name in Counters.__slots__}


def add(counts: Dict[str, int]) -> None:
    """Add ``counts`` (a graph's captured counts, at its replay) to :data:`COUNTS`."""
    for name, n in counts.items():
        setattr(COUNTS, name, getattr(COUNTS, name) + n)


def counters() -> Dict[str, int]:
    """A snapshot of :data:`COUNTS`."""
    return {name: getattr(COUNTS, name) for name in Counters.__slots__}
