"""A bounded span of requests under ``torch.profiler``, reduced to a summary.

Only the reduction is kept, never the whole trace: the device's busy time
(the union of every operation it ran), each device operation's count and
time by name (as ``diffsg_tpu_torch.tools.profile_sampler.device_ops``
reads them), the number of kernels, and the idle gaps, each named by what
the host was doing then.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, List, NamedTuple, Tuple

import numpy as np

REQUEST, WAIT = "bench.request", "bench.wait"
#: Gaps shorter than this are the launch gaps between one program's kernels.
SHORT_GAP_US = 20.0
SHORT_GAP = "between kernels (gaps < 20 us)"


class TraceSummary(NamedTuple):
    window_s: float                       # first request's start to last one's end
    busy_s: float                         # union of the device's operations in it
    device_ops: Dict[str, Tuple[int, float]]   # name -> (count, seconds)
    kernels: int                          # device operations that are not copies or sets
    idle_gaps: Dict[str, float]           # what the host was doing -> idle seconds
    requests: int


def profile(fn: Callable[[Callable], object], device) -> Tuple[object, TraceSummary]:
    """Run ``fn(span)`` under the profiler; ``span(name)`` is the context
    that marks a request (``REQUEST``) or a wait (``WAIT``)."""
    import torch
    from torch.profiler import ProfilerActivity, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        out = fn(record_function)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    return out, reduce_events(prof.events(), device.type)


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def reduce_events(events, device_type: str) -> TraceSummary:
    """The summary of a profiler's events (``prof.events()``)."""
    import torch

    dev_kind = torch.autograd.DeviceType.CUDA if device_type == "cuda" else None
    host, dev, reqs = [], [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == dev_kind:
            if e.name not in (REQUEST, WAIT):   # the marks' own copies on the device timeline
                dev.append((s, t, e.name))
        elif e.name == REQUEST:
            reqs.append((s, t))
        else:
            host.append((s, t, e.name))
    if not reqs:
        raise RuntimeError("the profiled span holds no request")
    w0, w1 = min(r[0] for r in reqs), max(r[1] for r in reqs)
    ops: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for s, t, name in dev:
        ops[name][0] += 1
        ops[name][1] += (t - s) * 1e-6
    busy, gaps = _busy_and_gaps([(s, t) for s, t, _ in dev], w0, w1)
    return TraceSummary((w1 - w0) * 1e-6, busy * 1e-6,
                        {k: (int(v[0]), v[1]) for k, v in ops.items()},
                        sum(1 for *_, n in dev if not _is_copy(n)),
                        _name_gaps(gaps, host), len(reqs))


def _busy_and_gaps(intervals, w0: float, w1: float) -> Tuple[float, List[Tuple[float, float]]]:
    """Busy microseconds in [w0, w1] and the idle gaps there."""
    busy, gaps, cursor = 0.0, [], w0
    for s, t in sorted(intervals):
        s, t = max(s, w0), min(t, w1)
        if t <= cursor:
            continue
        if s > cursor:
            gaps.append((cursor, s))
            cursor = s
        busy += t - cursor
        cursor = t
    if cursor < w1:
        gaps.append((cursor, w1))
    return busy, gaps


def _name_gaps(gaps, host) -> Dict[str, float]:
    """Idle seconds by what the host was doing: the innermost host event
    that covers most of each gap (a gap no event covers: "untraced host")."""
    out: Dict[str, float] = defaultdict(float)
    if host:
        hs = np.array([h[0] for h in host])
        ht = np.array([h[1] for h in host])
        names = [h[2] for h in host]
    for g0, g1 in gaps:
        if g1 - g0 < SHORT_GAP_US:
            out[SHORT_GAP] += (g1 - g0) * 1e-6
            continue
        name = "untraced host"
        if host:
            over = np.minimum(ht, g1) - np.maximum(hs, g0)
            best = over.max()
            if best > 0:
                cand = np.flatnonzero(over >= 0.9 * best)
                name = names[cand[np.argmin((ht - hs)[cand])]]
        out[name] += (g1 - g0) * 1e-6
    return dict(out)


def top(d: Dict[str, float], k: int = 10) -> List[list]:
    """The ``k`` largest entries as [name, value] pairs."""
    return [[n[:200], v] for n, v in sorted(d.items(), key=lambda kv: -kv[1])[:k]]
