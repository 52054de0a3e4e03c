"""The program's own spans (``diffsg_tpu_torch.obs``), as the readers of the
serve layer's and set-up's metrics take them.

The program records a request's spans only while a ``torch.profiler``
records, so those in its ring are the traced span's: the last
``run.profile.requests`` ``solve`` roots and their children. Set-up spans
are always recorded; a run's are its Solver's ``load`` (the last one) and
every set-up span after it. A program without ``obs`` has no spans, and
every reader then returns None.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def _spans() -> Optional[list]:
    try:
        from diffsg_tpu_torch import obs
    except ImportError:
        return None
    return obs.spans()


def ms(span) -> float:
    return (span.end_ns - span.start_ns) / 1e6


def requests(run) -> Optional[List[Dict]]:
    """Each traced request's spans by name, in the order they were served."""
    spans = _spans() if run.profile is not None else None
    if not spans:
        return None
    roots = [s for s in spans if s.name == "solve"][-run.profile.requests:]
    by_request = {r.request: {} for r in roots}
    for s in spans:
        if s.request in by_request:
            by_request[s.request][s.name] = s
    return [by_request[r.request] for r in roots] or None


def median_ms(run, name: str) -> Optional[float]:
    """Median over the traced requests of span ``name``'s milliseconds."""
    reqs = requests(run)
    got = [ms(r[name]) for r in reqs or () if name in r]
    return float(np.median(got)) if got else None


def setup() -> Optional[list]:
    """The run's set-up spans: its last ``load`` and every set-up span after."""
    spans = _spans()
    loads = [s for s in spans or () if s.name == "load"]
    if not loads:
        return None
    return [s for s in spans if s.request == 0 and s.start_ns >= loads[-1].start_ns]
