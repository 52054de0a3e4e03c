"""The one traffic generator: requests from a traffic file and ``--seed``.

A traffic file is data (``benchmark/traffic/<name>.json``):

* ``"loop": "closed"``: one client sends ``rows`` rows, waits for the
  answer and sends again. Conditions come from a pool of ``pool`` batches
  drawn from the seed at set-up, in turn.
* ``"loop": "open"``: requests are due on a schedule whatever the server
  does: a Poisson stream of ``rate_per_s``, each request of ``rows_min`` to
  ``rows_max`` rows, log-uniform. The gaps and sizes come from
  ``base_seed``, so every ``--seed`` serves the same sizes at the same
  times; the seed draws the conditions and the noise.

Every request carries its own noise seed, drawn from ``--seed``.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, List, NamedTuple, Tuple

import numpy as np

Conditions = Callable[[np.random.Generator, int], np.ndarray]


class Request(NamedTuple):
    index: int
    rows: int
    due: float            # seconds after the loop's start (open loop; 0 closed)
    X: np.ndarray         # (rows, C) conditions in the task's scaled units
    noise_seed: int


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % 2 ** 64, *stream])


def noise_seed(seed: int, index: int) -> int:
    """A request's noise seed: 63 bits from (seed, index)."""
    return int(np.random.SeedSequence([seed % 2 ** 64, 7, index]).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


def closed_pool(traffic: Dict, seed: int, conditions: Conditions) -> List[np.ndarray]:
    return [conditions(_rng(seed, 1, b), traffic["rows"]) for b in range(traffic["pool"])]


def closed_requests(traffic: Dict, seed: int, pool: List[np.ndarray]) -> Iterator[Request]:
    """Request 0, 1, ... of a closed loop, without end."""
    j = 0
    while True:
        yield Request(j, traffic["rows"], 0.0, pool[j % len(pool)], noise_seed(seed, j))
        j += 1


def _base_stream(traffic: Dict, count: int) -> Tuple[np.ndarray, np.ndarray]:
    """``count`` arrival gaps (s) and request sizes from ``base_seed``."""
    rng = np.random.default_rng(traffic["base_seed"])
    gaps = rng.exponential(1.0 / traffic["rate_per_s"], count)
    lo, hi = np.log(traffic["rows_min"]), np.log(traffic["rows_max"] + 1)
    rows = np.minimum(np.exp(rng.uniform(lo, hi, count)).astype(int), traffic["rows_max"])
    return gaps, np.maximum(rows, traffic["rows_min"])


def open_schedule(traffic: Dict, seconds: float, seed: int, conditions: Conditions,
                  extra: int = 0) -> Tuple[List[Request], List[Request]]:
    """The requests due in ``[0, seconds)``, the first of the base stream
    that fit, and ``extra`` more from further along it, on a schedule of
    their own that starts at 0 (the traced span). The stream's sizes depend
    on ``extra``, so a run and a sweep pass the cell's ``profile_requests``."""
    mean_gap = 1.0 / traffic["rate_per_s"]
    count = int(seconds / mean_gap * 1.5) + 64
    while True:
        gaps, rows = _base_stream(traffic, count + extra)
        n_win = int(np.searchsorted(np.cumsum(gaps[:count]), seconds))
        if n_win < count:
            break
        count *= 2

    def build(sl: slice, first: int) -> List[Request]:
        g, r = gaps[sl], rows[sl]
        due = np.cumsum(g)
        return [Request(first + k, int(r[k]), float(due[k]),
                        conditions(_rng(seed, 3, first + k), int(r[k])),
                        noise_seed(seed, first + k)) for k in range(len(g))]

    window = build(slice(0, n_win), 0)
    profile = build(slice(count, count + extra), n_win)
    return window, profile
