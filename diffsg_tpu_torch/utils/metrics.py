"""Structured metrics logging.

Counterpart of ``diffsg_tpu/utils/metrics.py::MetricsLogger``: each record
goes as one JSON line to a file (and to standard output), with the seconds
since the logger was made, so that training logs and eval reports are
machine-readable.
"""

from __future__ import annotations

import json
import pathlib
import time
from typing import Dict, Optional


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, also_print: bool = True):
        self.path = pathlib.Path(path) if path else None
        self.also_print = also_print
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)
        self._t0 = time.time()

    def log(self, record: Dict, **kw) -> Dict:
        rec = dict(record, **kw)
        rec.setdefault("elapsed_s", round(time.time() - self._t0, 3))
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec, default=float) + "\n")
        if self.also_print:
            print(json.dumps(rec, default=float))
        return rec
