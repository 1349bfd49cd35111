"""JSONL metrics logging for serving runs (port of repro/metrics/logger.py).

One line per step: {"step": n, "wall_s": t, "step_s": dt, **scalars}.
Values are converted with float() so 0-dim tensors are accepted.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricsLogger:
    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a", buffering=1)
        self._t0 = time.time()
        self._last = self._t0

    def log(self, step: int, **scalars) -> Dict[str, float]:
        now = time.time()
        rec = {"step": int(step), "wall_s": round(now - self._t0, 3),
               "step_s": round(now - self._last, 4)}
        self._last = now
        for k, v in scalars.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = str(v)
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
        return rec

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
