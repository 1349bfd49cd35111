"""JSONL metrics logging for training and serving runs (port of
repro/metrics/logger.py).

One line per step: {"step": n, "wall_s": t, "step_s": dt, **scalars}.
Values are converted with float() so 0-dim tensors are accepted. A
rolling window of the last `window` losses gives the smoothed console
summary.
"""
from __future__ import annotations

import collections
import json
import os
import time
from typing import Dict, Iterator, Optional


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, *, window: int = 20):
        self.path = path
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a", buffering=1)
        self._t0 = time.time()
        self._last = self._t0
        self._window = collections.deque(maxlen=window)

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
        if "loss" in rec:
            self._window.append(rec["loss"])
        return rec

    @property
    def smoothed_loss(self) -> Optional[float]:
        """Mean loss over the last `window` logged steps (None before
        the first)."""
        if not self._window:
            return None
        return sum(self._window) / len(self._window)

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_metrics(path: str) -> Iterator[dict]:
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)
