"""Metrics sink and step timing.

Port of ``MetricLogger`` and ``StepTimer`` from
``robust_e2e_gan_tpu/utils/logging.py``: one stdout line per logged step
and a CSV history in the log directory. Logging a step reads its metrics
to the host, which waits for the device.
"""

from __future__ import annotations

import csv
import os
import time
from typing import Dict, Optional


class MetricLogger:
    """stdout + CSV metrics sink with wall-clock time between logs."""

    def __init__(self, log_dir: Optional[str] = None, name: str = "train"):
        self.log_dir = log_dir
        self.name = name
        self._csv = None
        self._writer = None
        self._fields = None
        self._t_last = time.perf_counter()
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._csv_path = os.path.join(log_dir, f"{name}_metrics.csv")

    def log(self, step: int, metrics: Dict[str, float], prefix: str = ""):
        vals = {k: float(v) for k, v in metrics.items()}
        now = time.perf_counter()
        dt_ms = (now - self._t_last) * 1000.0
        self._t_last = now
        line = " ".join(f"{k}={v:.4g}" for k, v in vals.items())
        print(f"[{self.name}] step {step} {prefix}{line} ({dt_ms:.0f} ms)",
              flush=True)
        if self.log_dir:
            row = {"step": step, "ms": round(dt_ms, 2), **vals}
            if self._writer is None or set(row) - set(self._fields):
                self._open_csv(sorted(row))
            self._writer.writerow(row)
            self._csv.flush()

    def _open_csv(self, fields):
        if self._csv:
            self._csv.close()
        self._fields = fields
        # (re)write a header whenever the file's last header differs, so
        # a key-set change never leaves rows under a stale header
        on_disk = None
        if os.path.exists(self._csv_path):
            with open(self._csv_path, newline="") as f:
                for row in csv.reader(f):
                    if not row:
                        continue
                    try:  # data rows hold numbers; header cells don't parse
                        float(row[0])
                    except ValueError:
                        on_disk = row
        self._csv = open(self._csv_path, "a", newline="")
        self._writer = csv.DictWriter(self._csv, fieldnames=fields,
                                      extrasaction="ignore")
        if on_disk != list(fields):
            self._writer.writeheader()

    def close(self):
        if self._csv:
            self._csv.close()
            self._csv = None


class StepTimer:
    """Rolling per-step wall-clock stats."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times = []
        self._t = None

    def tic(self):
        self._t = time.perf_counter()

    def toc(self) -> float:
        dt = time.perf_counter() - self._t
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        return dt

    @property
    def mean_ms(self) -> float:
        return 1000.0 * sum(self.times) / max(len(self.times), 1)
