"""Wall-clock stage timer (reference `cpp/include/Timer.h:47-80` tic/toc).

Also doubles as the structured per-stage metrics sink the reference lacks:
every toc is recorded into a dict so apps can dump a metrics JSON per run.
"""

from __future__ import annotations

import collections
import time


class Timer:
    def __init__(self, verbose: bool = True):
        self._t0 = None
        self._label = ""
        self.verbose = verbose
        self.records = collections.defaultdict(list)  # label -> [seconds]

    def tic(self, label: str = ""):
        self._label = label
        self._t0 = time.perf_counter()

    def toc(self, label: str | None = None) -> float:
        dt = time.perf_counter() - self._t0
        return self.record(label if label is not None else self._label, dt)

    def record(self, label: str, dt: float) -> float:
        """Record `dt` seconds, timed elsewhere, under `label`."""
        self.records[label].append(dt)
        if self.verbose:
            if dt < 1.0:
                print(f"Time {label}: {dt * 1e3:.3f} ms")
            else:
                print(f"Time {label}: {dt:.3f} s")
        return dt

    def summary(self) -> dict:
        return {
            k: {"total_s": sum(v), "count": len(v), "mean_s": sum(v) / len(v),
                "median_s": sorted(v)[len(v) // 2]}
            for k, v in self.records.items()
        }
