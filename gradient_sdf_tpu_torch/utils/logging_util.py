"""Structured logging (port of `gradient_sdf_tpu/utils/logging_util.py`).

The reference logs with raw std::cout everywhere (SURVEY.md §5.5); here a
thin wrapper over Python logging, and `MetricsRecorder`, a per-frame and
per-run metrics record dumped as JSON (the apps' own `--metrics-json` dict
is separate).
"""

from __future__ import annotations

import json
import logging
import sys
import time

_LOGGER = None


def get_logger(name: str = "gradient_sdf_tpu_torch") -> logging.Logger:
    global _LOGGER
    if _LOGGER is None:
        logger = logging.getLogger(name)
        if not logger.handlers:
            h = logging.StreamHandler(sys.stderr)
            h.setFormatter(
                logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
            )
            logger.addHandler(h)
            logger.setLevel(logging.INFO)
        _LOGGER = logger
    return _LOGGER


class MetricsRecorder:
    """Append-only per-frame metrics and a per-run dict, dumped as one JSON
    object {"run": ..., "frames": [...]}."""

    def __init__(self):
        self.frames = []
        self.run = {}

    def log_frame(self, **kv):
        kv.setdefault("wall_time", time.time())
        self.frames.append(kv)

    def set(self, **kv):
        self.run.update(kv)

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump({"run": self.run, "frames": self.frames}, f, indent=2)
