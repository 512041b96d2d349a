"""Structured logging (port of `gradient_sdf_tpu/utils/logging_util.py`).

The reference logs with raw std::cout everywhere (SURVEY.md §5.5); here a
thin wrapper over Python logging. Per-run metrics are the app's
`--metrics-json` dict.
"""

from __future__ import annotations

import logging
import sys

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
