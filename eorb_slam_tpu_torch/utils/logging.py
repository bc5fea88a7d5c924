"""Leveled logging for the host orchestrator.

PyTorch port's own copy of ``eorb_slam_tpu/utils/logging.py`` (stdlib only;
the reference uses glog's LOG / VLOG_EVERY_N): stdlib logging under the
``eorb`` logger with an environment-tunable level
(EORB_LOG=debug|info|warning|quiet) and an ``every_n`` helper for the
per-frame paths. Host-side only.
"""

from __future__ import annotations

import logging
import os
import sys
from collections import defaultdict

_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "quiet": logging.CRITICAL,
}

_counts: dict = defaultdict(int)
_configured = False


def get_logger(name: str = "eorb") -> logging.Logger:
    global _configured
    log = logging.getLogger(name)
    if not _configured:
        level = _LEVELS.get(os.environ.get("EORB_LOG", "warning").lower(),
                            logging.WARNING)
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname).1s] %(message)s", "%H:%M:%S"))
        root = logging.getLogger("eorb")
        root.addHandler(h)
        root.setLevel(level)
        root.propagate = False
        _configured = True
    return log


def every_n(key: str, n: int) -> bool:
    """True on the 1st, (n+1)th, ... call for `key` (glog LOG_EVERY_N)."""
    _counts[key] += 1
    return (_counts[key] - 1) % n == 0
