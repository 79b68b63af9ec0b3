"""Process logging setup: colored stderr + timestamped file logs.

The port's own copy of ``legkilo_tpu/utils/logging.py``.  Parity: the
reference's glog wrapper (Logging RAII,
legkilo/src/common/glog_utils.hpp:15-70) — creates a logs/
directory, logs to both a colored console and a per-run file, flushes on
exit.
"""

from __future__ import annotations

import atexit
import logging
import os
import sys
import time
from typing import Optional

_COLORS = {
    logging.DEBUG: "\033[37m",
    logging.INFO: "\033[32m",
    logging.WARNING: "\033[33m",
    logging.ERROR: "\033[31m",
    logging.CRITICAL: "\033[1;31m",
}
_RESET = "\033[0m"


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        msg = super().format(record)
        if sys.stderr.isatty():
            return f"{_COLORS.get(record.levelno, '')}{msg}{_RESET}"
        return msg


def setup(log_dir: Optional[str] = "logs", level: int = logging.INFO,
          name: str = "legkilo") -> logging.Logger:
    """Initialize root logging; returns the package logger."""
    root = logging.getLogger()
    root.setLevel(level)
    for h in list(root.handlers):
        root.removeHandler(h)

    fmt = "%(asctime)s %(levelname).1s %(name)s] %(message)s"
    console = logging.StreamHandler(sys.stderr)
    console.setFormatter(_ColorFormatter(fmt))
    root.addHandler(console)

    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        stamp = time.strftime("%Y%m%d_%H%M%S")
        fh = logging.FileHandler(os.path.join(log_dir, f"{name}_{stamp}.log"))
        fh.setFormatter(logging.Formatter(fmt))
        root.addHandler(fh)
        atexit.register(fh.flush)
    return logging.getLogger(name)
