"""Leveled logging mirroring the reference's ``horovod/common/logging.cc``.

The port's own copy of ``horovod_tpu/core/logging.py``. The reference
exposes glog-style ``LOG(level)`` macros controlled by
``HOROVOD_LOG_LEVEL`` (trace/debug/info/warning/error/fatal) and
``HOROVOD_LOG_HIDE_TIME``; the same env surface drives Python's
``logging`` here, so the knob names users know keep working.
"""

from __future__ import annotations

import logging
import os
import sys

_LEVELS = {
    "trace": 5,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "fatal": logging.CRITICAL,
}

logging.addLevelName(5, "TRACE")

_logger: logging.Logger | None = None


def get_logger() -> logging.Logger:
    global _logger
    if _logger is None:
        logger = logging.getLogger("horovod_tpu_torch")
        level_name = os.environ.get("HOROVOD_LOG_LEVEL", "warning").lower()
        logger.setLevel(_LEVELS.get(level_name, logging.WARNING))
        if not logger.handlers:
            handler = logging.StreamHandler(sys.stderr)
            hide_time = os.environ.get("HOROVOD_LOG_HIDE_TIME", "0") in ("1", "true")
            fmt = "[%(levelname)s] %(message)s" if hide_time else \
                "[%(asctime)s %(levelname)s horovod_tpu_torch] %(message)s"
            handler.setFormatter(logging.Formatter(fmt))
            logger.addHandler(handler)
        logger.propagate = False
        _logger = logger
    return _logger
