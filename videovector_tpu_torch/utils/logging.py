"""Logging; counterpart of videovector_tpu/utils/logging.py.

The reference logs through glog, and its tooling parses those lines
(caffe_utils/plot_training_stats.py). Lines keep glog's format,
`I0816 12:00:00.000000 12345 file.py:10] msg`, on top of Python logging.
"""

from __future__ import annotations

import logging
import os
import sys
import threading
import time

_LOCK = threading.Lock()
_CONFIGURED = False
ROOT = "videovector_tpu_torch"


class GlogFormatter(logging.Formatter):
    LEVEL_CHAR = {
        logging.DEBUG: "D",
        logging.INFO: "I",
        logging.WARNING: "W",
        logging.ERROR: "E",
        logging.CRITICAL: "F",
    }

    def format(self, record: logging.LogRecord) -> str:
        t = time.localtime(record.created)
        usec = int((record.created % 1.0) * 1e6)
        level = self.LEVEL_CHAR.get(record.levelno, "I")
        prefix = "%s%02d%02d %02d:%02d:%02d.%06d %5d %s:%d]" % (
            level, t.tm_mon, t.tm_mday, t.tm_hour, t.tm_min, t.tm_sec, usec,
            record.process, os.path.basename(record.pathname), record.lineno,
        )
        return f"{prefix} {record.getMessage()}"


def get_logger(name: str = ROOT) -> logging.Logger:
    """A logger under this package's root, which writes glog lines to
    stderr (level from VVTPU_LOG_LEVEL, default INFO). Callers pass
    __name__; a name outside the package (e.g. "__main__") is put under
    the root, or its lines would reach no handler."""
    global _CONFIGURED
    with _LOCK:
        if not _CONFIGURED:
            handler = logging.StreamHandler(sys.stderr)
            handler.setFormatter(GlogFormatter())
            root = logging.getLogger(ROOT)
            root.addHandler(handler)
            root.setLevel(os.environ.get("VVTPU_LOG_LEVEL", "INFO"))
            root.propagate = False
            _CONFIGURED = True
    if not (name == ROOT or name.startswith(ROOT + ".")):
        name = f"{ROOT}.{name}"
    return logging.getLogger(name)
