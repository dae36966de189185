"""Leveled, coloured console logging (counterpart of
core_tpu/utils/logger.py; the reference's yafout / Y_INFO macros,
console_verbosity.h:34-42).  The logger is named "core_tpu_torch" and does
not propagate, so this package's and core_tpu's handlers never print one
record twice.  Verbosity: 0 mute, 1 errors, 2 and 3 info, 4 debug."""
from __future__ import annotations

import logging
import sys

_COLORS = {
    logging.ERROR: "\033[31m",     # red
    logging.WARNING: "\033[33m",   # yellow
    logging.INFO: "\033[32m",      # green
    logging.DEBUG: "\033[36m",     # cyan
}
_RESET = "\033[0m"


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        msg = super().format(record)
        if sys.stderr.isatty():
            color = _COLORS.get(record.levelno, "")
            return f"{color}[{record.levelname}]{_RESET} {msg}"
        return f"[{record.levelname}] {msg}"


logger = logging.getLogger("core_tpu_torch")
if not logger.handlers:
    _handler = logging.StreamHandler()
    _handler.setFormatter(_ColorFormatter("%(message)s"))
    logger.addHandler(_handler)
logger.setLevel(logging.INFO)
logger.propagate = False


def set_verbosity(level: int):
    """0 mute, 1 errors, 2 warnings, 3 info, 4 debug (xml-loader.cc -vl)."""
    logger.setLevel({0: logging.CRITICAL + 1, 1: logging.ERROR,
                     2: logging.INFO, 3: logging.INFO,
                     4: logging.DEBUG}.get(level, logging.INFO))
