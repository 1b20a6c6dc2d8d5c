"""Colored logging (reference ``tools/logger/log.py:37-73`` equivalent; a
copy of ``chattts_tpu/utils/logger.py``).

Go-style leveled formatter with ANSI colors on TTYs, plus library-noise
suppression for chatty deps.
"""

from __future__ import annotations

import logging
import sys

_COLORS = {
    logging.DEBUG: "\x1b[36m",    # cyan
    logging.INFO: "\x1b[32m",     # green
    logging.WARNING: "\x1b[33m",  # yellow
    logging.ERROR: "\x1b[31m",    # red
    logging.CRITICAL: "\x1b[35m", # magenta
}
_RESET = "\x1b[0m"
_LEVEL_NAMES = {
    logging.DEBUG: "DEBU", logging.INFO: "INFO", logging.WARNING: "WARN",
    logging.ERROR: "ERRO", logging.CRITICAL: "CRIT",
}

_NOISY_LIBS = ("urllib3", "filelock", "numba")


class ColorFormatter(logging.Formatter):
    def __init__(self, color: bool = True):
        super().__init__()
        self.color = color

    def format(self, record: logging.LogRecord) -> str:
        level = _LEVEL_NAMES.get(record.levelno, "????")
        ts = self.formatTime(record, "%H:%M:%S")
        msg = record.getMessage()
        if record.exc_info:
            msg += "\n" + self.formatException(record.exc_info)
        if self.color:
            c = _COLORS.get(record.levelno, "")
            return f"{c}[{level}]{_RESET} {ts} {record.name} | {msg}"
        return f"[{level}] {ts} {record.name} | {msg}"


def get_logger(name: str = "chattts_tpu_torch", level: int = logging.INFO
               ) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(ColorFormatter(color=sys.stderr.isatty()))
        logger.addHandler(h)
        logger.setLevel(level)
        logger.propagate = False
    for lib in _NOISY_LIBS:
        logging.getLogger(lib).setLevel(logging.WARNING)
    return logger
