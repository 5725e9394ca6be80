"""Leveled, pluggable logging (reference: x264_log / x264_log_default,
common/base.c:66-98, and the x264_param_t.pf_log callback contract in
x264.h).

The reference routes every diagnostic through `pf_log(opaque, level,
fmt, args)` with levels NONE(-1)/ERROR(0)/WARNING(1)/INFO(2)/DEBUG(3)
and a default sink that prefixes "x264 [level]: " and writes to stderr.
Same surface here: `Logger` holds the level + sink, `set_sink` installs
a user callback (the pf_log analogue), and module code calls
`log.error/warning/info/debug`.
"""

from __future__ import annotations

import sys
from typing import Callable, Optional

LOG_NONE = -1
LOG_ERROR = 0
LOG_WARNING = 1
LOG_INFO = 2
LOG_DEBUG = 3

_PREFIX = {LOG_ERROR: "error", LOG_WARNING: "warning",
           LOG_INFO: "info", LOG_DEBUG: "debug"}

# sink signature: (level:int, message:str) -> None
Sink = Callable[[int, str], None]


def default_sink(level: int, msg: str) -> None:
    """x264_log_default analogue: 'x264-tpu [level]: message' on stderr."""
    name = _PREFIX.get(level, "unknown")
    print(f"x264-tpu [{name}]: {msg}", file=sys.stderr)


class Logger:
    """Per-encoder logger: level filter + pluggable sink."""

    def __init__(self, level: int = LOG_INFO,
                 sink: Optional[Sink] = None) -> None:
        self.level = level
        self.sink: Sink = sink or default_sink

    def set_sink(self, sink: Optional[Sink]) -> None:
        self.sink = sink or default_sink

    def log(self, level: int, msg: str) -> None:
        if level <= self.level:
            self.sink(level, msg)

    def error(self, msg: str) -> None:
        self.log(LOG_ERROR, msg)

    def warning(self, msg: str) -> None:
        self.log(LOG_WARNING, msg)

    def info(self, msg: str) -> None:
        self.log(LOG_INFO, msg)

    def debug(self, msg: str) -> None:
        self.log(LOG_DEBUG, msg)


# module-level logger for code without an encoder handle (the
# x264_log_internal path, base.c:93)
_global = Logger()


def set_level(level: int) -> None:
    _global.level = level


def error(msg: str) -> None:
    _global.error(msg)


def warning(msg: str) -> None:
    _global.warning(msg)


def info(msg: str) -> None:
    _global.info(msg)


def debug(msg: str) -> None:
    _global.debug(msg)
