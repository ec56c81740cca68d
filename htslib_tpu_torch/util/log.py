"""Leveled logging, equivalent of the reference's hts_log.

Reference behavior: htslib/hts_log.h:40-97 defines severity levels OFF(0),
ERROR(1), WARNING(3), INFO(4), DEBUG(5), TRACE(6); hts.c:5160-5204 prints
"[E::func] msg" style lines to stderr gated on a global verbosity (default
WARNING == 3).

The port's copy of htslib_tpu/util/log.py.
"""
from __future__ import annotations

import os
import sys
import inspect

HTS_LOG_OFF = 0
HTS_LOG_ERROR = 1
HTS_LOG_WARNING = 3
HTS_LOG_INFO = 4
HTS_LOG_DEBUG = 5
HTS_LOG_TRACE = 6

_LEVEL_TAG = {
    HTS_LOG_ERROR: "E",
    2: "W",
    HTS_LOG_WARNING: "W",
    HTS_LOG_INFO: "I",
    HTS_LOG_DEBUG: "D",
    HTS_LOG_TRACE: "T",
}

hts_verbose = int(os.environ.get("HTS_TPU_VERBOSE", HTS_LOG_WARNING))


def hts_set_log_level(level: int) -> None:
    global hts_verbose
    hts_verbose = int(level)


def hts_get_log_level() -> int:
    return hts_verbose


def hts_log(severity: int, context: str | None, fmt: str, *args) -> None:
    """Log `fmt % args` at `severity` if the global level allows it."""
    if severity > hts_verbose:
        return
    if context is None:
        frame = inspect.currentframe()
        caller = frame.f_back.f_back if frame and frame.f_back else None
        context = caller.f_code.co_name if caller else "?"
    tag = _LEVEL_TAG.get(severity, "*")
    msg = (fmt % args) if args else fmt
    print(f"[{tag}::{context}] {msg}", file=sys.stderr)


def log_error(fmt: str, *args) -> None:
    hts_log(HTS_LOG_ERROR, None, fmt, *args)


def log_warning(fmt: str, *args) -> None:
    hts_log(HTS_LOG_WARNING, None, fmt, *args)


def log_info(fmt: str, *args) -> None:
    hts_log(HTS_LOG_INFO, None, fmt, *args)


def log_debug(fmt: str, *args) -> None:
    hts_log(HTS_LOG_DEBUG, None, fmt, *args)


def log_trace(fmt: str, *args) -> None:
    hts_log(HTS_LOG_TRACE, None, fmt, *args)
