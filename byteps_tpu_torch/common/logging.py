"""Logging — the port's copy of ``byteps_tpu/common/logging.py``
(itself the counterpart of reference ``byteps/common/logging.{h,cc}``).

The reference implements glog-style stream macros (``BPS_LOG``, ``BPS_CHECK``,
logging.h:31-67) with the level taken from ``BYTEPS_LOG_LEVEL`` (default
WARNING) and optional timestamp suppression via ``BYTEPS_LOG_HIDE_TIME``
(logging.cc:95-113).  Here we configure a stdlib logger the same way and keep
the ``[rank]``-tagged variant used throughout the reference's core loops.
"""

from __future__ import annotations

import logging
import sys

_LEVELS = {
    "TRACE": 5,
    "DEBUG": logging.DEBUG,
    "INFO": logging.INFO,
    "WARNING": logging.WARNING,
    "ERROR": logging.ERROR,
    "FATAL": logging.CRITICAL,
}

logging.addLevelName(5, "TRACE")

_logger: logging.Logger | None = None


def get_logger() -> logging.Logger:
    global _logger
    if _logger is not None:
        return _logger
    logger = logging.getLogger("byteps_tpu_torch")
    # level comes from the typed config (which reads BYTEPS_LOG_LEVEL) so
    # set_config() programmatic overrides are honored too
    from .config import get_config

    level_name = get_config().log_level.upper()
    logger.setLevel(_LEVELS.get(level_name, logging.WARNING))
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        if get_config().log_hide_time:
            fmt = "[%(levelname)s] %(message)s"
        else:
            fmt = "%(asctime)s [%(levelname)s] %(message)s"
        handler.setFormatter(logging.Formatter(fmt))
        logger.addHandler(handler)
    logger.propagate = False
    _logger = logger
    return logger


def trace(msg: str, *args) -> None:
    get_logger().log(5, msg, *args)


def debug(msg: str, *args) -> None:
    get_logger().debug(msg, *args)


def info(msg: str, *args) -> None:
    get_logger().info(msg, *args)


def warning(msg: str, *args) -> None:
    get_logger().warning(msg, *args)


def error(msg: str, *args) -> None:
    get_logger().error(msg, *args)


def check(cond: bool, msg: str = "") -> None:
    """``BPS_CHECK`` — fatal assert (reference logging.h:90-103)."""
    if not cond:
        raise AssertionError(f"BPS_CHECK failed: {msg}")
