"""glog-style logging (parity: python/mxnet/log.py getLogger).

One-letter level tag + timestamp + pid + location, ANSI-colored on
terminals; the reference exposed this as ``mx.log.getLogger`` and a
handful of level constants.  The port's copy of ``mxnet_tpu/log.py``.
"""
from __future__ import annotations

import logging
import sys

CRITICAL = logging.CRITICAL
ERROR = logging.ERROR
WARNING = logging.WARNING
INFO = logging.INFO
DEBUG = logging.DEBUG
NOTSET = logging.NOTSET

# every framework logger lives under this root, so ONE handler sees the
# whole package's records
PACKAGE_LOGGER = "mxnet_tpu_torch"


def package_logger():
    """The single package root logger (``mxnet_tpu_torch``); every module
    logger below propagates into it."""
    return logging.getLogger(PACKAGE_LOGGER)


def module_logger(name):
    """A per-module logger GUARANTEED to propagate to the package root.

    Pass ``__name__`` (or any suffix): the returned logger is namespaced
    under ``mxnet_tpu_torch`` with propagation on, so one handler on the
    package root sees it."""
    name = str(name)
    if name != PACKAGE_LOGGER \
            and not name.startswith(PACKAGE_LOGGER + "."):
        name = PACKAGE_LOGGER + "." + name
    logger = logging.getLogger(name)
    logger.propagate = True
    return logger

_COLORS = {DEBUG: "\x1b[34m", INFO: "\x1b[32m"}  # default (>=WARNING): red
_LABELS = {CRITICAL: "C", ERROR: "E", WARNING: "W", INFO: "I", DEBUG: "D"}


class GlogFormatter(logging.Formatter):
    """[<level-letter><time> <pid> <file>:<func>:<line>] message"""

    def __init__(self, colored=True):
        super().__init__(datefmt="%m%d %H:%M:%S")
        self.colored = colored

    def format(self, record):
        head = "%s%s %d %s:%s:%d]" % (
            _LABELS.get(record.levelno, "U"),
            self.formatTime(record, self.datefmt), record.process,
            record.pathname, record.funcName, record.lineno)
        if self.colored:
            head = (_COLORS.get(record.levelno, "\x1b[31m") + head
                    + "\x1b[0m")
        body = record.getMessage()
        # keep logger.exception()/stack_info useful: append the
        # traceback the way the stock Formatter does
        if record.exc_info:
            body += "\n" + self.formatException(record.exc_info)
        if getattr(record, "stack_info", None):
            body += "\n" + self.formatStack(record.stack_info)
        return head + " " + body


def getLogger(name=None, filename=None, filemode=None, level=WARNING):
    """A logger wearing the glog formatter; file output is uncolored.
    Idempotent per logger (the reference's one-time-init guard):
    repeated calls adjust the level but never stack handlers."""
    logger = logging.getLogger(name)
    if not getattr(logger, "_mxnet_glog_init", False):
        if filename:
            handler = logging.FileHandler(filename, filemode or "a")
            handler.setFormatter(GlogFormatter(colored=False))
        else:
            handler = logging.StreamHandler(sys.stderr)
            handler.setFormatter(GlogFormatter(
                colored=getattr(sys.stderr, "isatty", lambda: False)()))
        logger.addHandler(handler)
        logger._mxnet_glog_init = True
    logger.setLevel(level)
    return logger
