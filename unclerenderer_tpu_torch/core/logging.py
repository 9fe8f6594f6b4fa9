"""Leveled logger (``unclerenderer_tpu/core/logging.py``): console, and a
file when ``UNCLERENDERER_LOG`` names one; thread-safe.

The package's modules that log through ``logging.getLogger(__name__)`` are
children of this logger, so they share its handlers and level.
"""

from __future__ import annotations

import logging
import os
import sys
import threading

_LOGGER_NAME = "unclerenderer_tpu_torch"
_init_lock = threading.Lock()
_initialized = False

VERBOSE = 5
logging.addLevelName(VERBOSE, "VERBOSE")


def get_logger() -> logging.Logger:
    global _initialized
    logger = logging.getLogger(_LOGGER_NAME)
    if not _initialized:
        with _init_lock:
            if not _initialized:
                logger.setLevel(logging.INFO)
                fmt = logging.Formatter(
                    "[%(asctime)s][%(levelname)s] %(message)s", datefmt="%H:%M:%S"
                )
                sh = logging.StreamHandler(sys.stderr)
                sh.setFormatter(fmt)
                logger.addHandler(sh)
                log_path = os.environ.get("UNCLERENDERER_LOG", "")
                if log_path:
                    fh = logging.FileHandler(log_path)
                    fh.setFormatter(fmt)
                    logger.addHandler(fh)
                logger.propagate = False
                _initialized = True
    return logger


def set_log_level(level: str) -> None:
    mapping = {
        "verbose": VERBOSE,
        "info": logging.INFO,
        "warning": logging.WARNING,
        "error": logging.ERROR,
    }
    get_logger().setLevel(mapping.get(level.lower(), logging.INFO))


def log_verbose(msg: str) -> None:
    get_logger().log(VERBOSE, msg)


def log_info(msg: str) -> None:
    get_logger().info(msg)


def log_warning(msg: str) -> None:
    get_logger().warning(msg)


def log_error(msg: str) -> None:
    get_logger().error(msg)
