"""Logging setup mirroring the reference's console + <wd>/log/logger.log split.

Reference parity: drep/__init__.py::setup_logger and the `!!!`-prefixed
user-facing warnings (SURVEY.md §5.5; reference mount empty, upstream layout).
"""

from __future__ import annotations

import logging
import os
import sys

_LOGGER_NAME = "drep_tpu_torch"


def get_logger() -> logging.Logger:
    return logging.getLogger(_LOGGER_NAME)


def setup_logger(log_dir: str | None = None, verbosity: int = logging.INFO) -> logging.Logger:
    """Configure the framework logger.

    Console gets INFO+ (warnings prefixed with ``!!!`` by callers, matching the
    reference's user-facing convention); ``<log_dir>/logger.log`` gets DEBUG+.
    Safe to call repeatedly — handlers are replaced, not stacked.
    """
    logger = get_logger()
    logger.setLevel(logging.DEBUG)
    for h in list(logger.handlers):
        logger.removeHandler(h)

    console = logging.StreamHandler(sys.stderr)
    console.setLevel(verbosity)
    console.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s", "%H:%M:%S"))
    logger.addHandler(console)

    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        fileh = logging.FileHandler(os.path.join(log_dir, "logger.log"))
        fileh.setLevel(logging.DEBUG)
        fileh.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(name)s %(message)s")
        )
        logger.addHandler(fileh)

    logger.propagate = False
    return logger


def user_warning(msg: str) -> None:
    """Emit a `!!!`-prefixed user-facing warning (reference convention)."""
    get_logger().warning("!!! %s", msg)
