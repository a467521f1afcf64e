"""Framework logger (counterpart of ``paddlebox_tpu/utils/logging.py``;
the reference system uses glog/VLOG throughout).

One difference from the reference: the package logger keeps
propagating to the root logger and gets no handler of its own. The
port's other modules log through ``logging.getLogger(__name__)`` under
the same package logger, and a private stderr handler with propagation
off would hide their records from the application's handlers (and from
pytest's ``caplog``). ``PADDLEBOX_TPU_LOGLEVEL`` sets the package
logger's level, as in the reference, when it is in the environment.
"""

from __future__ import annotations

import logging
import os

_ROOT = "paddlebox_tpu_torch"
_LOGGER: logging.Logger | None = None


def get_logger(name: str = _ROOT) -> logging.Logger:
    global _LOGGER
    if _LOGGER is None:
        logger = logging.getLogger(_ROOT)
        level = os.environ.get("PADDLEBOX_TPU_LOGLEVEL")
        if level:
            logger.setLevel(level.upper())
        _LOGGER = logger
    if name == _ROOT:
        return _LOGGER
    return _LOGGER.getChild(name.removeprefix(_ROOT + "."))
