"""File + console logger (reference ``lib/Old/utils.py:33-56`` get_logger).

Counterpart of ``fiude_tpu/utils/logging.py:9-26``, the standard library only.
"""

from __future__ import annotations

import logging
import os


def get_logger(logpath: str, displaying: bool = True, saving: bool = True,
               debug: bool = False) -> logging.Logger:
    """The logger named ``logpath``, its handlers replaced: a file handler on
    ``logpath`` (its directory made) when ``saving``, a stream handler when
    ``displaying``; level DEBUG with ``debug``, else INFO."""
    logger = logging.getLogger(logpath)
    level = logging.DEBUG if debug else logging.INFO
    logger.setLevel(level)
    logger.handlers = []
    if saving:
        d = os.path.dirname(logpath)
        if d:
            os.makedirs(d, exist_ok=True)
        fh = logging.FileHandler(logpath)
        fh.setLevel(level)
        logger.addHandler(fh)
    if displaying:
        sh = logging.StreamHandler()
        sh.setLevel(level)
        logger.addHandler(sh)
    return logger
