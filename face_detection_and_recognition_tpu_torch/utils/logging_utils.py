"""Structured logging for batch jobs.

The port's copy of ``utils/logging_utils.py`` in the JAX package: the
reference's job logging (timestamped ``logs/<name>_statistics_*.log`` files
with per-class and total counts, ``extract_faces_from_dataset.py:32-34,
449-458``).
"""
from __future__ import annotations

import logging
import os
import time
from typing import Optional


def setup_job_logger(
    name: str = "face_extraction",
    log_dir: Optional[str] = "logs",
    level: int = logging.INFO,
) -> logging.Logger:
    """Console + timestamped-file logger, reference layout."""
    logger = logging.getLogger(name)
    logger.setLevel(level)
    if logger.handlers:
        return logger
    fmt = logging.Formatter(
        "%(asctime)s %(levelname)s %(name)s: %(message)s"
    )
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        stamp = time.strftime("%Y%m%d-%H%M%S")
        fh = logging.FileHandler(
            os.path.join(log_dir, f"{name}_statistics_{stamp}.log")
        )
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger
