"""Console + file logging on stdlib `logging`: the port's copy of
`dexrobot_isaac_tpu/utils/logging.py` (level from the config, one log file
per run)."""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

_FORMAT = "%(asctime)s | %(levelname)-7s | %(name)s - %(message)s"
_configured = False


def setup_logging(
    level: str = "info",
    log_file: Optional[str] = None,
) -> logging.Logger:
    """Configure root logging once; returns the framework logger."""
    global _configured
    root = logging.getLogger("dexhand_torch")
    root.setLevel(getattr(logging, level.upper(), logging.INFO))
    if not _configured:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
        root.addHandler(handler)
        root.propagate = False
        _configured = True
    if log_file:
        os.makedirs(os.path.dirname(log_file), exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(logging.Formatter(_FORMAT))
        root.addHandler(fh)
    return root


def get_logger(name: str = "dexhand_torch") -> logging.Logger:
    return logging.getLogger(name)
