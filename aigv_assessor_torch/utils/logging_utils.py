"""Logging with per-process levels (`aigv_assessor_tpu/utils/logging_utils.py`):
the primary process logs at INFO, the others at WARNING, every line tagged
with the process index and count."""

from __future__ import annotations

import logging
import sys

from aigv_assessor_torch.core.dist import process_count, process_index


def setup_logging(level: int = logging.INFO) -> logging.Logger:
    idx, count = process_index(), process_count()
    logging.basicConfig(
        level=level if idx == 0 else logging.WARNING,
        format=f"%(asctime)s [p{idx}/{count}] %(levelname)s %(name)s: %(message)s",
        datefmt="%H:%M:%S",
        stream=sys.stdout,
        force=True,
    )
    return logging.getLogger("aigv_assessor_torch")
