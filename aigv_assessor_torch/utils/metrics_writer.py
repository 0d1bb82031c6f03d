"""Scalar metrics writer (`aigv_assessor_tpu/utils/metrics_writer.py`):
JSONL always, TensorBoard when `torch.utils.tensorboard` imports.

It takes the place of the reference's `--report_to tensorboard` (HF Trainer
and tensorboardX, `shell/train/stage1_train.sh:63`): every scalar goes to an
append-only `metrics.jsonl` and to a TensorBoard event file when the
writer imports, both flushed at each write. `train/trainer.Trainer` writes every
record of its `train_log.jsonl` here too, under `<output_dir>/logs`.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict

logger = logging.getLogger(__name__)


class MetricsWriter:
    def __init__(self, logdir: str, enable_tensorboard: bool = True):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
        self._tb = self._try_tb(logdir) if enable_tensorboard else None

    @staticmethod
    def _try_tb(logdir):
        try:
            from torch.utils.tensorboard import SummaryWriter

            return SummaryWriter(logdir)
        except Exception as e:  # no tensorboard package, or it fails to start
            logger.info("no TensorBoard events (%s); metrics.jsonl only", e)
            return None

    def write(self, step: int, scalars: Dict[str, float]) -> None:
        rec = {"step": step, "time": time.time(), **scalars}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                try:
                    self._tb.add_scalar(k, float(v), step)
                except (TypeError, ValueError):  # a value TensorBoard does not take
                    pass
            self._tb.flush()

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
