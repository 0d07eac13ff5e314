"""Scalar logging (counterpart of ``tggcn/train/logging.py``): JSONL
always, TensorBoard where ``torch.utils.tensorboard`` imports.

The JSONL stream under ``<root>/runs/<checkpoint_name>/scalars.jsonl`` has
the JAX package's records ({tag, value, step, time}), which its analysis
CLI reads for loss curves.
"""

import json
import os
import time
from typing import Optional


class ScalarWriter:
    def __init__(self, root_log_dir: Optional[str], checkpoint_name: Optional[str]):
        self._file = None
        self._tb = None
        if root_log_dir is None or checkpoint_name is None:
            return
        run_dir = os.path.join(root_log_dir, "runs", checkpoint_name)
        os.makedirs(run_dir, exist_ok=True)
        self._file = open(os.path.join(run_dir, "scalars.jsonl"), "a")
        try:
            from torch.utils.tensorboard import SummaryWriter  # optional

            self._tb = SummaryWriter(run_dir)
        except Exception:  # noqa: BLE001 - tensorboard genuinely optional
            self._tb = None

    def add_scalar(self, tag: str, value, step: int):
        if self._file is not None:
            self._file.write(json.dumps({"tag": tag, "value": float(value),
                                         "step": int(step), "time": time.time()}) + "\n")
            self._file.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)

    def close(self):
        if self._file is not None:
            self._file.close()
        if self._tb is not None:
            self._tb.close()
