"""Metric/observability sink.

Replaces tensorboardX scalar/image logging (reference: codes/DSN/
train.py:186-191,244-279, codes/SRN/train.py:50-52) with a JSONL stream —
one line per write, trivially greppable/plottable — plus optional
step-time / imgs-per-sec counters (SURVEY.md §5 tracing gap).

When ``tb_dir`` is given, every scalar (and image via ``write_image``) is
also mirrored to a real TensorBoard event file (utils/tb_writer.py) so
stock TensorBoard reads the runs exactly as it reads the reference's
tensorboardX logs.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricsWriter:
    def __init__(self, path: str, tb_dir: Optional[str] = None):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a", buffering=1)
        self._t_last: Optional[float] = None
        self._step_last: Optional[int] = None
        self._tb = None
        if tb_dir:
            from dasr_tpu_torch.utils.tb_writer import TBWriter

            self._tb = TBWriter(tb_dir)

    def write(self, step: int, metrics: Dict[str, float], imgs: Optional[int] = None):
        now = time.time()
        rec = {"step": step, "time": now, **metrics}
        if self._t_last is not None and step > self._step_last:
            dt = now - self._t_last
            rec["perf/steps_per_sec"] = (step - self._step_last) / max(dt, 1e-9)
            if imgs is not None:
                rec["perf/imgs_per_sec"] = imgs * (step - self._step_last) / max(dt, 1e-9)
        self._t_last, self._step_last = now, step
        self._f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in rec.items():
                if k not in ("step", "time") and isinstance(v, (int, float)):
                    self._tb.add_scalar(k, float(v), step)
            self._tb.flush()

    def write_image(self, step: int, tag: str, img):
        """Mirror an image (uint8/float HWC) to TensorBoard, if enabled."""
        if self._tb is not None:
            self._tb.add_image(tag, img, step)
            self._tb.flush()

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()
