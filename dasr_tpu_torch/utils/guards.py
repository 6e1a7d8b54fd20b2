"""Numerical guard of the train CLIs, copied from ``dasr_tpu.utils.guards``.

The reference's only guard is ``assert not torch.isnan(g_loss)``
(reference: codes/DSN/train.py:262). ``check_finite(metrics, step)`` is the
host-side check over a metric dict that the CLIs run at log boundaries; it
raises with the offending keys, so a diverging GAN fails loudly.
"""

from __future__ import annotations

import math
from typing import Dict


class NonFiniteError(RuntimeError):
    pass


def check_finite(metrics: Dict[str, float], step: int) -> None:
    bad = [k for k, v in metrics.items() if not math.isfinite(float(v))]
    if bad:
        raise NonFiniteError(f"non-finite training metrics at step {step}: {', '.join(bad)}")
