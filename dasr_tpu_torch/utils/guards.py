"""Guards of the train CLIs, after ``dasr_tpu.utils.guards``.

The reference's only guard is ``assert not torch.isnan(g_loss)``
(reference: codes/DSN/train.py:262). ``check_finite(metrics, step)`` is the
host-side check over a metric dict that the CLIs run at log boundaries; it
raises with the offending keys, so a diverging GAN fails loudly.
``profile(trace_dir)`` is the ``torch.profiler`` counterpart of the JAX
package's ``jax.profiler`` trace (``srn_train --profile``), with the port's
own spans (``utils/trace.py``) beside it.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
from typing import Dict


class NonFiniteError(RuntimeError):
    pass


def check_finite(metrics: Dict[str, float], step: int) -> None:
    bad = [k for k, v in metrics.items() if not math.isfinite(float(v))]
    if bad:
        raise NonFiniteError(f"non-finite training metrics at step {step}: {', '.join(bad)}")


@contextlib.contextmanager
def profile(trace_dir: str = None):
    """A ``torch.profiler`` trace (host, and the card where there is one)
    written to ``trace_dir/trace.json`` on exit, and the port's recorder on
    for the block, its spans written to ``trace_dir/spans.json`` on the
    same clock; a no-op without a dir."""
    if not trace_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from dasr_tpu_torch.utils import trace

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    trace.enable()
    try:
        with torch_profile(activities=acts) as prof:
            yield prof
    finally:
        trace.disable()
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        base_ns = json.load(f).get("baseTimeNanoseconds", 0)
    trace.write_chrome_trace(trace.drain(), os.path.join(trace_dir, "spans.json"), base_ns)
