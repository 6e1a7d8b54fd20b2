"""``cond_bytes_per_lr_px``: the bytes of condition the serving facade
copied to the card per LR pixel served (the program's counters
``serve.cond_bytes`` and ``serve.image_lr_px``,
``dasr_tpu_torch/utils/trace.py``): 512 for 8-class f32 maps at x4.
Counted over the whole run, set-up's warm-up and both windows, whose
images are the cell's one mix. Nothing is read where the program keeps no
such counters, or copied no condition."""


def read(run):
    try:
        from dasr_tpu_torch.utils import trace
    except ImportError:
        return None
    counts = trace.counters()
    if not counts.get("serve.cond_bytes") or not counts.get("serve.image_lr_px"):
        return None
    return counts["serve.cond_bytes"] / counts["serve.image_lr_px"]
