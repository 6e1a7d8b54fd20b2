"""``tile_overcompute``: the LR pixels the generator forwarded over the LR
pixels served (the program's counters ``serve.tile_lr_px`` and
``serve.image_lr_px``, ``dasr_tpu_torch/utils/trace.py``): what the tiles'
halos and pads add to the work of an image. Counted over the whole run,
set-up's warm-up and both windows, whose images are the cell's one mix.
Nothing is read where the program keeps no such counters."""


def read(run):
    try:
        from dasr_tpu_torch.utils import trace
    except ImportError:
        return None
    counts = trace.counters()
    if not counts.get("serve.image_lr_px"):
        return None
    return counts["serve.tile_lr_px"] / counts["serve.image_lr_px"]
