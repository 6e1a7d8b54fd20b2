"""``adam_kernel_share``: the share of the Adam updates' tensors that the
hand-written kernel updated (the program's counters ``adam.kernel_tensors``
and ``adam.torch_tensors``, ``dasr_tpu_torch/utils/trace.py``, which the
step graph credits per replay), counted over the whole run: set-up's
checked calls and every window. Nothing is read where the program keeps
neither counter."""


def read(run):
    try:
        from dasr_tpu_torch.utils import trace
    except ImportError:
        return None
    counts = trace.counters()
    kernel, torch_ = counts.get("adam.kernel_tensors", 0), counts.get("adam.torch_tensors", 0)
    if not kernel + torch_:
        return None
    return kernel / (kernel + torch_)
