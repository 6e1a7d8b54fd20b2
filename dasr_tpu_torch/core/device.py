"""Device selection for the port's CLIs, and the device constants of the
step's ops."""

from __future__ import annotations

import functools

import numpy as np
import torch


def f32_numerics() -> None:
    """f32 means f32 on the card: no TF32 in cuDNN convolutions (torch's
    default allows it) or in cuBLAS matrix products, as the JAX package
    computes its f32 paths. bf16 paths are unaffected."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def resolve_device(name: str) -> torch.device:
    """``"cuda"`` / ``"cuda:N"`` or ``"cpu"`` -> ``torch.device``.

    A CUDA device that is not there raises: the port never drops to the
    CPU on its own. Selecting one turns TF32 off (``f32_numerics``)."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {name!r} requested but torch.cuda.is_available() is "
                "false; pass --device cpu to run the plain PyTorch path"
            )
        index = dev.index or 0
        if index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {name!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) exist"
            )
        f32_numerics()
        return torch.device("cuda", index)
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r}: use cuda or cpu")
    return dev


@functools.lru_cache(maxsize=512)
def constant(make, *args, device: torch.device, dtype: torch.dtype = torch.float32):
    """``make(*args)`` (a numpy array or a sequence of numbers) as a tensor of
    ``dtype`` on ``device``, made on the first call and kept. The step's ops
    read their filters and resampling matrices through this because a
    captured CUDA graph (``train/step_graph.py``) cannot copy from the host:
    the eager warm-up step makes them and the capture finds them here. The
    tensor is shared by every caller: never write to it."""
    return torch.as_tensor(np.asarray(make(*args)), dtype=dtype).to(device)
