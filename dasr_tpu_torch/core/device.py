"""Device selection for the port's CLIs."""

from __future__ import annotations

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
