"""Device selection and precision policy shared by the port's entry
points."""
from __future__ import annotations

import contextlib

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the card: raise if CUDA is absent instead of quietly
    running on the CPU.  Pass ``device="cpu"`` to run the plain path."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the port "
                "on the CPU")
        return torch.device("cuda")
    return torch.device(device)


@contextlib.contextmanager
def f32_precision():
    """Run the block in full float32 on the card: TF32 off for cuDNN's
    convolutions and for matmuls, which torch's defaults (cuDNN on) and a
    caller's settings may allow.  The models compute in float32, and the
    quantized net amplifies TF32's rounding.  Only the flags that were on
    are switched, and they are switched back on the way out."""
    flags = [f for f in (torch.backends.cuda.matmul, torch.backends.cudnn)
             if f.allow_tf32]
    for f in flags:
        f.allow_tf32 = False
    try:
        yield
    finally:
        for f in flags:
            f.allow_tf32 = True
