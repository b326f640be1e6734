"""Device selection and precision policy shared by the port's entry
points."""
from __future__ import annotations

import contextlib
import threading

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


_F32_LOCK = threading.Lock()
_f32_depth = 0            # blocks open, over every thread
_f32_switched: list = []  # the flags the outermost block switched off


@contextlib.contextmanager
def f32_precision():
    """Run the block in full float32 on the card: TF32 off for cuDNN's
    convolutions and for matmuls, which torch's defaults (cuDNN on) and a
    caller's settings may allow.  The models compute in float32, and the
    quantized net amplifies TF32's rounding.

    The flags are process-wide, so the blocks of every thread share one
    count: the first block to open switches off the flags that were on,
    and they are switched back on when the last block closes, so a block
    in one thread (a serving worker's forward) keeps full float32 while
    another thread's block opens and closes."""
    global _f32_depth, _f32_switched
    with _F32_LOCK:
        if _f32_depth == 0:
            _f32_switched = [f for f in (torch.backends.cuda.matmul,
                                         torch.backends.cudnn)
                             if f.allow_tf32]
            for f in _f32_switched:
                f.allow_tf32 = False
        _f32_depth += 1
    try:
        yield
    finally:
        with _F32_LOCK:
            _f32_depth -= 1
            if _f32_depth == 0:
                for f in _f32_switched:
                    f.allow_tf32 = True
                _f32_switched = []
