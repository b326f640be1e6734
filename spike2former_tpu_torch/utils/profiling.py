"""Profiling helpers (port of ``spike2former_tpu/utils/profiling.py``;
mmdet/utils/profiling.py and IterTimerHook): a timed range, a
``torch.profiler`` Chrome trace and a rolling iteration timer."""
from __future__ import annotations

import contextlib
import os
import time

import torch


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def profile_time(name: str, log=print):
    """Wall-clock a block, named ``name`` in a profiler trace
    (``torch.profiler.record_function``); the card is synchronized
    before the clock is read at each end, so the time covers the block's
    device work."""
    with torch.profiler.record_function(name):
        _sync()
        t0 = time.perf_counter()
        yield
        _sync()
        log(f"{name}: {(time.perf_counter() - t0) * 1000:.2f} ms")


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (the CPU, and the card
    when there is one) and write a Chrome trace (Perfetto,
    chrome://tracing) to ``log_dir/trace.json``.  Yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class IterTimer:
    """Rolling per-iteration timing (IterTimerHook): ``tick()`` returns
    the seconds since the last tick, ``avg`` the mean of the last
    ``window``."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times: list[float] = []
        self._last = time.perf_counter()

    def tick(self) -> float:
        now = time.perf_counter()
        dt = now - self._last
        self._last = now
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        return dt

    @property
    def avg(self) -> float:
        return sum(self.times) / max(len(self.times), 1)
