"""Where a flagship train step's time goes, on one NVIDIA GPU.

    python -m spike2former_tpu_torch.profile_train [KEY=VALUE ...]

Builds the flagship preset at full width with seeded random weights, with
the config overrides given (e.g. ``train.matcher='host'``; by default the
preset's auction matcher with ``compact_gt=32``), and takes train steps on
seeded synthetic batches (``data/synthetic.py``) of the preset's batch
size and crop (6 at 512x512), f32 with TF32 off, as ``chip_smoke.py``
does.
Prints:

* the step's wall ms (median of the timed steps) and peak memory;
* the host synchronizations of one step, as
  ``torch.cuda.set_sync_debug_mode`` reports them, by the line of the
  port that issued them;
* from ``torch.profiler`` over one step: for each stage of the step
  (the ``record_function`` ranges of ``engine/train.py``: forward, GT
  slots, matching and the loss forward, backward, optimizer) the
  host ms inside the range (waits for the device included) and the device
  ms of the kernels launched from it; device launches, device busy time
  against the unprofiled step time, the kernels with the most device
  time, and the two DCNv3 kernels' share.

It exits non-zero without a card, or if the profiler sees no device time.
"""
from __future__ import annotations

import collections
import json
import os
import statistics
import sys
import time
import traceback
import warnings

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from . import api
from .data.synthetic import synthetic_batch

PRESET = "SDTv2_maskformer_DCNpixelDecoder_ade20k"
WARMUP, TIMED = 2, 3


STAGES = ("forward", "match_and_loss", "backward", "optimizer")


def _stage_ms(prof) -> dict:
    """Host ms of each stage's range and device ms of the kernels it
    launched.  A kernel belongs to the stage whose range holds the start
    of the op that launched it, whatever that op's thread: the autograd
    engine runs the backward's ops on a thread of its own."""
    events = prof.profiler.kineto_results.events()
    ranges = {}
    op_start = {}
    for e in events:
        if e.device_type() != DeviceType.CPU:
            continue
        op_start[e.correlation_id()] = e.start_ns()
        if e.name() in STAGES:
            ranges[e.name()] = (e.start_ns(), e.end_ns())
    out = {k: {"host_ms": (b - a) / 1e6, "device_ms": 0.0}
           for k, (a, b) in ranges.items()}
    out["unassigned"] = {"device_ms": 0.0}
    for e in events:
        if e.device_type() != DeviceType.CUDA or e.name() in STAGES:
            continue
        t = op_start.get(e.linked_correlation_id())
        stage = next((k for k, (a, b) in ranges.items()
                      if t is not None and a <= t <= b), "unassigned")
        out[stage]["device_ms"] += e.duration_ns() / 1e6
    return out


def sync_sites(fn) -> collections.Counter:
    """Run ``fn`` under ``torch.cuda.set_sync_debug_mode('warn')``; count
    the synchronizing operations by the innermost line of this package
    that issued them."""
    sites = collections.Counter()
    here = os.path.abspath(__file__)
    pkg = os.path.dirname(here)

    def record(message, *args, **kwargs):
        if "called a synchronizing CUDA operation" not in str(message):
            return
        own = [f for f in traceback.extract_stack()
               if f.filename.startswith(pkg) and f.filename != here]
        sites[f"{os.path.relpath(own[-1].filename, pkg)}:{own[-1].lineno}"
              if own else "elsewhere"] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sites


def main(overrides: list[str]) -> int:
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)} torch {torch.__version__}",
          flush=True)
    tr = api.init_trainer(PRESET, overrides, seed=0)
    print(f"matcher={tr.cfg.train.matcher} compact_gt="
          f"{tr.cfg.train.compact_gt}", flush=True)
    rng = np.random.default_rng(0)
    b, hw = tr.cfg.data.batch_size, tuple(tr.cfg.data.crop_size)
    batches = [tuple(torch.as_tensor(a, device=tr.device)
                     for a in synthetic_batch(rng, b, hw))
               for _ in range(WARMUP + TIMED)]
    torch.cuda.reset_peak_memory_stats()
    times = []
    for batch in batches:
        torch.cuda.synchronize()
        t = time.perf_counter()
        tr.step_fn(tr.state, *batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    step_ms = statistics.median(times[WARMUP:])
    print(f"step_ms={step_ms:.3f} (steps {[round(x, 1) for x in times]}) "
          f"peak_gib={torch.cuda.max_memory_allocated() / 2 ** 30:.3f}",
          flush=True)

    sites = sync_sites(lambda: tr.step_fn(tr.state, *batches[-1]))
    print(f"host synchronizations in one step: {sum(sites.values())} "
          f"{json.dumps(dict(sites.most_common()))}", flush=True)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tr.step_fn(tr.state, *batches[-1])
        torch.cuda.synchronize()
    print("stages " + json.dumps(
        {k: {m: round(v, 3) for m, v in d.items()}
         for k, d in _stage_ms(prof).items()}), flush=True)
    # the ranges' own device-side spans are not kernels
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.key not in STAGES]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms <= 0:
        print("profile_train: the profiler saw no device time",
              file=sys.stderr)
        return 1
    print(f"per step: device_busy_ms={busy_ms:.3f} against step_ms="
          f"{step_ms:.3f} busy_share={busy_ms / step_ms:.3f} "
          f"device_launches={sum(e.count for e in kernels)}", flush=True)
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for e in kernels[:20]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d} "
              f"calls  {e.key[:90]}", flush=True)
    for name in ("dcnv3_sample_kernel", "dcnv3_sample_bwd_kernel"):
        ks = [e for e in kernels if name in e.key]
        print(f"{name}: {sum(e.self_device_time_total for e in ks) / 1e3:.4f}"
              f" ms in {sum(e.count for e in ks)} launches per step",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
