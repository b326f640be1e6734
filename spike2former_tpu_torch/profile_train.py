"""Where a train step's time goes, on one NVIDIA GPU.

    python -m spike2former_tpu_torch.profile_train [--loader | --panoptic] \
        [--preset NAME] [--cfg-options] [KEY=VALUE ...]

Builds the flagship preset (or ``--preset``'s, e.g. an FPN-family one,
``fpn_sdtv3_512x512_19M_ade20k``) at full width with the test draw of
seeded random weights (``engine/weights.py:randomize_``), with the
config overrides given, with or without ``--cfg-options`` before them
as the CLIs take them (e.g. ``train.matcher='host'``, or
``model.dtype='bfloat16'`` for the bf16 step; by default the preset's
auction matcher with ``compact_gt=32`` in f32), and takes train steps on
seeded synthetic batches (``data/synthetic.py``) of the preset's batch
size and crop (6 at 512x512), with TF32 off (a bf16 model's float32 parts
stay float32), as ``chip_smoke.py`` does.  With ``--loader`` the batches are the train CLI's instead: the
``TrainLoader`` crops of a seeded ADE20K-layout tree of 12 images
(``data/synthetic.py:ADE_LIKE_SHAPES``), written to a temporary
directory.  With ``--panoptic`` the preset is
``SDTv2_maskformer_coco_panoptic`` and the batches are the panoptic train
CLI's: ``panoptic_train_batches`` of a seeded COCO-panoptic tree of four
COCO-sized images, the masks sent as uint8.
Prints:

* the step's wall ms (median of the timed steps), peak memory, the
  auction's iterations in each step and the classes (panoptic: the GT
  segments) of each crop;
* the host synchronizations of one step, as
  ``torch.cuda.set_sync_debug_mode`` reports them, by the line of the
  port that issued them;
* from ``torch.profiler`` over one step: for each stage of the step
  (the ``record_function`` ranges of ``engine/train.py``: forward, GT
  slots, matching and the loss forward, backward, optimizer; for the FPN
  family backbone, neck and head, ranges opened by forward hooks, then
  the pixel loss, backward, optimizer) the
  host ms inside the range (waits for the device included) and the device
  ms of the kernels launched from it; device launches, device busy time
  against the unprofiled step time, the kernels with the most device
  time, and the two DCNv3 kernels' share;
* the step's matrix-product and convolution kernels (by the names cuBLAS,
  CUTLASS and cuDNN give them) by the element type their names carry:
  device ms and launches of each group, and the five largest kernels of
  each.

It exits non-zero without a card, or if the profiler sees no device time.
"""
from __future__ import annotations

import collections
import json
import os
import statistics
import sys
import tempfile
import time
import traceback
import warnings

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from . import api
from .data.dataset import make_dataset
from .data.loader import TrainLoader
from .data.panoptic import PanopticDataset, panoptic_train_batches
from .data.synthetic import (ADE_LIKE_SHAPES, COCO_LIKE_SHAPES,
                             synthetic_batch, write_ade_tree,
                             write_coco_panoptic_tree)
from .engine.train import is_fpn
from .engine.weights import randomize_
from .losses import criterion
from .losses.matcher import auction_match
from .profile_request import preset_and_overrides

PRESET = "SDTv2_maskformer_DCNpixelDecoder_ade20k"
PANOPTIC = "SDTv2_maskformer_coco_panoptic"
WARMUP, TIMED = 2, 3


STAGES = ("forward", "match_and_loss", "backward", "optimizer")
FPN_STAGES = ("backbone", "neck", "head", "pixel_loss", "backward",
              "optimizer")


def _stage_ms(prof, stages=STAGES) -> dict:
    """Host ms of each stage's ranges and device ms of the kernels they
    launched.  A kernel belongs to the stage whose range holds the start
    of the op that launched it, whatever that op's thread: the autograd
    engine runs the backward's ops on a thread of its own."""
    events = prof.profiler.kineto_results.events()
    ranges = collections.defaultdict(list)
    op_start = {}
    for e in events:
        if e.device_type() != DeviceType.CPU:
            continue
        op_start[e.correlation_id()] = e.start_ns()
        if e.name() in stages:
            ranges[e.name()].append((e.start_ns(), e.end_ns()))
    out = {k: {"host_ms": sum(b - a for a, b in v) / 1e6, "device_ms": 0.0}
           for k, v in ranges.items()}
    out["unassigned"] = {"device_ms": 0.0}
    for e in events:
        if e.device_type() != DeviceType.CUDA or e.name() in stages:
            continue
        t = op_start.get(e.linked_correlation_id())
        stage = next((k for k, v in ranges.items() for a, b in v
                      if t is not None and a <= t <= b), "unassigned")
        out[stage]["device_ms"] += e.duration_ns() / 1e6
    return out


def fpn_part_ranges(model) -> list:
    """Forward hooks that run the FPN family's backbone, neck and head (a
    cascade's every stage) inside ``record_function`` ranges of those
    names; returns the hooks' handles."""
    heads = ([model.head] if hasattr(model, "head") else
             [getattr(model, f"stage{i}") for i in range(model.num_stages)])
    open_ranges, handles = [], []
    for name, mods in (("backbone", [model.backbone]),
                       ("neck", [model.neck]), ("head", heads)):
        for mod in mods:
            def pre(_m, _a, name=name):
                rf = record_function(name)
                rf.__enter__()
                open_ranges.append(rf)

            def post(_m, _a, _o):
                open_ranges.pop().__exit__(None, None, None)

            handles += [mod.register_forward_pre_hook(pre),
                        mod.register_forward_hook(post)]
    return handles


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


def loader_batches(b: int, hw: tuple[int, int], n: int) -> list:
    """``n`` batches of the train CLI's loader on a seeded tree."""
    with tempfile.TemporaryDirectory() as root:
        write_ade_tree(root, ADE_LIKE_SHAPES, seed=3, split="training")
        with TrainLoader(make_dataset("ade20k", root, "train"), b, hw,
                         seed=0) as loader:
            it = iter(loader)
            return [next(it) for _ in range(n)]


def panoptic_batches(cfg, n: int) -> list:
    """``n`` batches of the panoptic train CLI on a seeded tree, the masks
    as uint8 (as the CLI sends them)."""
    with tempfile.TemporaryDirectory() as root:
        write_coco_panoptic_tree(root, COCO_LIKE_SHAPES + ((480, 640),),
                                 seed=1, split="train")
        it = panoptic_train_batches(
            PanopticDataset(root, "train"), cfg.data.batch_size,
            cfg.data.crop_size, cfg.train.max_gt, seed=cfg.train.seed)
        return [(im, lab, masks.astype(np.uint8), valid)
                for im, lab, masks, valid in (next(it) for _ in range(n))]


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)} torch {torch.__version__}",
          flush=True)
    loader, panoptic = "--loader" in argv, "--panoptic" in argv
    preset, overrides = preset_and_overrides(
        [a for a in argv if a not in ("--loader", "--panoptic")],
        PANOPTIC if panoptic else PRESET)
    tr = api.init_trainer(preset, overrides, seed=0)
    randomize_(tr.state.model, 0)   # the test draw: weights that fire
    fpn = is_fpn(tr.cfg)
    print(f"preset={preset} matcher={tr.cfg.train.matcher} compact_gt="
          f"{tr.cfg.train.compact_gt} dtype={tr.cfg.model.dtype} remat="
          f"{tr.cfg.model.remat} packed_residuals="
          f"{tr.cfg.train.packed_residuals} batches="
          f"{'panoptic' if panoptic else 'loader' if loader else 'synthetic'}",
          flush=True)
    b, hw = tr.cfg.data.batch_size, tuple(tr.cfg.data.crop_size)
    if panoptic:
        host = panoptic_batches(tr.cfg, WARMUP + TIMED)
    elif loader:
        host = loader_batches(b, hw, WARMUP + TIMED)
    else:
        rng = np.random.default_rng(0)
        host = [synthetic_batch(rng, b, hw) for _ in range(WARMUP + TIMED)]
    batches = [tuple(torch.as_tensor(a, device=tr.device) for a in batch)
               for batch in host]
    torch.cuda.reset_peak_memory_stats()
    times, costs = [], []
    real_auction = criterion.auction_match

    def spy(c, **kw):
        costs.append(c.detach().clone())
        return real_auction(c, **kw)

    criterion.auction_match = spy
    try:
        for batch in batches:
            torch.cuda.synchronize()
            t = time.perf_counter()
            tr.step_fn(tr.state, *batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
    finally:
        criterion.auction_match = real_auction
    step_ms = statistics.median(times[WARMUP:])
    print(f"step_ms={step_ms:.3f} (steps {[round(x, 1) for x in times]}) "
          f"peak_gib={torch.cuda.max_memory_allocated() / 2 ** 30:.3f}",
          flush=True)
    iterations = [int(auction_match(c, with_stats=True)[1].iterations)
                  for c in costs]
    if panoptic:
        what, classes = "GT segments", [int(v.sum()) for b in host
                                        for v in b[3]]
    else:
        what, classes = "classes", [len(np.unique(s[s != 255]))
                                    for _, sem in host for s in sem]
    print(f"auction iterations per step {iterations}; {what} per crop "
          f"{classes}", flush=True)

    sites = sync_sites(lambda: tr.step_fn(tr.state, *batches[-1]))
    print(f"host synchronizations in one step: {sum(sites.values())} "
          f"{json.dumps(dict(sites.most_common()))}", flush=True)

    stages = FPN_STAGES if fpn else STAGES
    handles = fpn_part_ranges(tr.state.model) if fpn else []
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            tr.step_fn(tr.state, *batches[-1])
            torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    print("stages " + json.dumps(
        {k: {m: round(v, 3) for m, v in d.items()}
         for k, d in _stage_ms(prof, stages).items()}), flush=True)
    # the ranges' own device-side spans are not kernels
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.key not in stages
               and e.key != "forward"]
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
    for (kind, dtype), ks in sorted(product_kernels(kernels).items()):
        ms = sum(e.self_device_time_total for e in ks) / 1e3
        print(f"{kind} kernels, {dtype}: {ms:.3f} ms in "
              f"{sum(e.count for e in ks)} launches per step", flush=True)
        for e in ks[:5]:
            print(f"    {e.self_device_time_total / 1e3:9.3f} ms "
                  f"{e.count:5d}  {e.key[:110]}", flush=True)
    return 0


# name fragments of the library kernels: a convolution's (cuDNN's implicit
# GEMMs and its depthwise and weight-gradient kernels) and a matrix
# product's (cuBLAS, CUTLASS); the element type by the fragments the names
# carry, f32 where none does (cuBLAS's and cuDNN's plain f32 kernels name
# no type: "sgemm", "fprop" without "bf16")
CONV_NAMES = ("conv", "implicit", "fprop", "dgrad", "wgrad", "depthwise",
              "nchwToNhwc", "nhwcToNchw")
GEMM_NAMES = ("gemm", "cutlass", "sm90_xmma", "Kernel2", "splitK")
DTYPE_NAMES = (("bf16", ("bf16", "bfloat16", "BFloat16")),
               ("tf32", ("tf32",)), ("f16", ("f16", "fp16", "half")))


def product_kernels(kernels) -> dict:
    """{('conv' | 'gemm', dtype): kernels} of a profile's device kernels,
    each group sorted by device time."""
    out = collections.defaultdict(list)
    for e in kernels:
        name = e.key
        low = name.lower()
        if any(f.lower() in low for f in CONV_NAMES):
            kind = "conv"
        elif any(f.lower() in low for f in GEMM_NAMES):
            kind = "gemm"
        else:
            continue
        dtype = next((d for d, frags in DTYPE_NAMES
                      if any(f.lower() in low for f in frags)), "f32")
        out[kind, dtype].append(e)
    return out


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
