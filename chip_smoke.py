#!/usr/bin/env python3
"""Drive the PyTorch port (``spike2former_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, each printing one flushed line with the seconds elapsed:

  (a) device: torch/CUDA versions, the card's name and power limit;
  (b) build: ``nvcc`` builds ``csrc/dcnv3_sample.cu`` (K1, forward),
      ``csrc/dcnv3_sample_bwd.cu`` (K2, backward),
      ``csrc/dcnv3_sample_grouped.cu`` (the grouped-layout forward, the
      counterpart of K3-K6) and ``csrc/dcnv3_sample_grouped_bwd.cu`` (its
      backward, K7) for sm_90a, the four side by side;
  (c) K1 against its plain PyTorch version at the flagship shapes (serve:
      N in {1, 2}, 32x44; train: N=6, 32x32; G=32, Cg=8, P=9, f32) and
      on a 64x128 map too large for one block's tile, for random
      (off-map), far (up to 10 px, out of the halo), zero-offset and
      integer-coordinate inputs; at the serve and train shapes its time
      with a warm and a cold L2, the plain time, an ``F.grid_sample``
      yardstick and the byte bound;
  (k2) K2 against its plain version at the flagship train shape (N=6,
      32x32) and on the 64x128 map, for the same four kinds of input;
      at the train shape its time with a warm and a cold L2, the plain
      time, the ``F.grid_sample`` backward yardstick and the byte bound;
  (grad) gradients to x, offset and mask through ``dcnv3_core`` at the
      flagship train shape and on the 64x128 map with offsets up to
      10 px, K1 forward and K2 backward, against autograd of the plain
      sampler on the same card tensors;
  (grouped) the grouped-layout kernels under their tile plans
      (``grouped_tile_plan``): the forward in both layouts (gchw for
      K3/K5/K6, ghwc for K4) and the backward (K7) against their plain
      versions and against K1/K2 on the same data, at the flagship's
      full-width shapes (serve: N=1, 32x44; train: N=6, 32x32; G=32,
      Cg=8, P=9) for random, far, off-map, zero-offset, integer and NaN
      coordinates, and at Cg 1-32 with G=4 on a 64x128 map (bands of rows
      with halos), an 8x2048 map (nothing staged from Cg=8 on) and a 9x13
      map (one backward band owns it: no zero-fill); autograd of both
      layouts at the train shape; at both flagship shapes their times
      with a warm and a cold L2 beside K1's and K2's on the same data, the
      plain times, the ``F.grid_sample`` yardsticks and the byte bounds.
      No model path calls them: their launch counts on the serve and
      train paths are read and reported (0);
  (d) the flagship SDTv2 MaskFormer at full width serves 3 requests through
      ``api.inference_model`` (K1 launch count 6 per request); K1 is held
      against the plain version at each of the 6 DCN calls of one request,
      and a tiny model's logits on the card against the CPU's;
  (e) median (and max) ms per request over 30 requests, and peak memory;
  (tf32) ``whole_logits`` on the three requests' images in full f32, with
      torch's default flags (TF32 on for cuDNN) and with TF32 on for both
      cuDNN and matmuls: the share of pixels whose class agrees with f32
      and the largest logit difference; the tiny model's card logits in
      each mode against the CPU's;
  (eval) the eval CLI's ``evaluate`` at full width on a seeded
      ADE20K-layout tree of three images (512x683, 683x512, 512x512) in
      whole mode bucketed to 128 with ``valid_hw``, whole mode exact (pad
      to 32) and slide mode (crop 512, stride 341): each mode's mIoU, ms
      per image and K1 launches per image and window, and the share of
      pixels on which bucketed and exact agree;
  (train) the flagship at full width, at the preset's defaults (the
      on-device auction matcher, ``compact_gt=32``), takes 2 warm-up and 5
      timed train steps through ``api.init_trainer`` / ``api.train_steps``
      at batch 6 and 512x512 crops of seeded synthetic images and
      piecewise-constant semantic maps (K1 and K2 launches 6 each per
      step), each step's ``repaired_gt`` printed; losses finite, the DCN
      offset and mask projections get non-zero gradients; then the same
      step with ``matcher='host'``, 1 warm-up and 3 timed;
  (auction) the cost batch of one flagship step ([42, 100, 32]): the
      card's assignment and ``repaired_gt`` equal the CPU's, each
      problem's total cost within G_valid * eps of scipy's optimum, a run
      capped at one iteration completed by the repair; iterations, host
      reads and ms per call;
  (overflow) one full-width step on a batch with a 36-class crop, which
      takes the full-width branch of ``compact_gt`` on the card; the
      losses at ``compact_gt=32`` against full width (rel 1e-6) on a
      normal batch and on that one;
  (small train) a tiny model's ``total`` loss over 3 steps on the card
      against the CPU's, with the auction and with the host matcher;
  (train cli) the train CLI (``tools.train.main``) at full width on a
      seeded ADE20K-layout tree (12 training images, the 3 val images of
      (eval)) at the preset's defaults: 10 iterations with a checkpoint
      and a val (3 images, an overlay each) every 5, keeping 1, then
      ``--resume`` to 14.  Every logged loss finite; K1 and K2 6 launches
      a train iteration, K1 6 a val image; exactly the files expected;
      each checkpoint, written in the background while the next steps
      update the state in place, equal to the state at its step, and the
      resumed state equal to the file it read, bit for bit; the eval
      CLI's ``--checkpoint best/ckpt_N`` prints the mIoU that the train
      CLI printed at N.  Printed: each log record's s/iter, the steady
      s/iter beside (train)'s step ms, the loader's batches/s alone, the
      step on the loader's batches from memory and under a live loader,
      a save's inline copy ms, write ms and MB;
  (reference) a tiny reference-format state dict
      (``tests/torch_golden.py``'s ``GoldenSpike2Former``) through
      ``load_reference_model`` onto the card, logits against the CPU's,
      and through the eval CLI's ``--torch-checkpoint`` on the card.

It then prints the ``kernels`` JSON line, the ``nvidia-smi`` name and power
limit, and as its last line ``{"ok": true, "device": {...}}``.  Any failed
phase raises, so the script exits non-zero and prints no result; it also
exits non-zero when no CUDA device is available.
"""
from __future__ import annotations

import contextlib
import copy
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch
import torch.nn.functional as F

from spike2former_tpu_torch import api
from spike2former_tpu_torch.data.dataset import make_dataset
from spike2former_tpu_torch.data.loader import TrainLoader
from spike2former_tpu_torch.data.synthetic import (ADE_LIKE_SHAPES,
                                                    synthetic_batch,
                                                    write_ade_tree)
from spike2former_tpu_torch.device import f32_precision
from spike2former_tpu_torch.engine import checkpoint
from spike2former_tpu_torch.engine.checkpoint import load_reference_model
from spike2former_tpu_torch.engine.config import TestConfig
from spike2former_tpu_torch.engine.logging import read_scalars
from spike2former_tpu_torch.engine.inference import (postprocess_pred,
                                                      slide_origins,
                                                      whole_logits)
from spike2former_tpu_torch.engine.weights import randomize_
from spike2former_tpu_torch.losses import criterion
from spike2former_tpu_torch.losses import matcher
from spike2former_tpu_torch.losses.matcher import BIG_COST, auction_match
from spike2former_tpu_torch.models.segmentor import Spike2Former, preprocess
from spike2former_tpu_torch.ops import cuda_build, dcnv3, dcnv3_grouped
from spike2former_tpu_torch.profile_train import sync_sites
from spike2former_tpu_torch.tools import test as eval_cli
from spike2former_tpu_torch.tools import train as train_cli

PRESET = "SDTv2_maskformer_DCNpixelDecoder_ade20k"
KERNEL_TOL = 2e-5     # f32 sampler against its plain version
# K2 against its plain version: tests/test_dcnv3.py's backward tolerance;
# the kernel's atomics sum dvalue in a varying order
BWD_ATOL, BWD_RTOL = 3e-4, 1e-3
MODEL_TOL = 1e-3      # tiny-model logits, card against CPU
# tiny-model ``total`` loss after 3 train steps, card against CPU: the
# end-to-end tolerance of the inference check
TRAIN_RTOL = 1e-3
WARMUP_STEPS, TIMED_STEPS = 2, 5
HOST_WARMUP_STEPS, HOST_TIMED_STEPS = 1, 3
EVAL_PASSES = 3               # timed passes over the eval tree per mode
AUCTION_EPS = 0.02            # auction_match's eps: the optimality bound
# the auction's chunk schedules timed against each other: (first, most)
# iterations between reads of the loop condition
AUCTION_CHUNKS = ((4, 512), (8, 8), (16, 16), (4, 16))
COMPACT_RTOL = 1e-6           # compact_gt losses against full width
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12     # H100 SXM f32, outside the tensor cores
REQUEST_SHAPES = ((512, 683), (683, 512), (512, 512))
FLUSH_BYTES = 128 * 2 ** 20   # more than the H100's 50 MB L2
TINY = dict(num_classes=5, embed_dim=(8, 16, 24, 32), backbone_heads=4,
            feat_channels=16, num_queries=4, num_decoder_layers=1,
            num_encoder_layers=1, depths_stage3=1, depths_stage4=1,
            dcn_group=4)

T0 = time.perf_counter()


def log(phase: str, msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f}s] {phase}: {msg}", flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def cuda_ms(fn, iters: int = 100, warmup: int = 5, cold: bool = False
            ) -> float:
    """Mean device ms of ``fn`` over ``iters`` calls.  A spin kernel holds
    the device first, so the host enqueues every call before the timed
    work starts and the events time device work, not the host's per-call
    cost.  ``cold``: a 128 MB buffer is written before each call, and only
    the calls are timed, so each finds its inputs in device memory, not in
    L2."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if not cold:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200_000_000)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    buf = torch.empty(FLUSH_BYTES // 4, device="cuda")
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(200_000_000)
    for i, (start, end) in enumerate(events):
        buf.fill_(float(i))
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def median_ms(fn, reps: int = 5) -> float:
    """Median over ``reps`` runs of ``cuda_ms``."""
    return statistics.median(cuda_ms(fn) for _ in range(reps))


def host_ms(fn, iters: int = 100) -> float:
    """Mean wall ms per call, host overhead included, as the main path
    pays it."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / iters


def grid_sample_yardstick(value, py, px, mask):
    """The same function by ``F.grid_sample``: timed only, never called by
    the port."""
    n, h, w, c = value.shape
    _, howo, g, p = py.shape
    cg = c // g
    feat = value.view(n, h, w, g, cg).permute(0, 3, 4, 1, 2).reshape(
        n * g, cg, h, w)
    grid = torch.stack(((px + 0.5) / w * 2 - 1, (py + 0.5) / h * 2 - 1), -1)
    grid = grid.permute(0, 2, 1, 3, 4).reshape(n * g, howo, p, 2)
    s = F.grid_sample(feat, grid, mode="bilinear", padding_mode="zeros",
                      align_corners=False)              # [n*g, cg, howo, p]
    m = mask.permute(0, 2, 1, 3).reshape(n * g, 1, howo, p)
    out = (s * m).sum(-1)
    return out.view(n, g, cg, howo).permute(0, 3, 1, 2).reshape(n, howo, c)


def sampler_inputs(n, h, w, g, cg, p, kind, gen, device="cuda"):
    """value [N, H, W, G*Cg] and [N, HoWo, G, P] coordinates and mask
    around each output pixel's 3x3 grid.  ``kind``: 'random' offsets
    (3 px standard deviation: some taps leave the map), 'far' offsets
    (uniform in +-10 px: most taps leave a band's halo), 'zero' offsets
    (every coordinate an exact integer, one-hot centre mask: the
    identity), 'integer' offsets (exact integer coordinates, random
    mask)."""
    value = torch.randn((n, h, w, g * cg), generator=gen)
    k = int(round(p ** 0.5))
    ii, jj = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    kx, ky = torch.meshgrid(torch.arange(k), torch.arange(k), indexing="ij")
    by = (ii.reshape(-1, 1) + ky.reshape(1, -1) - k // 2).float()
    bx = (jj.reshape(-1, 1) + kx.reshape(1, -1) - k // 2).float()
    shape = (n, h * w, g, p)
    by = by[None, :, None].expand(shape)
    bx = bx[None, :, None].expand(shape)
    mask = torch.rand(shape, generator=gen)
    if kind == "random":
        py = by + 3 * torch.randn(shape, generator=gen)
        px = bx + 3 * torch.randn(shape, generator=gen)
    elif kind == "far":
        py = by + 20 * torch.rand(shape, generator=gen) - 10
        px = bx + 20 * torch.rand(shape, generator=gen) - 10
    elif kind == "integer":
        py = by + torch.randint(-3, 4, shape, generator=gen).float()
        px = bx + torch.randint(-3, 4, shape, generator=gen).float()
    elif kind == "zero":
        py, px = by.clone(), bx.clone()
        mask = torch.zeros(shape)
        mask[..., p // 2] = 1.0
    else:
        raise ValueError(kind)
    return tuple(t.contiguous().to(device) for t in (value, py, px, mask))


def sampler_bytes(value, py, out_elems):
    return 4 * (value.numel() + 3 * py.numel() + out_elems)


# the flagship's /16 maps of a request (N=1, 2 at 32x44) and of a train
# step (N=6 at 32x32), and a 64x128 map (a 1024x2048 image's), on which no
# group fits one block of K2 and both kernels run bands with halos
KERNEL_SHAPES = ((1, 32, 44), (2, 32, 44), (6, 32, 32), (1, 64, 128))
# coordinates 3 px off their grid, up to 10 px off (most taps leave a
# band's halo), zero offsets (exact integers, the identity), integer offsets
KINDS = ("random", "far", "zero", "integer")
CHANNELS = (1, 2, 4, 8, 16, 32)    # the kernels' channels a group


def phase_kernel(gen) -> dict:
    """(c): K1 against plain on ``KERNEL_SHAPES`` for each of ``KINDS``;
    its time with a warm and a cold L2 beside the grouped forward's on the
    same data, the plain time, the yardstick and the byte bound."""
    g, cg, p = 32, 8, 9
    worst = 0.0
    rec = {}
    for n, h, w in KERNEL_SHAPES:
        plan = dcnv3.tile_plan(n, h, w, h * w, g, cg, p, backward=False)
        log("kernel", f"N={n} {h}x{w}: tile plan {plan}, "
            f"{plan.smem_bytes(w, cg, p, backward=False)} bytes of shared "
            "memory a block")
        for kind in KINDS:
            value, py, px, mask = sampler_inputs(n, h, w, g, cg, p, kind, gen)
            got = dcnv3.dcnv3_sample(value, py, px, mask)
            torch.cuda.synchronize()
            want = dcnv3.dcnv3_sample_reference(value, py, px, mask)
            err = (got - want).abs().max().item()
            check(bool(torch.isfinite(got).all()), f"non-finite kernel out "
                  f"({kind}, N={n} {h}x{w})")
            check(err <= KERNEL_TOL, f"kernel vs plain {err:.3g} > "
                  f"{KERNEL_TOL} ({kind}, N={n} {h}x{w})")
            if kind == "zero":
                ident = (got - value.reshape(got.shape)).abs().max().item()
                check(ident <= KERNEL_TOL, f"identity case off by {ident:.3g}")
            worst = max(worst, err)
            log("kernel", f"N={n} {h}x{w} G={g} Cg={cg} P={p} {kind}: "
                f"max|kernel-plain|={err:.3g}")
        if h * w > 32 * 44:
            continue
        value, py, px, mask = sampler_inputs(n, h, w, g, cg, p, "random", gen)
        lib_err = (grid_sample_yardstick(value, py, px, mask)
                   - dcnv3.dcnv3_sample_reference(value, py, px, mask)
                   ).abs().max().item()
        out_elems = n * h * w * g * cg
        bytes_ = sampler_bytes(value, py, out_elems)
        flops = n * h * w * g * p * (4 * cg * 2 + 16)

        def k1():
            return dcnv3.dcnv3_sample(value, py, px, mask)

        t = dict(
            ms=median_ms(k1),
            cold_ms=cuda_ms(k1, cold=True),
            plain_ms=cuda_ms(lambda: dcnv3.dcnv3_sample_reference(
                value, py, px, mask), iters=20),
            library_ms=cuda_ms(lambda: grid_sample_yardstick(
                value, py, px, mask), iters=20),
            bytes_ms=bytes_ / HBM_BYTES_PER_S * 1e3,
            ops_ms=flops / F32_FLOPS_PER_S * 1e3,
            wall_ms=host_ms(k1))
        log("kernel", f"N={n} {h}x{w} timing: kernel_ms={t['ms']:.5f} "
            f"cold_l2_ms={t['cold_ms']:.5f} plain_ms={t['plain_ms']:.5f} "
            f"library_ms={t['library_ms']:.5f} "
            f"(grid_sample max|diff|={lib_err:.3g}) "
            f"byte_bound_us={t['bytes_ms'] * 1e3:.3f} "
            f"op_bound_us={t['ops_ms'] * 1e3:.3f} "
            f"wrapper_wall_ms={t['wall_ms']:.5f}")
        rec[n] = t
    rec["max_abs_err"] = worst
    return rec


def phase_serve(im) -> dict:
    """(d) and (e): three flagship requests through the user entry point."""
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
            for hw in REQUEST_SHAPES]

    zero_launches()
    preds = [api.inference_model(im, img) for img in imgs]
    torch.cuda.synchronize()
    launches = dcnv3.dcnv3_sample.launches
    grouped = grouped_launches()
    log("serve", f"3 requests served; dcnv3_sample launches={launches}, "
        f"grouped forward/backward launches={grouped}")
    check(launches == 6 * len(imgs),
          f"expected {6 * len(imgs)} DCN kernel launches, got {launches}")
    for img, pred in zip(imgs, preds):
        check(pred.shape == img.shape[:2] and pred.dtype == np.int32,
              f"pred {pred.shape} {pred.dtype} for image {img.shape}")
        check(0 <= pred.min() and pred.max() < im.num_classes,
              "class ids out of range")
        log("serve", f"image {img.shape[:2]} -> classes in use "
            f"{len(np.unique(pred))}")

    # logits of one request are finite and of the expected shape
    x = torch.zeros((1, 512, 704, 3), dtype=torch.uint8, device="cuda")
    x[:, :, :683] = torch.from_numpy(imgs[0]).cuda()
    logits = whole_logits(im.model, x)
    check(tuple(logits.shape) == (1, 512, 704, im.num_classes)
          and bool(torch.isfinite(logits).all()), "bad logits")

    # the kernel against its plain version at each DCN call of a request
    real = dcnv3.dcnv3_sample
    calls = []

    def capture(value, py, px, mask):
        out = real(value, py, px, mask)
        calls.append((value.clone(), py.clone(), px.clone(), mask.clone(),
                      out.clone()))
        return out

    dcnv3.dcnv3_sample = capture
    try:
        api.inference_model(im, imgs[0])
    finally:
        dcnv3.dcnv3_sample = real
    check(len(calls) == 6, f"captured {len(calls)} DCN calls, expected 6")
    worst = 0.0
    for i, (value, py, px, mask, out) in enumerate(calls):
        err = (out - dcnv3.dcnv3_sample_reference(value, py, px, mask)
               ).abs().max().item()
        live = (mask != 0).float().mean().item()
        log("serve", f"DCN call {i}: value {tuple(value.shape)} "
            f"max|kernel-plain|={err:.3g} mask nonzero={live:.3f}")
        check(err <= KERNEL_TOL, f"DCN call {i}: {err:.3g} > {KERNEL_TOL}")
        worst = max(worst, err)

    # (e) timing after warm-up
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(10):
        for img in imgs:
            torch.cuda.synchronize()
            t = time.perf_counter()
            api.inference_model(im, img)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
    return dict(launches=launches, grouped=grouped, max_abs_err=worst,
                request_ms=statistics.median(times), max_ms=max(times),
                n=len(times),
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)


def phase_small_reference() -> float:
    """A tiny model's logits on the card (kernel path) against the same
    model on the CPU (plain path) at 64x64, in f32 as the entry points
    run it (this calls below them)."""
    cpu = randomize_(Spike2Former(T=1, **TINY), seed=1)
    gpu = copy.deepcopy(cpu).cuda()
    x = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (1, 64, 64, 3)).astype(np.float32))
    with torch.inference_mode(), f32_precision():
        want = cpu.predict_logits(x)
        got = gpu.predict_logits(x.cuda()).cpu()
    err = (got - want).abs().max().item()
    check(torch.allclose(got, want, atol=MODEL_TOL, rtol=MODEL_TOL),
          f"tiny model card vs CPU: max|diff|={err:.3g}")
    return err


def phase_backward_kernel(gen) -> dict:
    """(k2): K2 against plain at the flagship train shape (/16 of a 512
    crop, batch 6) and on the 64x128 map, for each of ``KINDS``; its time
    at the train shape with a warm and a cold L2."""
    g, cg, p = 32, 8, 9
    worst = 0.0
    for n, h, w in ((6, 32, 32), (1, 64, 128)):
        plan = dcnv3.tile_plan(n, h, w, h * w, g, cg, p, backward=True)
        log("k2", f"N={n} {h}x{w}: tile plan {plan}, "
            f"{plan.smem_bytes(w, cg, p, backward=True)} bytes of shared "
            f"memory a block, {n * g // plan.groups * plan.bands} blocks, "
            f"whole map {plan.whole(h)}")
        for kind in KINDS:
            value, py, px, mask = sampler_inputs(n, h, w, g, cg, p, kind,
                                                 gen)
            dout = torch.randn((n, h * w, g * cg), generator=gen).cuda()
            got = dcnv3.dcnv3_sample_backward(value, py, px, mask, dout)
            torch.cuda.synchronize()
            want = dcnv3.dcnv3_sample_backward_reference(value, py, px,
                                                         mask, dout)
            errs = []
            for name, gv, wv in zip(("dvalue", "dpy", "dpx", "dmask"), got,
                                    want):
                check(bool(torch.isfinite(gv).all()),
                      f"non-finite K2 {name} ({kind}, {h}x{w})")
                check(torch.allclose(gv, wv, atol=BWD_ATOL, rtol=BWD_RTOL),
                      f"K2 {name} vs plain beyond atol {BWD_ATOL} rtol "
                      f"{BWD_RTOL} ({kind}, {h}x{w}): "
                      f"{(gv - wv).abs().max().item():.3g}")
                errs.append((gv - wv).abs().max().item())
                worst = max(worst, errs[-1])
            log("k2", f"N={n} {h}x{w} G={g} Cg={cg} P={p} {kind}: "
                f"max|kernel-plain| dvalue={errs[0]:.3g} dpy={errs[1]:.3g} "
                f"dpx={errs[2]:.3g} dmask={errs[3]:.3g}")

    n, h, w = 6, 32, 32
    value, py, px, mask = sampler_inputs(n, h, w, g, cg, p, "random", gen)
    dout = torch.randn((n, h * w, g * cg), generator=gen).cuda()
    # the yardstick: F.grid_sample's backward and the weighted sum's,
    # through autograd on a graph built once
    ins = [t.clone().requires_grad_() for t in (value, py, px, mask)]
    lib_out = grid_sample_yardstick(*ins)
    lib_grads = torch.autograd.grad(lib_out, ins, dout, retain_graph=True)
    want = dcnv3.dcnv3_sample_backward_reference(value, py, px, mask, dout)
    lib_err = " ".join(f"{name}={(a - b).abs().max().item():.3g}"
                       for name, a, b in zip(("dvalue", "dpy", "dpx",
                                              "dmask"), lib_grads, want))
    coords = py.numel()
    bytes_ = 4 * (2 * value.numel() + 6 * coords + dout.numel())
    flops = coords * (4 * 4 * cg + 40)
    def k2():
        return dcnv3.dcnv3_sample_backward(value, py, px, mask, dout)

    t = dict(
        ms=median_ms(k2),
        cold_ms=cuda_ms(k2, cold=True),
        plain_ms=cuda_ms(lambda: dcnv3.dcnv3_sample_backward_reference(
            value, py, px, mask, dout), iters=10),
        library_ms=cuda_ms(lambda: torch.autograd.grad(
            lib_out, ins, dout, retain_graph=True), iters=20),
        bytes_ms=bytes_ / HBM_BYTES_PER_S * 1e3,
        ops_ms=flops / F32_FLOPS_PER_S * 1e3,
        wall_ms=host_ms(k2),
        max_abs_err=worst)
    log("k2", f"N={n} timing: kernel_ms={t['ms']:.5f} "
        f"cold_l2_ms={t['cold_ms']:.5f} "
        f"library/kernel={t['library_ms'] / t['ms']:.2f} "
        f"plain_ms={t['plain_ms']:.5f} library_ms={t['library_ms']:.5f} "
        f"(grid_sample backward max|diff| {lib_err}) "
        f"bytes={bytes_} byte_bound_us={t['bytes_ms'] * 1e3:.3f} "
        f"op_bound_us={t['ops_ms'] * 1e3:.3f} "
        f"wrapper_wall_ms={t['wall_ms']:.5f}")
    return t


def phase_core_autograd(gen) -> float:
    """(grad): gradients to x, offset and mask through ``dcnv3_core`` at
    the flagship train shape, through K1 and K2, against autograd of the
    plain sampler on the same card tensors.  This holds the wiring of the
    autograd function: the order of its inputs, dpy against dpx, and the
    sign of the coordinate gradient.  On the 64x128 map, with offsets
    uniform in +-10 px, K2 runs bands with halos and spills."""
    g, cg, p = 32, 8, 9
    worst = 0.0
    for n, h, w, kind in ((6, 32, 32, "random"), (6, 32, 32, "zero"),
                          (1, 64, 128, "far")):
        x = torch.randn((n, h, w, g * cg), generator=gen).cuda()
        shape = (n, h, w, g * p * 2)
        offset = {"random": lambda: 3 * torch.randn(shape, generator=gen),
                  "zero": lambda: torch.zeros(shape),
                  "far": lambda: 20 * torch.rand(shape, generator=gen) - 10,
                  }[kind]().cuda()
        mask = torch.rand((n, h, w, g * p), generator=gen).cuda()
        dout = torch.randn((n, h, w, g * cg), generator=gen).cuda()
        fwd, bwd = (dcnv3.dcnv3_sample.launches,
                    dcnv3.dcnv3_sample_backward.launches)
        grads = []
        kernel = dcnv3.dcnv3_sample
        for sampler in (kernel, dcnv3.dcnv3_sample_reference):
            ins = [t.clone().requires_grad_() for t in (x, offset, mask)]
            dcnv3.dcnv3_sample = sampler
            try:
                out = dcnv3.dcnv3_core(*ins, group=g, group_channels=cg)
            finally:
                dcnv3.dcnv3_sample = kernel
            grads.append(torch.autograd.grad(out, ins, dout))
        check(dcnv3.dcnv3_sample.launches == fwd + 1
              and dcnv3.dcnv3_sample_backward.launches == bwd + 1,
              f"dcnv3_core autograd ({kind}) did not run K1 and K2 once")
        errs = []
        for name, gv, wv in zip(("x", "offset", "mask"), *grads):
            errs.append((gv - wv).abs().max().item())
            check(torch.allclose(gv, wv, atol=BWD_ATOL, rtol=BWD_RTOL),
                  f"dcnv3_core d{name} ({kind}) kernel vs plain beyond atol "
                  f"{BWD_ATOL} rtol {BWD_RTOL}: {errs[-1]:.3g}")
            check(wv.abs().max().item() > 0, f"d{name} ({kind}) is all 0")
        worst = max(worst, *errs)
        log("grad", f"dcnv3_core x {tuple(x.shape)} {kind} offsets: "
            f"max|kernel-plain| dx={errs[0]:.3g} doffset={errs[1]:.3g} "
            f"dmask={errs[2]:.3g}")
    return worst


# the grouped-layout sampler (K3-K7) at the shapes the flagship's DCN
# layers would hand it: a request's and a train step's /16 map
GROUPED_SHAPES = (("serve", 1, 32, 44), ("train", 6, 32, 32))
GROUPED_FORWARD = {  # JAX name -> (K number, output layout)
    "dcnv3_sample_pallas_t": ("K3", "gchw"),
    "dcnv3_sample_pallas": ("K4", "ghwc"),
    "dcnv3_sample_pallas_t4": ("K5", "gchw"),
    "dcnv3_sample_pallas_tg": ("K6", "gchw"),
}
GROUPED_BACKWARD = "dcnv3_sample_pallas_t_bwd"   # K7
# each TPU kernel's wrapper line in spike2former_tpu/ops/pallas/dcnv3_kernel.py
TPU_LINE = {"dcnv3_sample_pallas_t5": 440, "dcnv3_sample_pallas_t5_bwd": 773,
            "dcnv3_sample_pallas_t": 125, "dcnv3_sample_pallas": 197,
            "dcnv3_sample_pallas_t4": 307, "dcnv3_sample_pallas_tg": 566,
            "dcnv3_sample_pallas_t_bwd": 954}


def to_grouped(value, py, px, mask, dout=None):
    """K1's layout -> the grouped one: value [N, H, W, G*Cg] -> feat
    [N, G, H, W*Cg]; [N, HoWo, G, P] -> [N, G, P, HoWo]; dout
    [N, HoWo, G*Cg] -> [N, G, Cg, HoWo]."""
    n, h, w, c = value.shape
    _, howo, g, p = py.shape
    cg = c // g
    feat = value.view(n, h, w, g, cg).permute(0, 3, 1, 2, 4).reshape(
        n, g, h, w * cg)
    out = [feat] + [t.permute(0, 2, 3, 1) for t in (py, px, mask)]
    if dout is not None:
        out.append(dout.view(n, howo, g, cg).permute(0, 2, 3, 1))
    return [t.contiguous() for t in out]


def grouped_yardstick(feat, py, px, mask, *, num_points, h_in, w_in, group,
                      group_channels, out_layout):
    """The grouped forward by ``F.grid_sample`` over [N*G, Cg, H, W] and
    the mask-weighted sum over P, which gives [N, G, Cg, HoWo] directly:
    timed only, never called by the port."""
    n, howo = feat.shape[0], py.shape[-1]
    ng, cg = n * group, group_channels
    x = feat.view(ng, h_in, w_in, cg).permute(0, 3, 1, 2)
    grid = torch.stack(((px + 0.5) / w_in * 2 - 1,
                        (py + 0.5) / h_in * 2 - 1), -1)
    s = F.grid_sample(x, grid.view(ng, num_points, howo, 2),
                      mode="bilinear", padding_mode="zeros",
                      align_corners=False)              # [NG, Cg, P, HoWo]
    out = (s * mask.view(ng, 1, num_points, howo)).sum(2).view(
        n, group, cg, howo)
    return out if out_layout == "gchw" else out.transpose(2, 3).contiguous()


def grouped_launches() -> tuple[int, int]:
    return (dcnv3_grouped.dcnv3_sample_grouped.launches,
            dcnv3_grouped.dcnv3_sample_grouped_backward.launches)


def zero_launches() -> None:
    """Set every kernel's launch count to 0."""
    dcnv3.dcnv3_sample.launches = 0
    dcnv3.dcnv3_sample_backward.launches = 0
    dcnv3_grouped.dcnv3_sample_grouped.launches = 0
    dcnv3_grouped.dcnv3_sample_grouped_backward.launches = 0


def read_launches() -> dict:
    return dict(k1=dcnv3.dcnv3_sample.launches,
                k2=dcnv3.dcnv3_sample_backward.launches,
                grouped=grouped_launches())


# the grouped kernels' checks: the flagship shapes at Cg=8 for every kind
# of coordinates; G=4 at every Cg on a map staged in bands of rows with
# halos (64x128), one too wide to stage at Cg >= 8 (8x2048) and one that a
# single backward band owns whole (9x13)
GROUPED_KINDS = ("random", "far", "offmap", "zero", "integer", "nan")
GROUPED_MAPS = ((1, 64, 128), (1, 8, 2048), (2, 9, 13))
GROUPED_MAP_KINDS = ("random", "offmap", "zero", "nan")


def grouped_inputs(n, h, w, g, cg, kind, gen, device="cuda"):
    """``sampler_inputs`` and a dout [N, HoWo, G*Cg] in K1's layout, and
    the points that the kernels drop, for ``KINDS`` and 'offmap'
    (coordinates spread over and 4 px off the map) and 'nan' ('random'
    with every 7th py and every 11th px NaN)."""
    base = {"offmap": "far", "nan": "random"}.get(kind, kind)
    value, py, px, mask = sampler_inputs(n, h, w, g, cg, 9, base, gen,
                                         device)
    if kind == "offmap":
        py = (torch.rand(py.shape, generator=gen) * (h + 8) - 4).to(device)
        px = (torch.rand(px.shape, generator=gen) * (w + 8) - 4).to(device)
    if kind == "nan":
        py.view(-1)[::7] = float("nan")
        px.view(-1)[::11] = float("nan")
    dout = torch.randn((n, h * w, g * cg), generator=gen).to(device)
    return (value, py, px, mask, dout), py.isnan() | px.isnan()


def plain_dropping(value, py, px, mask, dout, dropped):
    """The plain forward and backward (K1's layout) with the dropped
    points taken out: mask 0 and coordinates 0 there, and zero coordinate
    and mask gradients (the plain versions index with the coordinates, so
    they take no NaN)."""
    keep = ~dropped
    py0, px0 = (torch.where(keep, t, 0.0) for t in (py, px))
    m0 = mask * keep
    out = dcnv3.dcnv3_sample_reference(value, py0, px0, m0)
    dvalue, *dc = dcnv3.dcnv3_sample_backward_reference(value, py0, px0, m0,
                                                        dout)
    return out, (dvalue, *(t * keep for t in dc))


def check_grouped(n, h, w, g, cg, kind, gen) -> dict:
    """The grouped forward in both layouts and the grouped backward on
    one case, each against the plain version and K1/K2 on the same data;
    returns the largest differences by JAX name."""
    flat, dropped = grouped_inputs(n, h, w, g, cg, kind, gen)
    want, want_b = plain_dropping(*flat, dropped)
    k1 = dcnv3.dcnv3_sample(*flat[:4]).view(n, h * w, g, cg)
    k2 = to_grouped(*dcnv3.dcnv3_sample_backward(*flat))
    feat, py, px, mask, dout = to_grouped(*flat)
    static = dict(num_points=9, h_in=h, w_in=w, group=g, group_channels=cg)
    case = f"N={n} {h}x{w} G={g} Cg={cg} {kind}"
    errs = {}
    for name, (k, layout) in GROUPED_FORWARD.items():
        got = dcnv3_grouped.JAX_COUNTERPARTS[name](feat, py, px, mask,
                                                   **static)
        torch.cuda.synchronize()
        order = (0, 2, 3, 1) if layout == "gchw" else (0, 2, 1, 3)
        check(bool(torch.isfinite(got).all()), f"non-finite {k} ({case})")
        e_plain = (got - want.view(n, h * w, g, cg).permute(order)
                   ).abs().max().item()
        e_k1 = (got - k1.permute(order)).abs().max().item()
        check(e_plain <= KERNEL_TOL and e_k1 <= KERNEL_TOL,
              f"{k} ({layout}) vs plain {e_plain:.3g}, vs K1 {e_k1:.3g} > "
              f"{KERNEL_TOL} ({case})")
        errs[name] = max(e_plain, e_k1)
    got = dcnv3_grouped.dcnv3_sample_grouped_backward(feat, py, px, mask,
                                                      dout, **static)
    torch.cuda.synchronize()
    errs[GROUPED_BACKWARD] = 0.0
    for ref, other in ((to_grouped(*want_b), "plain"), (k2, "K2")):
        for gname, gv, wv in zip(("dfeat", "dpy", "dpx", "dmask"), got, ref):
            check(bool(torch.isfinite(gv).all()),
                  f"non-finite K7 {gname} ({case})")
            err = (gv - wv).abs().max().item()
            check(torch.allclose(gv, wv, atol=BWD_ATOL, rtol=BWD_RTOL),
                  f"K7 {gname} vs {other} beyond atol {BWD_ATOL} rtol "
                  f"{BWD_RTOL} ({case}): {err:.3g}")
            errs[GROUPED_BACKWARD] = max(errs[GROUPED_BACKWARD], err)
    return errs


def phase_grouped(gen) -> dict:
    """(grouped): the grouped-layout forward kernel in both layouts (the
    counterparts of K3, K4, K5 and K6) and its backward kernel (K7) under
    their plans, each against its plain version and against K1/K2 on the
    same data; autograd of both layouts at the train shape; the timings
    at both flagship shapes, warm and cold, beside K1's and K2's."""
    g, cg, p = 32, 8, 9
    fwd = dcnv3_grouped.JAX_COUNTERPARTS
    bwd = dcnv3_grouped.dcnv3_sample_grouped_backward
    errs = {name: 0.0 for name in (*GROUPED_FORWARD, GROUPED_BACKWARD)}

    def record(e):
        for name, err in e.items():
            errs[name] = max(errs[name], err)

    for shape, n, h, w in GROUPED_SHAPES:
        for kind in GROUPED_KINDS:
            record(check_grouped(n, h, w, g, cg, kind, gen))
        plans = [dcnv3_grouped.grouped_tile_plan(n, h, w, h * w, g, cg,
                                                 backward=b)
                 for b in (False, True)]
        log("grouped", f"{shape} N={n} {h}x{w} G={g} Cg={cg}, kinds "
            f"{GROUPED_KINDS}: plans forward {plans[0]}, backward "
            f"{plans[1]}; max|kernel-ref| so far {errs}")
    for n, h, w in GROUPED_MAPS:
        for c in CHANNELS:
            for kind in GROUPED_MAP_KINDS:
                record(check_grouped(n, h, w, 4, c, kind, gen))
        log("grouped", f"N={n} {h}x{w} G=4 Cg {CHANNELS}, kinds "
            f"{GROUPED_MAP_KINDS}: max|kernel-ref| so far {errs}")

    times = {}
    for shape, n, h, w in GROUPED_SHAPES:
        howo = h * w
        static = dict(num_points=p, h_in=h, w_in=w, group=g,
                      group_channels=cg)
        flat = sampler_inputs(n, h, w, g, cg, p, "random", gen)
        dout_flat = torch.randn((n, howo, g * cg), generator=gen).cuda()
        ins = to_grouped(*flat)
        feat, py = ins[:2]
        dout = to_grouped(*flat, dout_flat)[4]
        if shape == "train":
            # autograd of both layouts against the plain version's
            for name in ("dcnv3_sample_pallas_t", "dcnv3_sample_pallas"):
                k, layout = GROUPED_FORWARD[name]
                before = grouped_launches()
                cot = torch.randn((n, g, cg, howo), generator=gen).cuda()
                if layout == "ghwc":
                    cot = cot.transpose(2, 3).contiguous()
                grads = []
                for fn in (dcnv3_grouped.dcnv3_sample_grouped,
                           dcnv3_grouped.dcnv3_sample_grouped_reference):
                    leaves = [t.clone().requires_grad_() for t in ins]
                    out = fn(*leaves, **static, out_layout=layout)
                    grads.append(torch.autograd.grad(out, leaves, cot))
                check(grouped_launches() == (before[0] + 1, before[1] + 1),
                      f"{layout} autograd did not run the grouped kernels "
                      "once each")
                line = []
                for gname, gv, wv in zip(("dfeat", "dpy", "dpx", "dmask"),
                                         *grads):
                    err = (gv - wv).abs().max().item()
                    check(torch.allclose(gv, wv, atol=BWD_ATOL,
                                         rtol=BWD_RTOL),
                          f"{layout} autograd {gname} kernel vs plain "
                          f"beyond atol {BWD_ATOL} rtol {BWD_RTOL}: "
                          f"{err:.3g}")
                    check(wv.abs().max().item() > 0, f"{gname} is all 0")
                    errs[name] = max(errs[name], err)
                    line.append(f"{gname} {err:.3g}")
                log("grouped", f"autograd {k} {layout} {shape} N={n}: "
                    "max|kernel-plain| " + ", ".join(line))

        # K1 and K2 on the same data, warm and cold
        def k1():
            return dcnv3.dcnv3_sample(*flat)

        def k2():
            return dcnv3.dcnv3_sample_backward(*flat, dout_flat)

        times["K1", shape] = dict(ms=median_ms(k1),
                                  cold_ms=cuda_ms(k1, cold=True))
        times["K2", shape] = dict(ms=median_ms(k2),
                                  cold_ms=cuda_ms(k2, cold=True))
        out_elems = n * g * cg * howo
        for name, (k, layout) in GROUPED_FORWARD.items():
            def kernel():
                return fwd[name](*ins, **static)

            t = dict(
                ms=median_ms(kernel),
                cold_ms=cuda_ms(kernel, cold=True),
                plain_ms=cuda_ms(lambda: dcnv3_grouped
                                 .dcnv3_sample_grouped_reference(
                                     *ins, **static, out_layout=layout),
                                 iters=20),
                library_ms=cuda_ms(lambda: grouped_yardstick(
                    *ins, **static, out_layout=layout), iters=20),
                bytes_ms=sampler_bytes(feat, py, out_elems)
                / HBM_BYTES_PER_S * 1e3,
                ops_ms=n * howo * g * p * (4 * cg * 2 + 16)
                / F32_FLOPS_PER_S * 1e3)
            times[name, shape] = t
            lib_err = (grouped_yardstick(*ins, **static, out_layout=layout)
                       - dcnv3_grouped.dcnv3_sample_grouped_reference(
                           *ins, **static, out_layout=layout)
                       ).abs().max().item()
            k1t = times["K1", shape]
            log("grouped", f"{k} {name} {layout} {shape} N={n} timing: "
                f"kernel_ms={t['ms']:.5f} cold_l2_ms={t['cold_ms']:.5f} "
                f"K1_ms={k1t['ms']:.5f} (cold {k1t['cold_ms']:.5f}) "
                f"kernel/K1 {t['ms'] / k1t['ms']:.3f} (cold "
                f"{t['cold_ms'] / k1t['cold_ms']:.3f}) "
                f"plain_ms={t['plain_ms']:.5f} "
                f"library_ms={t['library_ms']:.5f} "
                f"(grid_sample max|diff|={lib_err:.3g}) "
                f"byte_bound_us={t['bytes_ms'] * 1e3:.3f} "
                f"op_bound_us={t['ops_ms'] * 1e3:.3f} share of bound "
                f"{t['bytes_ms'] / t['ms']:.3f}")
        lib_ins = [t.clone().requires_grad_() for t in ins]
        lib_out = grouped_yardstick(*lib_ins, **static, out_layout="gchw")

        def kernel():
            return bwd(*ins, dout, **static)

        t = dict(
            ms=median_ms(kernel),
            cold_ms=cuda_ms(kernel, cold=True),
            plain_ms=cuda_ms(lambda: dcnv3_grouped
                             .dcnv3_sample_grouped_backward_reference(
                                 *ins, dout, **static), iters=10),
            library_ms=cuda_ms(lambda: torch.autograd.grad(
                lib_out, lib_ins, dout, retain_graph=True), iters=20),
            bytes_ms=4 * (2 * feat.numel() + 6 * py.numel() + dout.numel())
            / HBM_BYTES_PER_S * 1e3,
            ops_ms=py.numel() * (4 * 4 * cg + 40) / F32_FLOPS_PER_S * 1e3)
        times[GROUPED_BACKWARD, shape] = t
        k2t = times["K2", shape]
        log("grouped", f"K7 {GROUPED_BACKWARD} {shape} N={n} timing: "
            f"kernel_ms={t['ms']:.5f} cold_l2_ms={t['cold_ms']:.5f} "
            f"K2_ms={k2t['ms']:.5f} (cold {k2t['cold_ms']:.5f}) "
            f"kernel/K2 {t['ms'] / k2t['ms']:.3f} (cold "
            f"{t['cold_ms'] / k2t['cold_ms']:.3f}) "
            f"plain_ms={t['plain_ms']:.5f} "
            f"library_ms={t['library_ms']:.5f} "
            f"byte_bound_us={t['bytes_ms'] * 1e3:.3f} "
            f"op_bound_us={t['ops_ms'] * 1e3:.3f} share of bound "
            f"{t['bytes_ms'] / t['ms']:.3f}")
    return dict(errs=errs, times=times)


@contextlib.contextmanager
def tf32(matmul: bool, cudnn: bool):
    """Set the TF32 flags of matmuls and cuDNN for a block, then restore
    them."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = matmul
    torch.backends.cudnn.allow_tf32 = cudnn
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def phase_tf32(im) -> dict:
    """(tf32): what TF32 does to the flagship's logits and class maps.
    ``whole_logits``, which sets no precision itself, runs on the three
    serve images in full f32, with torch's default flags (TF32 on for
    cuDNN only) and with TF32 on for both; each is held to f32 by the
    share of pixels whose class agrees and the largest logit difference.
    The tiny model's card logits in each mode are held to the CPU's."""
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
            for hw in REQUEST_SHAPES]
    modes = {"f32": (False, False), "default": (False, True),
             "tf32": (True, True)}
    res = {}
    for img in imgs:
        padded, hw = api.resize_and_pad(im.cfg, img)
        x = torch.from_numpy(padded[None]).cuda()
        out = {}
        for mode, flags in modes.items():
            with tf32(*flags):
                logits = whole_logits(im.model, x)
            out[mode] = logits, postprocess_pred(logits, hw, img.shape[:2])
        for mode in ("default", "tf32"):
            agree = (out[mode][1] == out["f32"][1]).float().mean().item()
            diff = (out[mode][0] - out["f32"][0]).abs().max().item()
            res.setdefault(mode, []).append((agree, diff))
            log("tf32", f"image {img.shape[:2]} {mode} vs f32: class "
                f"agreement {agree:.6f}, max|logit diff|={diff:.6g} "
                f"(max|logit| {out['f32'][0].abs().max().item():.6g}, "
                f"classes in use {len(out['f32'][1].unique())})")
    cpu = randomize_(Spike2Former(T=1, **TINY), seed=1)
    gpu = copy.deepcopy(cpu).cuda()
    x = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (1, 64, 64, 3)).astype(np.float32))
    with torch.inference_mode():
        want = cpu.predict_logits(x)
        for mode, flags in modes.items():
            with tf32(*flags):
                got = gpu.predict_logits(x.cuda()).cpu()
            diff = (got - want).abs().max().item()
            res["tiny_" + mode] = diff
            log("tf32", f"tiny model 64x64 card ({mode}) vs CPU: "
                f"max|logit diff|={diff:.6g} (tol {MODEL_TOL})")
    return res


# the eval modes of ``cfg.test``: whole bucketed with ``valid_hw`` (the
# preset's default), whole exact (pad to 32), slide
EVAL_MODES = {"whole_bucketed": TestConfig(mode="whole", bucket=128),
              "whole_exact": TestConfig(mode="whole", bucket=0),
              "slide": TestConfig(mode="slide", crop_size=(512, 512),
                                  stride=(341, 341))}


def phase_eval(im) -> dict:
    """(eval): the eval CLI's ``evaluate`` at full width on a seeded
    ADE20K-layout tree of the three request shapes, in each mode of
    ``EVAL_MODES``: a warm-up pass, then ``EVAL_PASSES`` timed passes with
    the launch counts set to 0 just before them."""
    out = {}
    with tempfile.TemporaryDirectory() as root:
        write_ade_tree(root, REQUEST_SHAPES, seed=0)
        ds = make_dataset("ade20k", root, "val")
        for mode, test_cfg in EVAL_MODES.items():
            cfg = copy.deepcopy(im.cfg)
            cfg.test = test_cfg
            m = api.InferenceModel(cfg, im.model, im.device)
            eval_cli.evaluate(m, ds)
            torch.cuda.synchronize()
            zero_launches()
            passes = []
            for _ in range(EVAL_PASSES):
                t = time.perf_counter()
                res = eval_cli.evaluate(m, ds)
                torch.cuda.synchronize()
                passes.append((time.perf_counter() - t) * 1e3
                              / res["images"])
            launches = read_launches()
            ms = statistics.median(passes)
            # one forward an image in whole mode; in slide mode one a
            # chunk of windows (all of an image's fit one chunk here)
            windows = [len(slide_origins(-(-h // 32) * 32, -(-w // 32) * 32,
                                         (512, 512), (341, 341)))
                       for h, w in REQUEST_SHAPES]
            forwards = res["images"] * EVAL_PASSES
            check(res["images"] == len(REQUEST_SHAPES), f"{mode}: images")
            check(launches["k1"] == 6 * forwards,
                  f"{mode}: expected {6 * forwards} K1 launches, got "
                  f"{launches['k1']}")
            for pred, hw in zip(res["preds"], REQUEST_SHAPES):
                check(pred.shape == hw and pred.min() >= 0
                      and pred.max() < im.num_classes,
                      f"{mode}: pred {pred.shape} for {hw}")
            check(np.isfinite(res["mIoU"]), f"{mode}: mIoU {res['mIoU']}")
            per_window = (f", {launches['k1'] / EVAL_PASSES / sum(windows):g}"
                          f" per window "
                          f"({sum(windows)} windows)" if mode == "slide"
                          else "")
            log("eval", f"{mode}: images {res['images']} mIoU "
                f"{res['mIoU']:.4f} mAcc {res['mAcc']:.4f} aAcc "
                f"{res['aAcc']:.4f}; {ms:.3f} ms per image (median of "
                f"{EVAL_PASSES} passes: {[round(x, 3) for x in passes]}); "
                f"K1 launches {launches['k1']} over {EVAL_PASSES} passes "
                f"({launches['k1'] / forwards:g} per image{per_window}), "
                f"grouped {launches['grouped']}")
            out[mode] = dict(res, ms=ms, launches=launches)
    agree = (sum(int((a == b).sum()) for a, b in zip(
        out["whole_bucketed"]["preds"], out["whole_exact"]["preds"]))
        / sum(h * w for h, w in REQUEST_SHAPES))
    log("eval", f"share of pixels on which bucketed and exact agree: "
        f"{agree:.6f}")
    out["agree"] = agree
    return out


@contextlib.contextmanager
def capture_auction(store: list):
    """Record the cost batch of each ``auction_match`` call the criterion
    makes."""
    real = criterion.auction_match

    def spy(costs, **kw):
        store.append(costs.detach().clone())
        return real(costs, **kw)

    criterion.auction_match = spy
    try:
        yield store
    finally:
        criterion.auction_match = real


def timed_steps(tr, batches, warmup: int, tag: str) -> dict:
    """Take one step per batch through ``api.train_steps``; the launch
    counts are set to 0 just before and read just after."""
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    times, metrics = [], []
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = api.train_steps(tr, [batch])[0]
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        metrics.append(m)
        log("train", f"{tag} step {i}{' (warm-up)' if i < warmup else ''}: "
            f"{times[-1]:.1f} ms total={m['total']:.6g} "
            f"grad_norm={m['grad_norm']:.6g} dropped_gt={m['dropped_gt']:g} "
            f"repaired_gt={m['repaired_gt']:g}")
    launches = read_launches()
    steps = len(batches)
    log("train", f"{tag}: {steps} steps, dcnv3_sample launches="
        f"{launches['k1']} ({launches['k1'] / steps:g} per step), "
        f"dcnv3_sample_bwd launches={launches['k2']} "
        f"({launches['k2'] / steps:g} per step), grouped forward/backward "
        f"launches={launches['grouped']}")
    check(launches["k1"] == 6 * steps and launches["k2"] == 6 * steps,
          f"{tag}: expected 6 K1 and 6 K2 launches per step, got "
          f"{launches['k1']}, {launches['k2']} over {steps} steps")
    for m in metrics:
        bad = [k for k, v in m.items() if not np.isfinite(v)]
        check(not bad, f"{tag}: non-finite train metrics {bad}")
    for name, p in tr.state.model.named_parameters():
        if ".dcn.offset_conv." in name or ".dcn.mask_conv." in name:
            check(p.grad is not None and p.grad.abs().max().item() > 0,
                  f"{tag}: no gradient reaches {name}")
    timed = times[warmup:]
    return dict(launches=launches, step_ms=statistics.median(timed),
                max_ms=max(timed), n=len(timed),
                repaired=[m["repaired_gt"] for m in metrics],
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)


def phase_train() -> dict:
    """(train): full-width flagship train steps through the entry points
    at the preset's defaults (auction, ``compact_gt=32``).  Returns the
    trainer too, and the cost batch of its first step."""
    t = time.perf_counter()
    tr = api.init_trainer(PRESET, seed=0)
    check((tr.cfg.train.matcher, tr.cfg.train.compact_gt) == ("auction", 32),
          f"preset trains with {tr.cfg.train.matcher}, "
          f"compact_gt={tr.cfg.train.compact_gt}")
    log("train", f"flagship trainer built at full width in "
        f"{time.perf_counter() - t:.1f}s (matcher "
        f"{tr.cfg.train.matcher}, compact_gt {tr.cfg.train.compact_gt})")
    b, hw = tr.cfg.data.batch_size, tuple(tr.cfg.data.crop_size)
    rng = np.random.default_rng(0)
    batches = [synthetic_batch(rng, b, hw)
               for _ in range(WARMUP_STEPS + TIMED_STEPS)]
    n_cls = [len(np.unique(s[s != 255])) for s in batches[0][1]]
    log("train", f"batch {b} at {hw}: classes per crop {n_cls}")
    costs = []
    with capture_auction(costs):
        api.train_steps(tr, batches[:1])
    check(len(costs) == 1 and tuple(costs[0].shape) == (42, 100, 32),
          f"auction cost batches {[tuple(c.shape) for c in costs]}")
    res = timed_steps(tr, batches, WARMUP_STEPS, "auction")
    return dict(res, trainer=tr, costs=costs[0], batches=batches)


def phase_host_train() -> dict:
    """(train): the same step with ``matcher='host'``, fewer steps."""
    tr = api.init_trainer(PRESET, ["train.matcher='host'"], seed=0)
    rng = np.random.default_rng(0)
    b, hw = tr.cfg.data.batch_size, tuple(tr.cfg.data.crop_size)
    batches = [synthetic_batch(rng, b, hw)
               for _ in range(HOST_WARMUP_STEPS + HOST_TIMED_STEPS)]
    return timed_steps(tr, batches, HOST_WARMUP_STEPS, "host")


def phase_auction(costs: torch.Tensor) -> dict:
    """(auction): the cost batch of one flagship train step on the card
    against the CPU, against scipy's optimum, and capped."""
    from scipy.optimize import linear_sum_assignment

    got, stats = auction_match(costs, with_stats=True)
    want, want_stats = auction_match(costs.cpu(), with_stats=True)
    check(torch.equal(got.cpu(), want), "auction card vs CPU assignment")
    check(int(stats.repaired) == int(want_stats.repaired) == 0,
          f"repaired_gt card {int(stats.repaired)} CPU "
          f"{int(want_stats.repaired)}")
    c = costs.double().cpu().numpy()
    m = got.cpu().numpy()
    worst = 0.0
    for i in range(len(c)):
        valid = ~(c[i] >= BIG_COST * 0.5).all(0)
        cols = np.flatnonzero(valid)
        r, k = linear_sum_assignment(c[i][:, cols].T)
        opt = c[i][:, cols].T[r, k].sum()
        total = c[i][m[i, cols], cols].sum()
        check(len(set(m[i, cols])) == len(cols) and (m[i, cols] >= 0).all(),
              f"problem {i}: incomplete assignment")
        excess = total - opt
        check(excess <= len(cols) * AUCTION_EPS + 1e-4,
              f"problem {i}: {excess:.4g} over the optimum")
        worst = max(worst, excess / (len(cols) * AUCTION_EPS))
    capped, capped_stats = auction_match(costs, num_iters=1,
                                         with_stats=True)
    check(int(capped_stats.repaired) > 0, "a run capped at 1 iteration "
          "needed no repair")
    cm = capped.cpu().numpy()
    for i in range(len(c)):
        cols = np.flatnonzero(~(c[i] >= BIG_COST * 0.5).all(0))
        check((cm[i, cols] >= 0).all() and len(set(cm[i, cols])) == len(cols),
              f"capped problem {i}: the repair left it incomplete")
    check(torch.equal(capped.cpu(), auction_match(costs.cpu(), num_iters=1)),
          "capped auction card vs CPU")
    sites = sync_sites(lambda: auction_match(costs))
    ms = host_ms(lambda: auction_match(costs), iters=20)
    schedules = {}
    saved = matcher.CHUNKS
    try:
        # four rounds, every other one in reverse order, so drift shows
        for chunks in 2 * (AUCTION_CHUNKS + AUCTION_CHUNKS[::-1]):
            matcher.CHUNKS = chunks
            m_s, st = auction_match(costs, with_stats=True)
            check(torch.equal(m_s, got), f"chunks {chunks}: assignment")
            row = schedules.setdefault(f"{chunks[0]}-{chunks[1]}",
                                       dict(syncs=st.syncs, ms=[]))
            row["ms"].append(host_ms(lambda: auction_match(costs), iters=20))
    finally:
        matcher.CHUNKS = saved
    res = dict(iterations=int(stats.iterations), syncs=stats.syncs,
               sites=dict(sites), ms=ms, worst=worst,
               capped_repaired=int(capped_stats.repaired),
               chunks=matcher.CHUNKS, schedules=schedules)
    log("auction", f"[{', '.join(map(str, costs.shape))}] card == CPU; "
        f"{res['iterations']} iterations, {res['syncs']} host reads of the "
        f"loop condition (synchronizations seen by "
        f"torch.cuda.set_sync_debug_mode: {dict(sites)}); {ms:.3f} ms per "
        f"call; worst "
        f"excess over scipy {worst:.4f} of G_valid*eps; capped at 1 "
        f"iteration: repaired_gt={res['capped_repaired']}, complete")
    log("auction", "chunk schedules (first-most: host reads, median ms "
        "per call of four rounds [each round]; the default is "
        f"{matcher.CHUNKS}): " + "; ".join(
            f"{k}: {v['syncs']} reads, {statistics.median(v['ms']):.3f} ms ["
            + ", ".join(f"{t:.3f}" for t in v["ms"]) + "]"
            for k, v in schedules.items()))
    return res


def phase_overflow(tr, batch) -> dict:
    """(overflow): one step on a batch with a crop of 33-36 classes, which
    takes ``compact_gt``'s full-width branch, and the losses at
    ``compact_gt=32`` against full width on a normal batch and on it."""
    rng = np.random.default_rng(7)
    images, sem = batch
    images, sem = images.copy(), sem.copy()
    im1, sem1 = synthetic_batch(rng, 1, sem.shape[1:], classes=(36, 36))
    images[0], sem[0] = im1[0], sem1[0]
    n_cls = len(np.unique(sem[0][sem[0] != 255]))
    check(n_cls > 32, f"the overflow crop holds {n_cls} classes")
    widths = []
    with capture_auction(widths):
        zero_launches()
        m = api.train_steps(tr, [(images, sem)])[0]
        torch.cuda.synchronize()
        launches = read_launches()
    check([tuple(c.shape) for c in widths] == [(42, 100, 64)],
          f"overflow step matched {[tuple(c.shape) for c in widths]}")
    check(launches["k1"] == 6 and launches["k2"] == 6,
          f"overflow step launches {launches}")
    check(np.isfinite(m["total"]), "overflow step loss")
    log("overflow", f"step on a batch with a {n_cls}-class crop: cost batch "
        f"[42, 100, 64] (full width), total={m['total']:.6g} repaired_gt="
        f"{m['repaired_gt']:g}, K1 {launches['k1']} K2 {launches['k2']}")
    model = tr.state.model.train()
    ncls, max_gt = tr.cfg.model.num_classes, tr.cfg.train.max_gt
    worst = 0.0
    for name, (ims, sems) in (("normal", batch), ("overflow", (images, sem))):
        with torch.no_grad(), f32_precision():
            cls, masks = model(preprocess(torch.as_tensor(ims,
                                                          device=tr.device)))
            gt = criterion.semantic_to_instances(
                torch.as_tensor(sems, device=tr.device), ncls, max_gt)
            kw = dict(num_classes=ncls, matcher="auction", loss_at="gt")
            small = criterion.maskformer_loss(cls, masks, gt, compact_gt=32,
                                              **kw)
            full = criterion.maskformer_loss(cls, masks, gt, **kw)
        rel = max(abs(float(small[k]) - float(full[k]))
                  / max(abs(float(full[k])), 1e-30) for k in full
                  if k != "repaired_gt")
        check(rel <= COMPACT_RTOL, f"{name} batch: compact_gt=32 vs full "
              f"width rel {rel:.3g} > {COMPACT_RTOL}")
        worst = max(worst, rel)
        log("overflow", f"{name} batch: losses at compact_gt=32 vs full "
            f"width max rel diff {rel:.3g} (total {float(full['total']):.6g}"
            f", valid slots past 32: {bool(gt.valid[:, 32:].any())})")
    return dict(launches=launches, rel=worst)


def phase_small_train() -> dict:
    """A tiny model's 3 train steps on the card against the CPU, with the
    preset's auction matcher and with the host matcher: the relative
    difference of each step's ``total`` loss.  The maps hold 4 classes
    for the 4 queries: the auction assumes no more valid slots than
    queries."""
    out = {}
    for matcher in ("auction", "host"):
        opts = [f"model.{k}={v!r}".replace(" ", "") for k, v in TINY.items()]
        opts += ["train.warmup_iters=1", f"train.matcher='{matcher}'"]
        rng = np.random.default_rng(1)
        batches = [synthetic_batch(rng, 2, (64, 64), num_classes=4)
                   for _ in range(3)]
        totals = []
        for dev in ("cpu", "cuda"):
            tr = api.init_trainer(PRESET, opts, device=dev, seed=1)
            totals.append([m["total"] for m in api.train_steps(tr, batches)])
        rel = max(abs(a - b) / abs(b) for a, b in zip(totals[1], totals[0]))
        log("train", f"tiny {matcher} totals CPU {totals[0]} card "
            f"{totals[1]}")
        check(rel <= TRAIN_RTOL, f"tiny {matcher} train card vs CPU rel diff "
              f"{rel:.3g}")
        out[matcher] = rel
    return out


# the train CLI's seeded tree: the 12 training images of ADE_LIKE_SHAPES
# (two batches of 6 an epoch) and the three val images of (eval)
CLI_ITERS, CLI_RESUMED_ITERS, CLI_LOG = 10, 14, 2
CLI_OPTS = ["train.checkpoint_interval=5", "train.val_interval=5",
            "train.max_keep_ckpts=1"]
# log records whose window holds neither a val nor a checkpoint nor the
# resumed run's start
CLI_STEADY_STEPS = (4, 8, 14)
LOADER_BATCHES = 10


def state_snapshot(state) -> dict:
    """Host copies of what a train checkpoint holds."""
    def copy(tensors):
        return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}

    opt = state.optimizer.state_dict()
    return {"step": state.step, "count": opt["count"],
            "model": copy(state.model.state_dict()), "mu": copy(opt["mu"]),
            "nu": copy(opt["nu"])}


def check_saved(raw: dict, want: dict, what: str) -> None:
    """A loaded train checkpoint against a ``state_snapshot``, bit for
    bit."""
    check(raw["step"] == want["step"]
          and raw["optimizer"]["count"] == want["count"],
          f"{what}: step/count {raw['step']}/{raw['optimizer']['count']}, "
          f"expected {want['step']}/{want['count']}")
    for part, got in (("model", raw["model"]), ("mu", raw["optimizer"]["mu"]),
                      ("nu", raw["optimizer"]["nu"])):
        check(got.keys() == want[part].keys(), f"{what}: {part} keys")
        bad = [k for k, v in want[part].items() if not torch.equal(got[k], v)]
        check(not bad, f"{what}: {part} differs at {bad[:5]}")


@contextlib.contextmanager
def watch_checkpoints(store: dict):
    """Spy on the train CLI's ``save_state`` and ``restore_state``.  Each
    save's state is snapshot when the save returns (its file is still
    being written while the next steps update the state in place); the
    file is held to the snapshot once the next save has waited for it
    (and before that save prunes it), or at the end.  Each restore is held
    to the file it read."""
    real_save, real_restore = train_cli.save_state, train_cli.restore_state
    store.update(pending={}, checked=[], restored=[])

    def settle():
        checkpoint.wait_for_saves()
        for path, snap in list(store["pending"].items()):
            check_saved(torch.load(path, weights_only=True), snap, path)
            store["checked"].append((os.path.relpath(path, store["root"]),
                                     snap["step"]))
            del store["pending"][path]

    def save(work_dir, state, step, **kw):
        settle()
        path = real_save(work_dir, state, step, **kw)
        store["pending"][path] = state_snapshot(state)
        return path

    def restore(path, state):
        out = real_restore(path, state)
        check_saved(torch.load(path, weights_only=True),
                    state_snapshot(state), f"restored {path}")
        store["restored"].append((os.path.basename(path), state.step))
        store["state"] = state
        return out

    train_cli.save_state, train_cli.restore_state = save, restore
    try:
        yield settle
    finally:
        train_cli.save_state, train_cli.restore_state = real_save, real_restore


def run_cli(main, args: list[str], tag: str) -> list[str]:
    """``main(args)`` with its standard output captured and logged."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(args)
    lines = buf.getvalue().splitlines()
    for line in lines:
        log("train cli", f"{tag}: {line}")
    check(rc == 0, f"{tag}: exit code {rc}")
    return lines


def loader_rate(root: str, workers: int) -> float:
    """Batches a second of the flagship's ``TrainLoader`` (batch 6,
    512x512 crops) alone, over ``LOADER_BATCHES`` after the first."""
    ds = make_dataset("ade20k", root, "train")
    with TrainLoader(ds, 6, (512, 512), seed=0, num_workers=workers) as ld:
        it = iter(ld)
        next(it)
        t = time.perf_counter()
        for _ in range(LOADER_BATCHES):
            next(it)
        return LOADER_BATCHES / (time.perf_counter() - t)


def step_under_loader(root: str, steps: int = 4) -> dict:
    """Median ms of a full-width ``api.train_steps`` step on the loader's
    batches: taken from memory (the loader closed), and taken while a
    live ``TrainLoader`` (``num_workers=8``) produces the next ones in its
    threads, as in the train CLI."""
    tr = api.init_trainer(PRESET, seed=0)
    ds = make_dataset("ade20k", root, "train")
    with TrainLoader(ds, 6, (512, 512), seed=1, num_workers=8) as ld:
        it = iter(ld)
        batches = [next(it) for _ in range(2 + steps)]

    def timed(batch) -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        api.train_steps(tr, [batch])
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    for b in batches[:2]:
        timed(b)
    costs = []
    with capture_auction(costs):
        memory = [timed(b) for b in batches[2:]]
    # the auction's iterations are data-dependent; on (train)'s synthetic
    # batch (auction) reports them
    iterations = [int(auction_match(c, with_stats=True)[1].iterations)
                  for c in costs]
    with TrainLoader(ds, 6, (512, 512), seed=2, num_workers=8) as ld:
        it = iter(ld)
        live = [timed(next(it)) for _ in range(steps)]
    del tr
    torch.cuda.empty_cache()
    return dict(memory_ms=statistics.median(memory),
                live_ms=statistics.median(live), memory=memory, live=live,
                iterations=iterations,
                classes=[len(np.unique(s[s != 255])) for _, sem in batches
                         for s in sem])


def phase_train_cli(step_ms: float, smi: str) -> dict:
    """(train cli): the train CLI at full width on a seeded ADE20K-layout
    tree at the preset's defaults (auction, ``compact_gt=32``, batch 6,
    512x512 crops): 10 iterations with a checkpoint and a val every 5
    (3 val images, an overlay each), then ``--resume`` to 14; the eval
    CLI on the best checkpoint; the loader alone; one save timed."""
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "ade")
        write_ade_tree(root, ADE_LIKE_SHAPES, seed=3, split="training")
        write_ade_tree(root, REQUEST_SHAPES, seed=0)
        wd = os.path.join(tmp, "wd")
        base = [PRESET, "--data-root", root, "--work-dir", wd,
                "--log-interval", str(CLI_LOG), "--eval-images", "3",
                "--vis-interval", "1"]
        store = {"root": wd}
        runs = {}
        with watch_checkpoints(store) as settle:
            for tag, iters, extra in (("first", CLI_ITERS, []),
                                      ("resumed", CLI_RESUMED_ITERS,
                                       ["--resume"])):
                torch.cuda.synchronize()
                zero_launches()
                t = time.perf_counter()
                lines = run_cli(train_cli.main, base + extra + [
                    "--cfg-options", *CLI_OPTS,
                    f"train.total_iters={iters}"], tag)
                torch.cuda.synchronize()
                runs[tag] = dict(lines=lines, launches=read_launches(),
                                 s=time.perf_counter() - t)
                settle()
                files = sorted(
                    os.path.relpath(os.path.join(d, f), wd)
                    for d, _, fs in os.walk(wd) for f in fs)
                runs[tag]["files"] = files
                log("train cli", f"{tag}: {runs[tag]['s']:.1f}s, files "
                    f"{files}")
        first, resumed = runs["first"], runs["resumed"]
        vals = {int(line.split()[1]): line.split()[4]
                for line in first["lines"] if " val mIoU " in line}
        check(sorted(vals) == [5, 10], f"val lines at {sorted(vals)}")
        # launches: 6 K1 and 6 K2 a train iteration, 6 K1 a val image
        for tag, steps, val_images in (("first", CLI_ITERS, 6),
                                       ("resumed",
                                        CLI_RESUMED_ITERS - CLI_ITERS, 0)):
            n = runs[tag]["launches"]
            check(n["k1"] == 6 * (steps + val_images)
                  and n["k2"] == 6 * steps,
                  f"{tag}: K1/K2 launches {n['k1']}/{n['k2']} for {steps} "
                  f"iterations and {val_images} val images")
        best = [f for f in first["files"] if f.startswith("best/")]
        check(len(best) == 1, f"best checkpoints {best}")
        want_first = sorted(
            ["ckpt_10", "scalars.jsonl", *best]
            + [f"vis/iter_{i}/val_{j:05d}.png" for i in (5, 10)
               for j in range(3)])
        check(first["files"] == want_first,
              f"first run's files {first['files']}")
        check(resumed["files"] == sorted(
            ["ckpt_14"] + [f for f in want_first if f != "ckpt_10"]),
              f"resumed run's files {resumed['files']}")
        check(resumed["lines"][0] == f"resumed from {wd}/ckpt_10 at step 10"
              and store["restored"] == [("ckpt_10", 10)],
              f"resume: {resumed['lines'][:1]} {store['restored']}")
        # each save, held to the state at its step once written: the
        # periodic and best saves at 5 and 10, the final saves at 10 and 14
        best_step = int(best[0].split("_")[1])
        want = ([("ckpt_5", 5), ("best/ckpt_5", 5), ("ckpt_10", 10)]
                + ([("best/ckpt_10", 10)] if best_step == 10 else [])
                + [("ckpt_10", 10), ("ckpt_14", 14)])
        check(store["checked"] == want,
              f"checkpoints held to the state: {store['checked']}")
        recs = read_scalars(os.path.join(wd, "scalars.jsonl"))
        losses = [r for r in recs if "total" in r]
        check([r["step"] for r in losses] == [2, 4, 6, 8, 10, 12, 14],
              f"logged steps {[r['step'] for r in losses]}")
        for r in losses:
            bad = [k for k, v in r.items() if not np.isfinite(v)]
            check(not bad, f"step {r['step']}: non-finite {bad}")
        sec = {r["step"]: r["sec_per_iter"] for r in losses}
        steady = statistics.median(sec[s] * 1e3 for s in CLI_STEADY_STEPS)

        # the eval CLI on the best checkpoint gives the printed mIoU
        zero_launches()
        lines = run_cli(eval_cli.main,
                        [PRESET, "--data-root", root, "--checkpoint",
                         os.path.join(wd, best[0]), "--max-images", "3"],
                        "eval --checkpoint")
        eval_launches = read_launches()
        check(lines[-1].split()[1] == vals[best_step],
              f"eval CLI on {best[0]}: {lines[-1]}, the train CLI printed "
              f"{vals[best_step]}")

        rates = {w: loader_rate(root, w)
                 for w in sorted({8, os.cpu_count() or 8})}
        under = step_under_loader(root)
        state = store["state"]
        t = time.perf_counter()
        path = checkpoint.save_state(os.path.join(tmp, "timed"), state,
                                     state.step)
        inline_ms = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        checkpoint.wait_for_saves()
        write_ms = (time.perf_counter() - t) * 1e3
        mb = os.path.getsize(path) / 1e6
    log("train cli", f"s/iter by log record (ms): "
        f"{ {k: round(v * 1e3, 1) for k, v in sec.items()} }; steady (steps "
        f"{CLI_STEADY_STEPS}) {steady:.1f} ms against (train)'s step "
        f"{step_ms:.1f} ms ({steady / step_ms:.3f}x) on {smi}")
    log("train cli", "loader alone, batches/s by num_workers: "
        + ", ".join(f"{w}: {r:.3f}" for w, r in rates.items())
        + f" (os.cpu_count() {os.cpu_count()}) on {smi}")
    log("train cli", f"api.train_steps on the loader's batches: "
        f"{under['memory_ms']:.1f} ms a step from memory "
        f"{[round(x, 1) for x in under['memory']]}, {under['live_ms']:.1f} "
        f"ms under a live loader {[round(x, 1) for x in under['live']]} "
        f"on {smi}; auction iterations on the memory steps "
        f"{under['iterations']}, classes per crop {under['classes']}")
    log("train cli", f"checkpoint {mb:.1f} MB: inline copy {inline_ms:.1f} "
        f"ms, background write {write_ms:.1f} ms on {smi}")
    log("train cli", f"K1/K2 launches: first run {first['launches']['k1']}/"
        f"{first['launches']['k2']}, resumed {resumed['launches']['k1']}/"
        f"{resumed['launches']['k2']}, eval CLI K1 {eval_launches['k1']}")
    return dict(launches=[first["launches"], resumed["launches"],
                          eval_launches],
                steady_ms=steady, sec=sec, rates=rates, under=under,
                inline_ms=inline_ms, write_ms=write_ms, mb=mb)


# tests/torch_golden.py's dims for a tiny reference-format checkpoint
GOLDEN = dict(num_classes=5, embed_dim=(8, 16, 24, 32), backbone_heads=4,
              feat_channels=16, num_queries=4, num_decoder_layers=2,
              num_encoder_layers=2, depths_stage3=1, depths_stage4=1,
              dcn_group=4)


def golden_state_dict(seed: int = 3) -> dict:
    """The reference-format state dict of ``tests/torch_golden.py``'s
    ``GoldenSpike2Former`` at ``GOLDEN``'s dims, drawn by its
    ``randomize_torch``.  Its forward needs ``tests/test_dcnv3.py``,
    which imports JAX; only the state dict is taken here, so that import
    is answered by an empty module."""
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    saved = {k: sys.modules.get(k) for k in ("test_dcnv3", "torch_golden")}
    sys.modules["test_dcnv3"] = types.ModuleType("test_dcnv3")
    sys.modules["test_dcnv3"].torch_dcnv3_golden = None
    sys.path.insert(0, tests)
    try:
        import torch_golden
    finally:
        sys.path.remove(tests)
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v
    g = GOLDEN
    golden = torch_golden.GoldenSpike2Former(
        num_classes=g["num_classes"], embed_dim=g["embed_dim"],
        heads=g["backbone_heads"], T=1, feat=g["feat_channels"],
        num_queries=g["num_queries"], dec_layers=g["num_decoder_layers"],
        enc_layers=g["num_encoder_layers"], group=g["dcn_group"],
        depths_stage3=g["depths_stage3"], depths_stage4=g["depths_stage4"])
    torch_golden.randomize_torch(golden, seed=seed)
    return golden.state_dict()


def phase_reference() -> dict:
    """(reference): a reference-format checkpoint through
    ``load_reference_model`` onto the card, its logits against the
    CPU's, and through the eval CLI's ``--torch-checkpoint`` on the
    card."""
    depths = {k: GOLDEN[k] for k in ("depths_stage3", "depths_stage4",
                                      "num_encoder_layers",
                                      "num_decoder_layers")}
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "golden.pth")
        torch.save({"state_dict": golden_state_dict()}, path)
        sd = load_reference_model(path, **depths)
        cpu = Spike2Former(T=1, compat=True, **GOLDEN)
        cpu.load_state_dict(sd, strict=True)
        gpu = copy.deepcopy(cpu).cuda()
        x = torch.from_numpy(np.random.default_rng(2).normal(
            0, 1, (1, 64, 64, 3)).astype(np.float32))
        with torch.inference_mode(), f32_precision():
            want = cpu.eval().predict_logits(x)
            got = gpu.eval().predict_logits(x.cuda()).cpu()
        err = (got - want).abs().max().item()
        check(torch.allclose(got, want, atol=MODEL_TOL, rtol=MODEL_TOL),
              f"reference checkpoint card vs CPU: max|diff|={err:.3g}")
        root = write_ade_tree(os.path.join(d, "ade"), ((96, 128), (128, 96)),
                              seed=1)
        opts = [f"model.{k}={v!r}".replace(" ", "") for k, v in GOLDEN.items()]
        opts.append("data.test_scale=(128,96)")
        buf = io.StringIO()
        before = dcnv3.dcnv3_sample.launches
        with contextlib.redirect_stdout(buf):
            rc = eval_cli.main([PRESET, "--data-root", root,
                                "--torch-checkpoint", path,
                                "--cfg-options", *opts])
        lines = buf.getvalue().splitlines()
        check(rc == 0 and lines[-2] == "images: 2"
              and lines[-1].startswith("mIoU "),
              f"eval CLI with a reference checkpoint printed {lines}")
        check(dcnv3.dcnv3_sample.launches > before,
              "the eval CLI did not run K1")
    log("reference", f"reference-format checkpoint: logits card vs CPU "
        f"max|diff|={err:.3g} (tol {MODEL_TOL}); eval CLI on the card: "
        f"{' | '.join(lines[-2:])}")
    return dict(err=err, cli=lines[-2:])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cudnn.benchmark = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log("device", f"{kind} | {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | devices {torch.cuda.device_count()}")

    t = time.perf_counter()
    dcnv3.build_kernels()
    sources = (dcnv3.SOURCE, dcnv3.BWD_SOURCE, dcnv3.GROUPED_SOURCE,
               dcnv3.GROUPED_BWD_SOURCE)
    log("build", f"{', '.join(sources)} built in "
        f"{time.perf_counter() - t:.1f}s")
    for src in sources:
        lib = cuda_build.library_path(src)
        for line in (lib.parent / "build.log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log("build", f"{src}: {line.strip()}")

    gen = torch.Generator().manual_seed(0)
    k = phase_kernel(gen)
    k2 = phase_backward_kernel(gen)
    grad_err = phase_core_autograd(gen)
    gk = phase_grouped(gen)

    t = time.perf_counter()
    im = api.init_model(PRESET, seed=0)
    log("serve", f"flagship {PRESET} built at full width in "
        f"{time.perf_counter() - t:.1f}s")
    s = phase_serve(im)
    log("timing", f"median request_ms={s['request_ms']:.3f} (max "
        f"{s['max_ms']:.3f}, n={s['n']}) peak_mem_gib={s['peak_gib']:.3f} "
        f"on {smi}")
    tf = phase_tf32(im)
    for mode in ("default", "tf32"):
        log("tf32", f"{mode} vs f32 over the 3 images: least class "
            f"agreement {min(a for a, _ in tf[mode]):.6f}, largest logit "
            f"difference {max(d for _, d in tf[mode]):.6g}; tiny model vs "
            f"CPU {tf['tiny_' + mode]:.6g} (f32: {tf['tiny_f32']:.6g})")
    err = phase_small_reference()
    log("reference", f"tiny model 64x64 card vs CPU max|diff|={err:.3g} "
        f"(tol {MODEL_TOL})")
    ev = phase_eval(im)
    del im
    torch.cuda.empty_cache()

    tr = phase_train()
    log("train", f"auction (preset default): median step_ms="
        f"{tr['step_ms']:.3f} (max {tr['max_ms']:.3f}, n={tr['n']}) "
        f"peak_mem_gib={tr['peak_gib']:.3f} repaired_gt per step "
        f"{tr['repaired']} on {smi}")
    auc = phase_auction(tr["costs"])
    ov = phase_overflow(tr["trainer"], tr["batches"][0])
    del tr["trainer"], tr["costs"], tr["batches"]
    torch.cuda.empty_cache()
    host = phase_host_train()
    log("train", f"host matcher: median step_ms={host['step_ms']:.3f} (max "
        f"{host['max_ms']:.3f}, n={host['n']}) peak_mem_gib="
        f"{host['peak_gib']:.3f} on {smi}; auction/host step ms "
        f"{tr['step_ms'] / host['step_ms']:.3f}")
    t_err = phase_small_train()
    log("train", f"tiny model 3 steps card vs CPU max rel|diff| of total: "
        f"auction {t_err['auction']:.3g}, host {t_err['host']:.3g} "
        f"(tol {TRAIN_RTOL})")
    torch.cuda.empty_cache()
    cli = phase_train_cli(tr["step_ms"], smi)
    ref = phase_reference()

    # the main path's launches: serve, the three eval modes, the train
    # steps at the defaults, the overflow step, the host-matcher steps,
    # the train CLI's two runs and the eval CLI on its best checkpoint,
    # each counted from 0 just before it
    paths = [ev[mode]["launches"] for mode in EVAL_MODES] + [
        tr["launches"], ov["launches"], host["launches"], *cli["launches"]]
    k1_launches = s["launches"] + sum(p["k1"] for p in paths)
    k2_launches = sum(p["k2"] for p in paths)
    grouped = [s["grouped"][i] + sum(p["grouped"][i] for p in paths)
               for i in (0, 1)]

    def row(name, source, tpu_name, launches, max_abs_err, t):
        return dict(
            name=name, route="cuda",
            source=f"spike2former_tpu_torch/csrc/{source}",
            replaces="spike2former_tpu/ops/pallas/dcnv3_kernel.py:"
                     f"{TPU_LINE[tpu_name]}",
            launches=launches, max_abs_err=max_abs_err, ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=max(t["bytes_ms"], t["ops_ms"]),
            bound_by=("bytes" if t["bytes_ms"] >= t["ops_ms"]
                      else "operations"),
            library_ms=t["library_ms"])

    # K1 and K3-K6 at the serve shape, K2 and K7 at the train shape
    kernels = [
        row("dcnv3_sample", dcnv3.SOURCE, "dcnv3_sample_pallas_t5",
            k1_launches, max(k["max_abs_err"], s["max_abs_err"]), k[1]),
        row("dcnv3_sample_bwd", dcnv3.BWD_SOURCE,
            "dcnv3_sample_pallas_t5_bwd", k2_launches,
            max(k2["max_abs_err"], grad_err), k2)]
    for name, (_, layout) in GROUPED_FORWARD.items():
        kernels.append(row(
            f"dcnv3_sample_grouped[{layout}] ({name})", dcnv3.GROUPED_SOURCE,
            name, grouped[0], gk["errs"][name], gk["times"][name, "serve"]))
    kernels.append(row(
        f"dcnv3_sample_grouped_bwd ({GROUPED_BACKWARD})",
        dcnv3.GROUPED_BWD_SOURCE, GROUPED_BACKWARD, grouped[1],
        gk["errs"][GROUPED_BACKWARD],
        gk["times"][GROUPED_BACKWARD, "train"]))
    log("summary", f"K1 launches: serve {s['launches']}, eval "
        f"{[ev[m]['launches']['k1'] for m in EVAL_MODES]}, train "
        f"{tr['launches']['k1']}, overflow {ov['launches']['k1']}, host "
        f"{host['launches']['k1']}; K2: train {tr['launches']['k2']}, "
        f"overflow {ov['launches']['k2']}, host {host['launches']['k2']}; "
        f"train CLI K1/K2 {[(n['k1'], n['k2']) for n in cli['launches']]}; "
        f"reference CLI max|diff| {ref['err']:.3g}; auction "
        f"{auc['ms']:.3f} ms")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
