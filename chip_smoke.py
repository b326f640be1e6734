#!/usr/bin/env python3
"""Drive the PyTorch port (``spike2former_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, each printing one flushed line with the seconds elapsed:

  (a) device: torch/CUDA versions, the card's name and power limit;
  (b) build: ``nvcc`` builds ``csrc/dcnv3_sample.cu`` (K1, forward) and
      ``csrc/dcnv3_sample_bwd.cu`` (K2, backward) for sm_90a, side by side;
  (c) K1 against its plain PyTorch version at the flagship shapes (serve:
      N in {1, 2}, 32x44; train: N=6, 32x32; G=32, Cg=8, P=9, f32, TF32
      off), with its time, the plain time, an ``F.grid_sample`` yardstick
      and the byte bound;
  (k2) K2 against its plain version at the flagship train shape (N=6,
      32x32), for random (off-map), zero-offset and integer-coordinate
      inputs, with its time, the plain time, the ``F.grid_sample``
      backward yardstick and the byte bound;
  (grad) gradients to x, offset and mask through ``dcnv3_core`` at the
      flagship train shape, K1 forward and K2 backward, against autograd
      of the plain sampler on the same card tensors;
  (d) the flagship SDTv2 MaskFormer at full width serves 3 requests through
      ``api.inference_model`` (K1 launch count 6 per request); K1 is held
      against the plain version at each of the 6 DCN calls of one request,
      and a tiny model's logits on the card against the CPU's;
  (e) median (and max) ms per request over 30 requests, and peak memory;
  (train) the flagship at full width takes 2 warm-up and 5 timed train
      steps through ``api.init_trainer`` / ``api.train_steps`` at batch 6
      and 512x512 crops of seeded synthetic images and piecewise-constant
      semantic maps (K1 and K2 launches 6 each per step); losses finite,
      the DCN offset and mask projections get non-zero gradients, and a
      tiny model's ``total`` loss over 3 steps on the card agrees with the
      CPU's.

It then prints the ``kernels`` JSON line, the ``nvidia-smi`` name and power
limit, and as its last line ``{"ok": true, "device": {...}}``.  Any failed
phase raises, so the script exits non-zero and prints no result; it also
exits non-zero when no CUDA device is available.
"""
from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from spike2former_tpu_torch import api
from spike2former_tpu_torch.data.synthetic import synthetic_batch
from spike2former_tpu_torch.engine.inference import whole_logits
from spike2former_tpu_torch.engine.weights import randomize_
from spike2former_tpu_torch.models.segmentor import Spike2Former
from spike2former_tpu_torch.ops import cuda_build, dcnv3

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
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12     # H100 SXM f32, outside the tensor cores
REQUEST_SHAPES = ((512, 683), (683, 512), (512, 512))
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


def cuda_ms(fn, iters: int = 100, warmup: int = 5) -> float:
    """Mean device ms of ``fn`` over ``iters`` back-to-back calls.  A spin
    kernel holds the device first, so the host enqueues every call before
    the start event runs and the events time device work, not the host's
    per-call cost."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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


def sampler_inputs(n, h, w, g, cg, p, kind, gen):
    """value and [N, HoWo, G, P] coordinates/mask on the card.  ``kind``:
    'random' offsets large enough that taps leave the map, 'zero' offsets
    (every coordinate an exact integer, one-hot centre mask: the identity),
    'integer' offsets (exact integer coordinates, random mask)."""
    dev = "cuda"
    value = torch.randn((n, h, w, g * cg), generator=gen).to(dev)
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
    elif kind == "integer":
        py = by + torch.randint(-3, 4, shape, generator=gen).float()
        px = bx + torch.randint(-3, 4, shape, generator=gen).float()
    else:
        py, px = by.clone(), bx.clone()
        mask = torch.zeros(shape)
        mask[..., p // 2] = 1.0
    return (value, *(t.contiguous().to(dev) for t in (py, px, mask)))


def sampler_bytes(value, py, out_elems):
    return 4 * (value.numel() + 3 * py.numel() + out_elems)


def phase_kernel(gen) -> dict:
    """(c): kernel against plain at the flagship /16 shapes of a request
    (N=1, 2 at 32x44) and of a train step (N=6 at 32x32)."""
    g, cg, p = 32, 8, 9
    worst = 0.0
    rec = {}
    for n, h, w in ((1, 32, 44), (2, 32, 44), (6, 32, 32)):
        for kind in ("random", "zero", "integer"):
            value, py, px, mask = sampler_inputs(n, h, w, g, cg, p, kind, gen)
            got = dcnv3.dcnv3_sample(value, py, px, mask)
            torch.cuda.synchronize()
            want = dcnv3.dcnv3_sample_reference(value, py, px, mask)
            err = (got - want).abs().max().item()
            check(bool(torch.isfinite(got).all()), f"non-finite kernel out "
                  f"({kind}, N={n})")
            check(err <= KERNEL_TOL, f"kernel vs plain {err:.3g} > "
                  f"{KERNEL_TOL} ({kind}, N={n})")
            if kind == "zero":
                ident = (got - value.reshape(got.shape)).abs().max().item()
                check(ident <= KERNEL_TOL, f"identity case off by {ident:.3g}")
            worst = max(worst, err)
            log("kernel", f"N={n} {h}x{w} G={g} Cg={cg} P={p} {kind}: "
                f"max|kernel-plain|={err:.3g}")
        value, py, px, mask = sampler_inputs(n, h, w, g, cg, p, "random", gen)
        lib_err = (grid_sample_yardstick(value, py, px, mask)
                   - dcnv3.dcnv3_sample_reference(value, py, px, mask)
                   ).abs().max().item()
        out_elems = n * h * w * g * cg
        bytes_ = sampler_bytes(value, py, out_elems)
        flops = n * h * w * g * p * (4 * cg * 2 + 16)
        t = dict(
            ms=cuda_ms(lambda: dcnv3.dcnv3_sample(value, py, px, mask)),
            plain_ms=cuda_ms(lambda: dcnv3.dcnv3_sample_reference(
                value, py, px, mask), iters=20),
            library_ms=cuda_ms(lambda: grid_sample_yardstick(
                value, py, px, mask), iters=20),
            bytes_ms=bytes_ / HBM_BYTES_PER_S * 1e3,
            ops_ms=flops / F32_FLOPS_PER_S * 1e3,
            wall_ms=host_ms(lambda: dcnv3.dcnv3_sample(value, py, px, mask)))
        log("kernel", f"N={n} timing: kernel_ms={t['ms']:.5f} "
            f"plain_ms={t['plain_ms']:.5f} library_ms={t['library_ms']:.5f} "
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

    dcnv3.dcnv3_sample.launches = 0
    preds = [api.inference_model(im, img) for img in imgs]
    torch.cuda.synchronize()
    launches = dcnv3.dcnv3_sample.launches
    log("serve", f"3 requests served; dcnv3_sample launches={launches}")
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
    return dict(launches=launches, max_abs_err=worst,
                request_ms=statistics.median(times), max_ms=max(times),
                n=len(times),
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)


def phase_small_reference() -> float:
    """A tiny model's logits on the card (kernel path) against the same
    model on the CPU (plain path) at 64x64."""
    cpu = randomize_(Spike2Former(T=1, **TINY), seed=1)
    gpu = copy.deepcopy(cpu).cuda()
    x = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (1, 64, 64, 3)).astype(np.float32))
    with torch.inference_mode():
        want = cpu.predict_logits(x)
        got = gpu.predict_logits(x.cuda()).cpu()
    err = (got - want).abs().max().item()
    check(torch.allclose(got, want, atol=MODEL_TOL, rtol=MODEL_TOL),
          f"tiny model card vs CPU: max|diff|={err:.3g}")
    return err


def phase_backward_kernel(gen) -> dict:
    """(k2): K2 against plain at the flagship train shape (/16 of a 512
    crop, batch 6)."""
    n, g, cg, p, h, w = 6, 32, 8, 9, 32, 32
    worst = 0.0
    for kind in ("random", "zero", "integer"):
        value, py, px, mask = sampler_inputs(n, h, w, g, cg, p, kind, gen)
        dout = torch.randn((n, h * w, g * cg), generator=gen).cuda()
        got = dcnv3.dcnv3_sample_backward(value, py, px, mask, dout)
        torch.cuda.synchronize()
        want = dcnv3.dcnv3_sample_backward_reference(value, py, px, mask,
                                                     dout)
        errs = []
        for name, gv, wv in zip(("dvalue", "dpy", "dpx", "dmask"), got,
                                want):
            check(bool(torch.isfinite(gv).all()),
                  f"non-finite K2 {name} ({kind})")
            check(torch.allclose(gv, wv, atol=BWD_ATOL, rtol=BWD_RTOL),
                  f"K2 {name} vs plain beyond atol {BWD_ATOL} rtol "
                  f"{BWD_RTOL} ({kind}): {(gv - wv).abs().max().item():.3g}")
            errs.append((gv - wv).abs().max().item())
            worst = max(worst, errs[-1])
        log("k2", f"N={n} {h}x{w} G={g} Cg={cg} P={p} {kind}: max|kernel-"
            f"plain| dvalue={errs[0]:.3g} dpy={errs[1]:.3g} "
            f"dpx={errs[2]:.3g} dmask={errs[3]:.3g}")

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
    t = dict(
        ms=cuda_ms(lambda: dcnv3.dcnv3_sample_backward(
            value, py, px, mask, dout)),
        plain_ms=cuda_ms(lambda: dcnv3.dcnv3_sample_backward_reference(
            value, py, px, mask, dout), iters=10),
        library_ms=cuda_ms(lambda: torch.autograd.grad(
            lib_out, ins, dout, retain_graph=True), iters=20),
        bytes_ms=bytes_ / HBM_BYTES_PER_S * 1e3,
        ops_ms=flops / F32_FLOPS_PER_S * 1e3,
        wall_ms=host_ms(lambda: dcnv3.dcnv3_sample_backward(
            value, py, px, mask, dout)),
        max_abs_err=worst)
    log("k2", f"N={n} timing: kernel_ms={t['ms']:.5f} "
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
    sign of the coordinate gradient."""
    n, h, w, g, cg, p = 6, 32, 32, 32, 8, 9
    worst = 0.0
    for kind, scale in (("random", 3.0), ("zero", 0.0)):
        x = torch.randn((n, h, w, g * cg), generator=gen).cuda()
        offset = (scale * torch.randn((n, h, w, g * p * 2),
                                      generator=gen)).cuda()
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


def phase_train() -> dict:
    """(train): full-width flagship train steps through the entry
    points."""
    t = time.perf_counter()
    tr = api.init_trainer(PRESET, seed=0)
    log("train", f"flagship trainer built at full width in "
        f"{time.perf_counter() - t:.1f}s")
    b, hw = tr.cfg.data.batch_size, tuple(tr.cfg.data.crop_size)
    rng = np.random.default_rng(0)
    batches = [synthetic_batch(rng, b, hw)
               for _ in range(WARMUP_STEPS + TIMED_STEPS)]
    n_cls = [len(np.unique(s[s != 255])) for s in batches[0][1]]
    log("train", f"batch {b} at {hw}: classes per crop {n_cls}")

    torch.cuda.reset_peak_memory_stats()
    dcnv3.dcnv3_sample.launches = 0
    dcnv3.dcnv3_sample_backward.launches = 0
    times, metrics = [], []
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = api.train_steps(tr, [batch])[0]
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        metrics.append(m)
        log("train", f"step {i}{' (warm-up)' if i < WARMUP_STEPS else ''}: "
            f"{times[-1]:.1f} ms total={m['total']:.6g} "
            f"grad_norm={m['grad_norm']:.6g} dropped_gt={m['dropped_gt']:g}")
    fwd = dcnv3.dcnv3_sample.launches
    bwd = dcnv3.dcnv3_sample_backward.launches
    steps = len(batches)
    log("train", f"{steps} steps: dcnv3_sample launches={fwd} "
        f"({fwd / steps:g} per step), dcnv3_sample_bwd launches={bwd} "
        f"({bwd / steps:g} per step)")
    check(fwd == 6 * steps and bwd == 6 * steps,
          f"expected 6 K1 and 6 K2 launches per step, got {fwd}, {bwd} "
          f"over {steps} steps")
    for m in metrics:
        bad = [k for k, v in m.items() if not np.isfinite(v)]
        check(not bad, f"non-finite train metrics {bad}")
    for name, p in tr.state.model.named_parameters():
        if ".dcn.offset_conv." in name or ".dcn.mask_conv." in name:
            check(p.grad is not None and p.grad.abs().max().item() > 0,
                  f"no gradient reaches {name}")
    log("train", "DCN offset and mask projections of all 6 encoder layers "
        "have non-zero gradients")
    timed = times[WARMUP_STEPS:]
    return dict(launches=fwd, bwd_launches=bwd,
                step_ms=statistics.median(timed), max_ms=max(timed),
                n=len(timed),
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)


def phase_small_train() -> float:
    """A tiny model's 3 train steps on the card against the CPU: the
    relative difference of each step's ``total`` loss."""
    opts = [f"model.{k}={v!r}".replace(" ", "") for k, v in TINY.items()]
    opts.append("train.warmup_iters=1")
    rng = np.random.default_rng(1)
    batches = [synthetic_batch(rng, 2, (64, 64), num_classes=5)
               for _ in range(3)]
    totals = []
    for dev in ("cpu", "cuda"):
        tr = api.init_trainer(PRESET, opts, device=dev, seed=1)
        totals.append([m["total"] for m in api.train_steps(tr, batches)])
    rel = max(abs(a - b) / abs(b) for a, b in zip(totals[1], totals[0]))
    log("train", f"tiny totals CPU {totals[0]} card {totals[1]}")
    check(rel <= TRAIN_RTOL, f"tiny train card vs CPU rel diff {rel:.3g}")
    return rel


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    log("build", f"{dcnv3.SOURCE}, {dcnv3.BWD_SOURCE} built in "
        f"{time.perf_counter() - t:.1f}s")
    for src in (dcnv3.SOURCE, dcnv3.BWD_SOURCE):
        lib = cuda_build.library_path(src)
        for line in (lib.parent / "build.log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log("build", f"{src}: {line.strip()}")

    gen = torch.Generator().manual_seed(0)
    k = phase_kernel(gen)
    k2 = phase_backward_kernel(gen)
    grad_err = phase_core_autograd(gen)

    t = time.perf_counter()
    im = api.init_model(PRESET, seed=0)
    log("serve", f"flagship {PRESET} built at full width in "
        f"{time.perf_counter() - t:.1f}s")
    s = phase_serve(im)
    log("timing", f"median request_ms={s['request_ms']:.3f} (max "
        f"{s['max_ms']:.3f}, n={s['n']}) peak_mem_gib={s['peak_gib']:.3f} "
        f"on {smi}")
    err = phase_small_reference()
    log("reference", f"tiny model 64x64 card vs CPU max|diff|={err:.3g} "
        f"(tol {MODEL_TOL})")
    del im
    torch.cuda.empty_cache()
    tr = phase_train()
    log("train", f"median step_ms={tr['step_ms']:.3f} (max "
        f"{tr['max_ms']:.3f}, n={tr['n']}) peak_mem_gib={tr['peak_gib']:.3f}"
        f" on {smi}")
    t_err = phase_small_train()
    log("train", f"tiny model 3 steps card vs CPU max rel|diff| of total="
        f"{t_err:.3g} (tol {TRAIN_RTOL})")

    n1 = k[1]
    bound = max(n1["bytes_ms"], n1["ops_ms"])
    kernels = [dict(
        name="dcnv3_sample", route="cuda",
        source="spike2former_tpu_torch/csrc/dcnv3_sample.cu",
        replaces="spike2former_tpu/ops/pallas/dcnv3_kernel.py:440",
        launches=s["launches"] + tr["launches"],
        max_abs_err=max(k["max_abs_err"], s["max_abs_err"]),
        ms=n1["ms"], plain_ms=n1["plain_ms"], bound_ms=bound,
        bound_by="bytes" if n1["bytes_ms"] >= n1["ops_ms"] else "operations",
        library_ms=n1["library_ms"]), dict(
        name="dcnv3_sample_bwd", route="cuda",
        source="spike2former_tpu_torch/csrc/dcnv3_sample_bwd.cu",
        replaces="spike2former_tpu/ops/pallas/dcnv3_kernel.py:773",
        launches=tr["bwd_launches"],
        max_abs_err=max(k2["max_abs_err"], grad_err),
        ms=k2["ms"], plain_ms=k2["plain_ms"],
        bound_ms=max(k2["bytes_ms"], k2["ops_ms"]),
        bound_by=("bytes" if k2["bytes_ms"] >= k2["ops_ms"]
                  else "operations"),
        library_ms=k2["library_ms"])]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
