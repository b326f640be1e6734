"""FPS benchmark (the port's counterpart of the JAX package's
``tools/benchmark.py``, mmseg's tools/analysis_tools/benchmark.py): the
mean time of ``--num-iters`` forwards (``predict_logits``) or, with
``--train``, train steps (``api.train_steps``), after ``--warmup``, each
timing block ended by ``torch.cuda.synchronize()``.

    python -m spike2former_tpu_torch.tools.benchmark [CONFIG] \\
        [--batch-size B] [--num-iters N] [--warmup W] [--image-size H W] \\
        [--dtype bfloat16|float32] [--train] [--accum-steps K] \\
        [--mfu] [--peak-tflops T] [--cfg-options KEY=VALUE ...] \\
        [--device cpu]

It prints one line: ms/iter, img/s, and with ``--mfu`` the TFLOP of a
forward or a step (``utils/flops.py``: what ``FlopCounterMode`` counts
plus the DCN sampler's intrinsic work, which it cannot see) and the MFU
against the card's dense peak for the compute dtype, looked up from the
card's name (``--peak-tflops`` for another card), with the card's
``nvidia-smi`` name and power limit; and the peak device memory.  The
train mode takes ``api.train_steps`` on seeded images and the JAX
benchmark's synthetic GT (16 classes of the dataset as 32x32 blocks,
nearest-upsampled).  Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time

import numpy as np
import torch

from ..api import init_model
from ..device import f32_precision
from ..engine.config import get_config
from ..engine.train import init_trainer, train_steps
from ..models.segmentor import preprocess
from ..utils.flops import dcn_sampling_flops, model_flops, peak_tflops


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config", nargs="?",
                    default="SDTv2_maskformer_DCNpixelDecoder_ade20k")
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--num-iters", type=int, default=200)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--image-size", type=int, nargs=2, default=None)
    ap.add_argument("--dtype", default="bfloat16",
                    help="model.dtype: bfloat16 or float32")
    ap.add_argument("--train", action="store_true",
                    help="time the train step instead of inference")
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--mfu", action="store_true",
                    help="report FLOPs and the model FLOPs utilization")
    ap.add_argument("--peak-tflops", type=float, default=None,
                    help="dense peak TFLOP/s of the card for --dtype; by "
                         "default looked up from the card's name")
    ap.add_argument("--cfg-options", nargs="*", default=[])
    ap.add_argument("--device", default=None,
                    help="torch device; the card when left out")
    return ap


def smi_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return "nvidia-smi unavailable"


def synthetic_gt(rng: np.random.Generator, n: int, hw: tuple[int, int],
                 num_classes: int) -> np.ndarray:
    """The JAX benchmark's GT: ``min(16, num_classes)`` distinct classes
    as a 32x32 grid of blocks, nearest-upsampled to ``hw``."""
    distinct = min(16, num_classes)
    table = rng.choice(num_classes, size=distinct, replace=False)
    blocks = table[rng.integers(0, distinct, (n, 32, 32))]
    up = np.repeat(np.repeat(blocks, -(-hw[0] // 32), axis=1),
                   -(-hw[1] // 32), axis=2)
    return up[:, :hw[0], :hw[1]].astype(np.int64)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(args) -> dict:
    """Time ``args``' configuration; returns the numbers of the line."""
    cfg = get_config(args.config, args.cfg_options)
    cfg.model.dtype = args.dtype
    size = tuple(args.image_size or cfg.data.crop_size)
    accum = args.accum_steps if args.train else 1
    total = args.batch_size * accum
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (total, *size, 3), dtype=np.uint8)
    m = cfg.model
    group = min(m.dcn_group, m.feat_channels)
    dcn = dict(num_layers=m.num_encoder_layers, group=group,
               group_channels=m.feat_channels // group)
    if args.train:
        cfg.train.accum_steps = accum
        cfg.data.batch_size = total
        tr = init_trainer(cfg, device=args.device)
        dev = tr.device
        batch = (images, synthetic_gt(rng, total, size, m.num_classes))

        def step():
            train_steps(tr, [batch])

        count = step
        dcn_flops = dcn_sampling_flops(total, size, train=True, **dcn)
        if m.remat:      # the recomputation samples again
            dcn_flops += dcn_sampling_flops(total, size, **dcn)
    else:
        im = init_model(cfg, device=args.device)
        dev = im.device
        x = preprocess(torch.from_numpy(images).to(dev))

        def count():
            with f32_precision():
                im.model.predict_logits(x)

        step = torch.inference_mode()(count)
        dcn_flops = dcn_sampling_flops(total, size, **dcn)
    for _ in range(args.warmup):
        step()
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for _ in range(args.num_iters):
        step()
    _sync(dev)
    dt = (time.perf_counter() - t0) / args.num_iters
    out = dict(name=cfg.name, train=args.train, ms=dt * 1e3,
               img_s=total / dt, batch=args.batch_size, accum=accum,
               size=size, T=m.T, dtype=args.dtype,
               peak_gib=(torch.cuda.max_memory_allocated(dev) / 2 ** 30
                         if dev.type == "cuda" else None))
    if args.mfu:
        if args.peak_tflops is not None:
            peak = args.peak_tflops
        elif dev.type == "cuda":
            peak = peak_tflops(torch.cuda.get_device_name(dev), args.dtype)
        else:
            raise SystemExit("--mfu on the CPU needs --peak-tflops")
        # counted with autograd on: FlopCounterMode's module tracker
        # hooks the inputs that require a gradient (the head's query
        # embeddings), which inference mode does not record
        counted = model_flops(count)
        flops = counted + dcn_flops
        out.update(flops=flops, counted_flops=counted, dcn_flops=dcn_flops,
                   peak_tflops=peak, mfu=flops / dt / (peak * 1e12),
                   smi=smi_line() if dev.type == "cuda" else "cpu")
    return out


def format_line(r: dict) -> str:
    what = "TRAIN" if r["train"] else "INFER"
    line = (f"{r['name']} {what}: {r['ms']:.2f} ms/iter, {r['img_s']:.2f} "
            f"img/s (batch {r['batch']}, accum {r['accum']}, "
            f"{r['size'][0]}x{r['size'][1]}, T={r['T']}, {r['dtype']}")
    if "mfu" in r:
        per = "step" if r["train"] else "fwd"
        line += (f", {r['flops'] / 1e12:.4f} TFLOP/{per} (DCN sampler "
                 f"{r['dcn_flops'] / 1e12:.4f}), MFU {r['mfu'] * 100:.2f}% "
                 f"of {r['peak_tflops']:g} TFLOP/s on {r['smi']}")
    if r["peak_gib"] is not None:
        line += f", peak {r['peak_gib']:.3f} GiB"
    return line + ")"


def main(argv=None) -> int:
    print(format_line(run(_parser().parse_args(argv))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
