"""Where a request's time goes, on one NVIDIA GPU.

    python -m spike2former_tpu_torch.profile_request [--preset NAME] \
        [--cfg-options] [KEY=VALUE ...]

Serves the same seeded requests as ``chip_smoke.py`` (the flagship preset,
or ``--preset``'s, e.g. ``fpn_sdtv3_512x512_19M_ade20k``, at full width,
the test draw of seeded random weights (``engine/weights.py:randomize_``),
uint8 images of 512x683, 683x512, 512x512, with
TF32 off; the config overrides given, e.g. ``model.dtype='bfloat16'``,
``model.masked_attention=True`` or ``model.decoder='dab'``) and prints:

* host stages per request (resize/pad, upload, forward, post-process,
  download), median ms over the timed rounds;
* device time per model part (backbone, each DCN encoder layer and its
  DCNv3 module, the FPN and mask features, each decoder layer, the SDME tail
  with the semantic einsum; for the FPN family the backbone, the neck and
  the head, or each cascade stage), from CUDA events recorded by forward
  hooks;
* from ``torch.profiler``: device launches (kernels and copies) per
  request, device busy time against the unprofiled request time, and the
  kernels with the most device time.

It exits non-zero without a card, or if the profiler sees no device time.
"""
from __future__ import annotations

import json
import statistics
import sys
import time
from collections import defaultdict

import numpy as np
import torch

from . import api
from .engine.inference import postprocess_pred, whole_logits
from .engine.weights import randomize_

PRESET = "SDTv2_maskformer_DCNpixelDecoder_ade20k"
REQUEST_SHAPES = ((512, 683), (683, 512), (512, 512))
ROUNDS = 5


def _stages(im, img):
    """One request split into host stages; returns {stage: ms}."""
    sync = torch.cuda.synchronize
    out, t = {}, time.perf_counter()

    def mark(name):
        nonlocal t
        sync()
        now = time.perf_counter()
        out[name] = (now - t) * 1e3
        t = now

    padded, hw = api.resize_and_pad(im.cfg, img)
    mark("resize_pad")
    x = torch.from_numpy(padded[None]).to(im.device)
    mark("upload")
    logits = whole_logits(im.model, x)
    mark("forward")
    pred = postprocess_pred(logits, hw, img.shape[:2])
    mark("postprocess")
    pred[0].cpu().numpy()
    mark("download")
    return out


def model_parts(model) -> dict:
    """The parts of ``model`` to time, by name."""
    parts = {"backbone": model.backbone}
    if hasattr(model, "neck"):      # the FPN family
        parts["neck"] = model.neck
        if hasattr(model, "head"):
            parts["head"] = model.head
        for i in range(getattr(model, "num_stages", 0)):
            parts[f"stage{i}"] = getattr(model, f"stage{i}")
        return parts
    head = model.head
    dec = head.pixel_decoder
    for i in range(dec.num_encoder_layers):
        layer = getattr(dec, f"encoder_{i}")
        parts[f"encoder_{i}"] = layer
        parts[f"encoder_{i}.dcn"] = layer.dcn
    parts["pixel_decoder"] = dec
    # the DAB head's decoder layers are its ``dab_decoder.layer_{i}``
    layers, name = ((head.dab_decoder, "layer") if head.decoder == "dab"
                    else (head, "decoder"))
    for i in range(head.num_decoder_layers):
        parts[f"decoder_{i}"] = getattr(layers, f"{name}_{i}")
    parts["head"] = head
    return parts


def _part_hooks(model):
    """Forward hooks recording CUDA events around the model's parts."""
    parts = model_parts(model)
    events = defaultdict(list)
    handles = []
    for name, mod in parts.items():
        def pre(_m, _a, name=name):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            events[name].append([e, None])

        def post(_m, _a, _o, name=name):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            events[name][-1][1] = e

        handles += [mod.register_forward_pre_hook(pre),
                    mod.register_forward_hook(post)]
    return events, handles


def preset_and_overrides(argv: list[str], default: str = PRESET
                         ) -> tuple[str, list[str]]:
    """``--preset NAME`` (``default`` without it) and the config
    overrides among ``argv``, with or without ``--cfg-options``."""
    argv = [a for a in argv if a != "--cfg-options"]
    if "--preset" in argv:
        i = argv.index("--preset")
        return argv[i + 1], argv[:i] + argv[i + 2:]
    return default, argv


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("profile_request: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)} torch {torch.__version__}",
          flush=True)
    preset, overrides = preset_and_overrides(argv)
    im = api.init_model(preset, overrides=overrides, seed=0)
    randomize_(im.model, 0)   # the test draw: weights that fire
    print(f"preset={preset} dtype={im.cfg.model.dtype}", flush=True)
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
            for hw in REQUEST_SHAPES]
    for img in imgs:  # warm-up
        api.inference_model(im, img)

    stages = defaultdict(list)
    for _ in range(ROUNDS):
        for img in imgs:
            for k, v in _stages(im, img).items():
                stages[k].append(v)
    host = {k: statistics.median(v) for k, v in stages.items()}
    host["request"] = sum(host.values())
    print("host_stages_ms " + json.dumps(
        {k: round(v, 3) for k, v in host.items()}), flush=True)

    events, handles = _part_hooks(im.model)
    for _ in range(ROUNDS):
        for img in imgs:
            api.inference_model(im, img)
    torch.cuda.synchronize()
    for h in handles:
        h.remove()
    parts = {k: statistics.median(s.elapsed_time(e) for s, e in v)
             for k, v in events.items()}
    print("device_parts_ms " + json.dumps(
        {k: round(v, 3) for k, v in parts.items()}), flush=True)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for img in imgs:
            api.inference_model(im, img)
        torch.cuda.synchronize()
    # device-side events only: the CPU-side operator events report the
    # same kernels' time again
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / len(imgs)
    launches = sum(e.count for e in kernels) / len(imgs)
    if busy_ms <= 0:
        print("profile_request: the profiler saw no device time",
              file=sys.stderr)
        return 1
    print(f"per request: device_busy_ms={busy_ms:.3f} against request_ms="
          f"{host['request']:.3f} busy_share={busy_ms / host['request']:.3f} "
          f"device_launches={launches:.1f}", flush=True)
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for e in kernels[:15]:
        print(f"  {e.self_device_time_total / 1e3 / len(imgs):9.3f} ms/req "
              f"{e.count / len(imgs):7.1f} calls/req  {e.key[:90]}",
              flush=True)
    dcn = [e for e in kernels if "dcnv3_sample" in e.key]
    print(f"dcnv3_sample kernel per request: "
          f"{sum(e.self_device_time_total for e in dcn) / 1e3 / len(imgs):.4f}"
          f" ms in {sum(e.count for e in dcn) / len(imgs):.1f} launches",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
