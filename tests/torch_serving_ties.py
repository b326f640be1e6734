"""Why a request's class map in a ``ServingEngine`` micro-batch may differ
whole from its map alone: the flagship at full width with random weights
(seed 0, as ``chip_smoke.py`` builds it) on ``chip_smoke``'s 64 serving
requests, each one's logits alone against its row in micro-batches of
1-16 requests of its bucket, then the engine's threaded traffic a few
times against the requests served one at a time.

    python tests/torch_serving_ties.py

Needs the card (the flagship's K1 at full width).  Prints, for each
request alone, the share of its pixels taken by its commonest class and
its top-two logit gap (median, largest); the 20 least class agreements
over (bucket, batch size, request), each with the largest logit
difference from alone and the largest alone gap between the two classes
where they differ; then, for each engine run, its micro-batch sizes and
its least class agreement against one at a time.  Imports no JAX.
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from spike2former_tpu_torch import api  # noqa: E402
from spike2former_tpu_torch.data.transforms import (pad_to,  # noqa: E402
                                                    resize_keep_ratio)
from spike2former_tpu_torch.device import f32_precision  # noqa: E402
from spike2former_tpu_torch.engine.inference import (bucket_hw,  # noqa
                                                     whole_logits)
from spike2former_tpu_torch.ops import dcnv3  # noqa: E402
from spike2former_tpu_torch.serving import ServingEngine  # noqa: E402

BUCKET = 128


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_serving_ties: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.benchmark = False
    dcnv3.build_kernels()
    im = cs.drawn_model(cs.PRESET, seed=0)
    imgs = cs.serve_images()
    reqs = []
    for img in imgs:
        s = resize_keep_ratio({"image": img, "sem_seg": None, "meta": {}},
                              *im.cfg.data.test_scale)
        h, w = s["image"].shape[:2]
        s = pad_to(s, bucket_hw(h, w, BUCKET))
        reqs.append((s["image"], (h, w), img.shape[:2]))
    buckets: dict = {}
    for i, r in enumerate(reqs):
        buckets.setdefault(r[0].shape[:2], []).append(i)
    print("buckets", {k: len(v) for k, v in buckets.items()}, flush=True)

    def run(idx):
        batch = torch.from_numpy(np.stack([reqs[i][0] for i in idx])).cuda()
        valid = torch.tensor([reqs[i][1] for i in idx], dtype=torch.long)
        with f32_precision(), torch.inference_mode():
            lg = whole_logits(im.model, batch, valid_hw=valid)
            return [cs.post_logits(lg[j:j + 1], reqs[i][1], reqs[i][2])
                    for j, i in enumerate(idx)]

    alone = {}
    for i in range(len(reqs)):
        alone[i] = run([i])[0]
        top2 = alone[i].topk(2, -1).values
        gap = top2[..., 0] - top2[..., 1]
        cls = alone[i].argmax(-1)
        share = torch.bincount(cls.flatten()).max().item() / cls.numel()
        print(f"request {i} alone: commonest class {share:.4f} of the "
              f"pixels, top-two gap median {gap.median().item():.3e} "
              f"largest {gap.max().item():.3e}", flush=True)
    rows = []
    for key, idx in buckets.items():
        for n in range(1, 17):
            for i, out in zip(idx[:n], run(idx[:n])):
                a, b = out.argmax(-1), alone[i].argmax(-1)
                la = alone[i].gather(-1, a[..., None])[..., 0]
                lb = alone[i].gather(-1, b[..., None])[..., 0]
                tie = (lb - la)[a != b]
                rows.append(((a == b).float().mean().item(), key, n, i,
                             (out - alone[i]).abs().max().item(),
                             tie.max().item() if tie.numel() else 0.0))
    rows.sort()
    for r in rows[:20]:
        print("agreement %.6f bucket %s N=%d request %d: logits max|diff| "
              "%.3e, alone gap where the classes differ <= %.3e" % r,
              flush=True)

    for threads in (4, 4, 4, 2, 8, 3):
        with ServingEngine(model=im, max_batch=16, bucket=BUCKET) as eng:
            preds, _ = cs.run_engine(eng, imgs, threads)
            sizes = eng.stats()["batch_sizes"]
        with ServingEngine(model=im, max_batch=16, bucket=BUCKET) as eng:
            seq, _ = cs.run_engine(eng, imgs, 0)
        agree = [float((a == b).mean()) for a, b in zip(preds, seq)]
        k = int(np.argmin(agree))
        print(f"engine, {threads} threads: micro-batches {sizes}, least "
              f"agreement with one at a time {agree[k]:.6f} (request {k})",
              flush=True)
    return 0


if __name__ == "__main__":
    t = time.perf_counter()
    rc = main()
    print(f"took {time.perf_counter() - t:.1f}s")
    sys.exit(rc)
