"""The grouped-layout DCNv3 samplers' tile plans, timed on one NVIDIA GPU.

    python -m spike2former_tpu_torch.profile_grouped

At the flagship's two /16 maps (serve: N=1, 32x44; train: N=6, 32x32; G=32,
Cg=8, P=9, f32; coordinates about 3 px off their 3x3 grid, as
``chip_smoke.py`` draws them), it times the grouped forward
(``csrc/dcnv3_sample_grouped.cu``, gchw) and backward
(``csrc/dcnv3_sample_grouped_bwd.cu``) under ``grouped_tile_plan``'s plan
and under other band counts of a whole staged map, beside K1 and K2 on the
same data, each with a warm L2, in turns (plan, sweep, plan).  Each line is
one JSON object; the first names the card and its power limit.  It exits
non-zero without a card.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys

import torch

from .ops import dcnv3
from .ops.dcnv3_grouped import GroupedPlan, grouped_tile_plan

SHAPES = (("serve", 1, 32, 44), ("train", 6, 32, 32))
G, CG, P = 32, 8, 9
BANDS = (1, 2, 3, 4, 6, 8, 12, 16)


def _ms(fn, iters: int = 100, reps: int = 5) -> float:
    """Median over ``reps`` of the mean device ms of ``iters`` calls,
    enqueued behind a spin kernel so that the events time device work."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / iters)
    return statistics.median(out)


def _inputs(n, h, w, gen):
    """K1's layout and the grouped one, on the card."""
    howo = h * w
    value = torch.randn((n, h, w, G * CG), generator=gen)
    yy, xx = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    k = torch.arange(3)
    gy = (yy.reshape(-1, 1, 1) + k.view(1, 1, 3) - 1).expand(howo, 3, 3)
    gx = (xx.reshape(-1, 1, 1) + k.view(1, 3, 1) - 1).expand(howo, 3, 3)
    shape = (n, howo, G, P)
    py = gy.reshape(1, howo, 1, P).float() + 3 * torch.randn(shape,
                                                              generator=gen)
    px = gx.reshape(1, howo, 1, P).float() + 3 * torch.randn(shape,
                                                              generator=gen)
    mask = torch.rand(shape, generator=gen)
    dout = torch.randn((n, howo, G * CG), generator=gen)
    flat = [t.contiguous().cuda() for t in (value, py, px, mask, dout)]
    feat = flat[0].view(n, h, w, G, CG).permute(0, 3, 1, 2, 4).reshape(
        n, G, h, w * CG).contiguous()
    coords = [t.permute(0, 2, 3, 1).contiguous() for t in flat[1:4]]
    gdout = flat[4].view(n, howo, G, CG).permute(0, 2, 3, 1).contiguous()
    return flat, [feat, *coords, gdout]


def _forward(grouped, plan, n, h, w):
    feat, py, px, mask, _ = grouped
    out = torch.empty((n, G, CG, h * w), device="cuda")
    dcnv3._launch(dcnv3.GROUPED_SOURCE, (feat, py, px, mask, out),
                  (n, h * w, G, P, h, w, CG, *plan, 1, feat.device.index))
    return out


def _backward(grouped, plan, n, h, w):
    feat, py, px, mask, dout = grouped
    dfeat = (torch.empty_like(feat) if plan.whole(h)
             else torch.zeros_like(feat))
    dc = [torch.empty_like(py) for _ in range(3)]
    dcnv3._launch(dcnv3.GROUPED_BWD_SOURCE,
                  (feat, py, px, mask, dout, dfeat, *dc),
                  (n, h * w, G, P, h, w, CG, *plan, feat.device.index))
    return dfeat, *dc


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_grouped: no CUDA device available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "smi": smi}), flush=True)
    dcnv3.build_kernels()
    gen = torch.Generator().manual_seed(0)
    for shape, n, h, w in SHAPES:
        flat, grouped = _inputs(n, h, w, gen)
        fwd_plan = grouped_tile_plan(n, h, w, h * w, G, CG, backward=False)
        bwd_plan = grouped_tile_plan(n, h, w, h * w, G, CG, backward=True)
        want = _forward(grouped, fwd_plan, n, h, w)
        want_b = _backward(grouped, bwd_plan, n, h, w)
        row = dict(shape=shape, forward_plan=fwd_plan,
                   backward_plan=bwd_plan)
        row["k1_ms"] = _ms(lambda: dcnv3.dcnv3_sample(*flat[:4]))
        row["k2_ms"] = _ms(lambda: dcnv3.dcnv3_sample_backward(*flat))
        row["forward_ms"] = [_ms(lambda: _forward(grouped, fwd_plan, n, h,
                                                  w))]
        row["backward_ms"] = [_ms(lambda: _backward(grouped, bwd_plan, n, h,
                                                    w))]
        for bands in BANDS:
            plan = GroupedPlan(bands, h, 0)
            err = (_forward(grouped, plan, n, h, w) - want).abs().max()
            errs = [(a - b).abs().max() for a, b in
                    zip(_backward(grouped, plan, n, h, w), want_b)]
            row[f"forward_ms[bands={bands}]"] = _ms(
                lambda: _forward(grouped, plan, n, h, w))
            row[f"backward_ms[bands={bands}]"] = _ms(
                lambda: _backward(grouped, plan, n, h, w))
            row[f"max_diff[bands={bands}]"] = max(
                float(err), *(float(e) for e in errs))
        row["forward_ms"].append(_ms(lambda: _forward(grouped, fwd_plan, n,
                                                      h, w)))
        row["backward_ms"].append(_ms(lambda: _backward(grouped, bwd_plan,
                                                        n, h, w)))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
