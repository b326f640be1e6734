"""The port's CUDA kernels on the card, held against their plain versions,
and the entry points' precision on the card.

Marked ``cuda``: these tests skip without a GPU.  On a machine with one:
``python -m pytest --noconftest tests/test_torch_cuda.py``.
"""
import copy

import numpy as np
import pytest
import torch

from spike2former_tpu_torch import api
from spike2former_tpu_torch.data.synthetic import (synthetic_batch,
                                                    write_ade_tree)
from spike2former_tpu_torch.device import f32_precision
from spike2former_tpu_torch.engine import checkpoint, inference
from spike2former_tpu_torch.engine.config import build_model, get_config
from spike2former_tpu_torch.engine.weights import randomize_
from spike2former_tpu_torch.losses.matcher import BIG_COST, auction_match
from spike2former_tpu_torch.models.segmentor import Spike2Former
from spike2former_tpu_torch.ops import dcnv3, dcnv3_grouped
from spike2former_tpu_torch.profile_train import sync_sites
from spike2former_tpu_torch.tools import train as train_cli
from spike2former_tpu_torch.utils import jax_random as jr

pytestmark = pytest.mark.cuda

PRESET = "SDTv2_maskformer_DCNpixelDecoder_ade20k"
TINY_OPTS = ["model.num_classes=5", "model.embed_dim=(8,16,24,32)",
             "model.backbone_heads=4", "model.feat_channels=16",
             "model.num_queries=4", "model.num_decoder_layers=1",
             "model.num_encoder_layers=1", "model.depths_stage3=1",
             "model.depths_stage4=1", "model.dcn_group=4"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def cuda(card):
    """The card, with TF32 off for tests that call below the entry
    points, which set it themselves."""
    with f32_precision():
        yield card


@pytest.mark.parametrize("cg", [1, 2, 4, 8, 16, 32])
def test_kernel_matches_plain(cuda, cg):
    gen = torch.Generator().manual_seed(cg)
    n, h, w, g, p, howo = 2, 9, 13, 4, 9, 60
    value = torch.randn((n, h, w, g * cg), generator=gen)
    py = torch.rand((n, howo, g, p), generator=gen) * (h + 4) - 2
    px = torch.rand((n, howo, g, p), generator=gen) * (w + 4) - 2
    py[0, :5] = py[0, :5].floor()  # exact integer coordinates
    mask = torch.rand((n, howo, g, p), generator=gen)
    want = dcnv3.dcnv3_sample_reference(value, py, px, mask)
    before = dcnv3.dcnv3_sample.launches
    got = dcnv3.dcnv3_sample(*(t.to(cuda) for t in (value, py, px, mask)))
    torch.cuda.synchronize()
    assert dcnv3.dcnv3_sample.launches == before + 1
    torch.testing.assert_close(got.cpu(), want, atol=2e-5, rtol=1e-5)



def _drawn_model(*args, seed: int = 0, **kw):
    """``api.init_model`` with the tests' draw (``randomize_``): weights
    whose spikes fire, where flax's laws (the default) leave the DCN
    branch silent."""
    im = api.init_model(*args, seed=seed, **kw)
    randomize_(im.model, seed)
    return im


def _drawn_trainer(*args, seed: int | None = None, **kw):
    """``api.init_trainer`` with the tests' draw, as ``_drawn_model``."""
    tr = api.init_trainer(*args, seed=seed, **kw)
    randomize_(tr.state.model, tr.cfg.train.seed if seed is None else seed)
    return tr

def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    v = torch.zeros((1, 4, 4, 24), device=cuda)
    c = torch.zeros((1, 16, 8, 9), device=cuda)
    with pytest.raises(ValueError):
        dcnv3.dcnv3_sample(v, c, c, c)          # Cg = 3
    v = torch.zeros((1, 4, 4, 32), device=cuda)
    with pytest.raises(TypeError):
        dcnv3.dcnv3_sample(v.double(), c, c, c)
    strided = torch.zeros((1, 16, 9, 8), device=cuda).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        dcnv3.dcnv3_sample(v, strided, c, c)


def test_tiny_model_card_matches_cpu(cuda):
    cpu = randomize_(Spike2Former(
        T=1, num_classes=5, embed_dim=(8, 16, 24, 32), backbone_heads=4,
        feat_channels=16, num_queries=4, num_decoder_layers=1,
        num_encoder_layers=1, depths_stage3=1, depths_stage4=1,
        dcn_group=4), seed=1)
    gpu = copy.deepcopy(cpu).to(cuda)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (1, 64, 64, 3)).astype(np.float32))
    with torch.inference_mode():
        want = cpu.predict_logits(x)
        got = gpu.predict_logits(x.to(cuda)).cpu()
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-3)


# --- slice two: the backward kernel and the train step ----------------------

def _coords(gen, n, howo, g, p, h, w):
    py = torch.rand((n, howo, g, p), generator=gen) * (h + 4) - 2
    px = torch.rand((n, howo, g, p), generator=gen) * (w + 4) - 2
    py[0, :5] = py[0, :5].floor()  # exact integer coordinates
    px[1, :7] = px[1, :7].round()
    return py, px


@pytest.mark.parametrize("cg", [1, 2, 4, 8, 16, 32])
def test_backward_kernel_matches_plain(cuda, cg):
    """K2 against ``dcnv3_sample_backward_reference`` at atol 3e-4 /
    rtol 1e-3 (tests/test_dcnv3.py's backward tolerance; the atomics sum
    dvalue in a varying order)."""
    gen = torch.Generator().manual_seed(10 + cg)
    n, h, w, g, p, howo = 2, 9, 13, 4, 9, 60
    value = torch.randn((n, h, w, g * cg), generator=gen)
    py, px = _coords(gen, n, howo, g, p, h, w)
    mask = torch.rand((n, howo, g, p), generator=gen)
    dout = torch.randn((n, howo, g * cg), generator=gen)
    want = dcnv3.dcnv3_sample_backward_reference(value, py, px, mask, dout)
    before = dcnv3.dcnv3_sample_backward.launches
    got = dcnv3.dcnv3_sample_backward(
        *(t.to(cuda) for t in (value, py, px, mask, dout)))
    torch.cuda.synchronize()
    assert dcnv3.dcnv3_sample_backward.launches == before + 1
    for gv, wv in zip(got, want):
        torch.testing.assert_close(gv.cpu(), wv, atol=3e-4, rtol=1e-3)


def test_dcnv3_core_autograd_card_matches_cpu(cuda):
    """Gradients to x, offset and mask through ``dcnv3_core`` on the card
    (K1 forward, K2 backward) equal those of the plain path on the CPU."""
    gen = torch.Generator().manual_seed(3)
    n, h, w, g, gc = 2, 7, 9, 4, 8
    x = torch.randn((n, h, w, g * gc), generator=gen)
    off = torch.randn((n, h, w, g * 18), generator=gen) * 2
    mask = torch.rand((n, h, w, g * 9), generator=gen)
    cot = torch.randn((n, h, w, g * gc), generator=gen)
    grads = []
    for dev in ("cpu", cuda):
        ts = [t.clone().to(dev).requires_grad_() for t in (x, off, mask)]
        (dcnv3.dcnv3_core(*ts, group=g, group_channels=gc)
         * cot.to(dev)).sum().backward()
        grads.append([t.grad.cpu() for t in ts])
    for gc_, gg in zip(*grads):
        assert gg.abs().max() > 0
        torch.testing.assert_close(gg, gc_, atol=3e-4, rtol=1e-3)


# --- slice four: K1 and K2 with shared-memory tiles --------------------------

KINDS = ["random", "far", "offmap", "integer"]


def _check_tiled_kernels(cuda, n, h, w, g, cg, kind, seed):
    """K1 and K2 under ``tile_plan``'s plan against their plain versions
    on coordinates from ``chip_smoke.sampler_inputs``: taps about 3 px off
    the grid ('random'), up to 10 px off so most leave a band's halo
    ('far'), spread over and off the map ('offmap'), and at exact integer
    coordinates ('integer')."""
    from chip_smoke import sampler_inputs

    gen = torch.Generator().manual_seed(seed)
    value, py, px, mask = sampler_inputs(
        n, h, w, g, cg, 9, "far" if kind == "offmap" else kind, gen,
        device=cuda)
    if kind == "offmap":
        py = (torch.rand(py.shape, generator=gen) * (h + 8) - 4).to(cuda)
        px = (torch.rand(px.shape, generator=gen) * (w + 8) - 4).to(cuda)
    dout = torch.randn((n, h * w, g * cg), generator=gen).to(cuda)
    want = dcnv3.dcnv3_sample_reference(value, py, px, mask)
    want_b = dcnv3.dcnv3_sample_backward_reference(value, py, px, mask,
                                                   dout)
    before = dcnv3.dcnv3_sample.launches
    got = dcnv3.dcnv3_sample(value, py, px, mask)
    torch.cuda.synchronize()
    assert dcnv3.dcnv3_sample.launches == before + 1
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-5)
    before = dcnv3.dcnv3_sample_backward.launches
    got = dcnv3.dcnv3_sample_backward(value, py, px, mask, dout)
    torch.cuda.synchronize()
    assert dcnv3.dcnv3_sample_backward.launches == before + 1
    for name, gv, wv in zip(("dvalue", "dpy", "dpx", "dmask"), got, want_b):
        torch.testing.assert_close(gv, wv, atol=3e-4, rtol=1e-3,
                                   msg=lambda m: f"K2 {name}: {m}")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("cg", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("shape", [(1, 64, 128), (1, 8, 2048)],
                         ids=["64x128", "8x2048"])
def test_kernels_on_a_map_larger_than_a_tile(cuda, shape, cg, kind):
    """G=4 on a 64x128 map, where both kernels stage bands of rows with
    halos from Cg=8 on (K2's adds outside them go to device memory), and
    on an 8x2048 map, where not three rows fit from Cg=8 (K1) or Cg=2 (K2)
    on and nothing is staged (``test_torch_dcnv3_tiles.py`` holds the
    plans)."""
    _check_tiled_kernels(cuda, *shape, 4, cg, kind, 100 + cg)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("cg", [1, 2, 4, 8, 16, 32])
def test_kernels_in_resident_blocks(cuda, cg, kind):
    """N=5, 16x16, G=32: 160 (image, group) pairs, more than an H100's
    SMs, so K1 runs resident blocks over two groups each, as at the
    flagship's train shape."""
    plan = dcnv3.tile_plan(5, 16, 16, 256, 32, cg, 9, backward=False)
    assert plan.bands == 0 and plan.groups == 2
    _check_tiled_kernels(cuda, 5, 16, 16, 32, cg, kind, 200 + cg)


def test_dcnv3_core_autograd_card_matches_cpu_on_a_large_map(cuda):
    """Gradients through ``dcnv3_core`` on a 64x128 map with offsets up
    to 10 px (K1 and K2 under their own plans, bands at Cg=8) equal those
    of the plain path on the CPU."""
    gen = torch.Generator().manual_seed(5)
    n, h, w, g, gc = 1, 64, 128, 4, 8
    x = torch.randn((n, h, w, g * gc), generator=gen)
    off = (torch.rand((n, h, w, g * 18), generator=gen) * 20 - 10)
    mask = torch.rand((n, h, w, g * 9), generator=gen)
    cot = torch.randn((n, h, w, g * gc), generator=gen)
    assert not dcnv3.tile_plan(n, h, w, h * w, g, gc, 9,
                               backward=True).whole(h)
    grads = []
    for dev in ("cpu", cuda):
        ts = [t.clone().to(dev).requires_grad_() for t in (x, off, mask)]
        (dcnv3.dcnv3_core(*ts, group=g, group_channels=gc)
         * cot.to(dev)).sum().backward()
        grads.append([t.grad.cpu() for t in ts])
    for gc_, gg in zip(*grads):
        assert gg.abs().max() > 0
        torch.testing.assert_close(gg, gc_, atol=3e-4, rtol=1e-3)


@pytest.mark.parametrize("matcher", ["host", "auction"])
def test_tiny_train_step_card_matches_cpu(cuda, matcher):
    """One tiny train step on the card (through K1 and K2) against the
    same step on the CPU: every loss at 1e-4 relative, grad_norm at 1e-3
    relative (the atomics and cuDNN sum in other orders).  With the
    preset's auction matcher the maps hold 4 classes for the 4 queries:
    the auction assumes no more valid slots than queries."""
    opts = TINY_OPTS + ["train.warmup_iters=1", f"train.matcher='{matcher}'"]
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    blocks = rng.integers(0, 5 if matcher == "host" else 4, (2, 4, 4))
    sem = np.kron(blocks, np.ones((16, 16), np.int64))
    sem[:, :4] = 255
    out = []
    for dev in ("cpu", cuda):
        tr = _drawn_trainer("SDTv2_maskformer_DCNpixelDecoder_ade20k",
                             opts, device=dev, seed=1)
        before = dcnv3.dcnv3_sample_backward.launches
        out.append(api.train_steps(tr, [(images, sem)])[0])
        if dev != "cpu":
            assert dcnv3.dcnv3_sample_backward.launches == before + 1
    cpu, card = out
    for k in cpu:
        tol = 1e-3 if k == "grad_norm" else 1e-4
        np.testing.assert_allclose(card[k], cpu[k], rtol=tol, atol=1e-6,
                                   err_msg=k)


# --- the entry points' precision ---------------------------------------------

def _tf32_flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


@pytest.mark.parametrize("matmul_tf32", [False, True])
def test_entry_points_compute_in_f32_whatever_the_tf32_flags(
        card, monkeypatch, matmul_tf32):
    """With TF32 on for cuDNN (torch's default) and for matmuls or not,
    ``api.inference_model``'s logits and 3 steps of ``api.train_steps``
    on the card agree with the CPU at 1e-3, as ``model.dtype='float32'``
    asks, and the caller's flags are as they were after each call."""
    saved = _tf32_flags()
    flags = (matmul_tf32, True)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 \
        = flags
    try:
        logits = []
        real = api.whole_logits

        def capture(model, x):
            logits.append(real(model, x).cpu())
            return logits[-1]

        monkeypatch.setattr(api, "whole_logits", capture)
        opts = TINY_OPTS + ["data.test_scale=(128,96)"]
        img = np.random.default_rng(0).integers(0, 256, (90, 120, 3),
                                                dtype=np.uint8)
        preds = []
        for dev in ("cpu", None):
            im = _drawn_model(PRESET, overrides=opts, device=dev, seed=1)
            preds.append(api.inference_model(im, img))
            assert _tf32_flags() == flags
        torch.testing.assert_close(logits[1], logits[0], atol=1e-3,
                                   rtol=1e-3)

        rng = np.random.default_rng(1)
        images = rng.integers(0, 256, (3, 2, 64, 64, 3), dtype=np.uint8)
        # 4 classes for the 4 queries: the preset's auction assumes no
        # more valid GT slots than queries
        sem = np.kron(rng.integers(0, 4, (3, 2, 4, 4)),
                      np.ones((16, 16), np.int64))
        totals = []
        for dev in ("cpu", None):
            tr = _drawn_trainer(PRESET, TINY_OPTS + [
                "train.warmup_iters=1"], device=dev, seed=1)
            totals.append([m["total"] for m in api.train_steps(
                tr, list(zip(images, sem)))])
            assert _tf32_flags() == flags
        np.testing.assert_allclose(totals[1], totals[0], rtol=1e-3)
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = saved


# --- the grouped-layout sampler (K3-K7) --------------------------------------

def _grouped_case(gen, cg, n=2, g=4, h=9, w=13, p=9, howo=61):
    """feat [N, G, H, W*Cg], coordinates and mask [N, G, P, HoWo] (some
    taps off the map, some exact integers), dout [N, G, Cg, HoWo], and
    the static arguments; HoWo odd."""
    feat = torch.randn((n, g, h, w * cg), generator=gen)
    py = torch.rand((n, g, p, howo), generator=gen) * (h + 4) - 2
    px = torch.rand((n, g, p, howo), generator=gen) * (w + 4) - 2
    py[0, :, :, :5] = py[0, :, :, :5].floor()
    px[1, :, :, :7] = px[1, :, :, :7].round()
    mask = torch.rand((n, g, p, howo), generator=gen)
    dout = torch.randn((n, g, cg, howo), generator=gen)
    return (feat, py, px, mask, dout), dict(
        num_points=p, h_in=h, w_in=w, group=g, group_channels=cg)


@pytest.mark.parametrize("layout", ["gchw", "ghwc"])
@pytest.mark.parametrize("cg", [1, 2, 4, 8, 16, 32])
def test_grouped_kernel_matches_plain(cuda, cg, layout):
    """The grouped forward kernel (K3/K5/K6 in gchw, K4 in ghwc) against
    its plain version at tests/test_dcnv3.py's f32 tolerance."""
    (feat, py, px, mask, _), static = _grouped_case(
        torch.Generator().manual_seed(20 + cg), cg)
    want = dcnv3_grouped.dcnv3_sample_grouped_reference(
        feat, py, px, mask, **static, out_layout=layout)
    sampler = dcnv3_grouped.dcnv3_sample_grouped
    before = sampler.launches
    got = sampler(*(t.to(cuda) for t in (feat, py, px, mask)), **static,
                  out_layout=layout)
    torch.cuda.synchronize()
    assert sampler.launches == before + 1
    torch.testing.assert_close(got.cpu(), want, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("cg", [1, 2, 4, 8, 16, 32])
def test_grouped_backward_kernel_matches_plain(cuda, cg):
    """The grouped backward kernel (K7) against its plain version at
    atol 3e-4 / rtol 1e-3 (the atomics sum dfeat in a varying order)."""
    arrays, static = _grouped_case(torch.Generator().manual_seed(40 + cg),
                                   cg)
    want = dcnv3_grouped.dcnv3_sample_grouped_backward_reference(
        *arrays, **static)
    bwd = dcnv3_grouped.dcnv3_sample_grouped_backward
    before = bwd.launches
    got = bwd(*(t.to(cuda) for t in arrays), **static)
    torch.cuda.synchronize()
    assert bwd.launches == before + 1
    for gv, wv in zip(got, want):
        torch.testing.assert_close(gv.cpu(), wv, atol=3e-4, rtol=1e-3)


def _within_one_bf16_ulp(got, want) -> bool:
    """Each element within one bf16 ulp of ``want``'s (the ulp of
    max(|want|, 1e-2))."""
    scale = want.float().abs().clamp(min=1e-2)
    ulp = torch.exp2(torch.floor(torch.log2(scale)) - 7)
    return bool(((got.float() - want.float()).abs() <= ulp).all())


@pytest.mark.parametrize("round_columns", [False, True])
@pytest.mark.parametrize("layout", ["gchw", "ghwc"])
@pytest.mark.parametrize("cg", [1, 8, 32])
def test_grouped_bf16_kernel_matches_plain(cuda, cg, layout,
                                           round_columns):
    """The bf16 form of the grouped forward (K3/K6 with the column
    weights rounded, K4/K5 without) against its plain version on the CPU,
    within one bf16 ulp: both round where the JAX kernels round and sum
    the rounded columns in f32 in other orders."""
    (feat, py, px, mask, _), static = _grouped_case(
        torch.Generator().manual_seed(60 + cg), cg)
    feat = feat.bfloat16()
    kw = dict(**static, out_layout=layout, round_columns=round_columns)
    want = dcnv3_grouped.dcnv3_sample_grouped_reference(feat, py, px, mask,
                                                        **kw)
    sampler = dcnv3_grouped.dcnv3_sample_grouped
    before = sampler.bf16_launches
    got = sampler(*(t.to(cuda) for t in (feat, py, px, mask)), **kw)
    torch.cuda.synchronize()
    assert sampler.bf16_launches == before + 1
    assert got.dtype == torch.bfloat16
    assert _within_one_bf16_ulp(got.cpu(), want)


@pytest.mark.parametrize("layout", ["gchw", "ghwc"])
@pytest.mark.parametrize("p", [1, 4, 16, 25])
def test_grouped_bf16_kernel_any_points(cuda, p, layout):
    """The bf16 grouped forward at other point counts than the flagship's
    9 against its plain version within one bf16 ulp: up to 9 points it
    sorts the taps in registers, beyond that it walks point by point."""
    (feat, py, px, mask, _), static = _grouped_case(
        torch.Generator().manual_seed(90 + p), 8, p=p)
    feat = feat.bfloat16()
    kw = dict(**static, out_layout=layout, round_columns=True)
    want = dcnv3_grouped.dcnv3_sample_grouped_reference(feat, py, px, mask,
                                                        **kw)
    got = dcnv3_grouped.dcnv3_sample_grouped(
        *(t.to(cuda) for t in (feat, py, px, mask)), **kw)
    torch.cuda.synchronize()
    assert _within_one_bf16_ulp(got.cpu(), want)


@pytest.mark.parametrize("cg", [1, 8, 32])
def test_grouped_bf16_backward_kernel_matches_plain(cuda, cg):
    """The bf16 form of the grouped backward (K7's) against its plain
    version: dfeat (summed in f32 by atomics, rounded once) within one
    bf16 ulp, dpy/dpx/dmask at atol 3e-4 / rtol 1e-3."""
    arrays, static = _grouped_case(torch.Generator().manual_seed(80 + cg),
                                   cg)
    feat, py, px, mask, dout = arrays
    arrays = (feat.bfloat16(), py, px, mask, dout.bfloat16())
    want = dcnv3_grouped.dcnv3_sample_grouped_backward_reference(*arrays,
                                                                 **static)
    bwd = dcnv3_grouped.dcnv3_sample_grouped_backward
    before = bwd.bf16_launches
    got = bwd(*(t.to(cuda) for t in arrays), **static)
    torch.cuda.synchronize()
    assert bwd.bf16_launches == before + 1
    assert got[0].dtype == torch.bfloat16
    assert _within_one_bf16_ulp(got[0].cpu(), want[0])
    for gv, wv in zip(got[1:], want[1:]):
        torch.testing.assert_close(gv.cpu(), wv, atol=3e-4, rtol=1e-3)


@pytest.mark.parametrize("layout", ["gchw", "ghwc"])
def test_grouped_autograd_card_matches_cpu(cuda, layout):
    """Autograd through the grouped sampler on the card (forward kernel,
    backward kernel, K4's cotangent transposed) against the plain path's
    autograd on the CPU."""
    (feat, py, px, mask, _), static = _grouped_case(
        torch.Generator().manual_seed(7), 8)
    grads = []
    for dev in ("cpu", cuda):
        ins = [t.clone().to(dev).requires_grad_()
               for t in (feat, py, px, mask)]
        out = dcnv3_grouped.dcnv3_sample_grouped(*ins, **static,
                                                 out_layout=layout)
        cot = torch.linspace(-1, 1, out.numel()).view(out.shape).to(dev)
        grads.append([g.cpu() for g in torch.autograd.grad(out, ins, cot)])
    for gc_, gg in zip(*grads):
        assert gg.abs().max() > 0
        torch.testing.assert_close(gg, gc_, atol=3e-4, rtol=1e-3)


def test_grouped_wrappers_reject_what_the_kernels_do_not_take(cuda):
    (feat, py, _, _, dout), static = _grouped_case(
        torch.Generator().manual_seed(0), 4)
    feat, py, dout = feat.to(cuda), py.to(cuda), dout.to(cuda)
    fwd = dcnv3_grouped.dcnv3_sample_grouped
    bwd = dcnv3_grouped.dcnv3_sample_grouped_backward
    odd = torch.zeros(py.numel() + 1, device=cuda)[1:].view(py.shape)
    with pytest.raises(ValueError):
        fwd(feat, py, py, py, **{**static, "group_channels": 3},
            out_layout="gchw")
    with pytest.raises(ValueError):
        fwd(feat, py, py, py, **{**static, "w_in": 12}, out_layout="gchw")
    with pytest.raises(TypeError):
        bwd(feat, py, py, py, dout.double(), **static)
    with pytest.raises(ValueError, match="contiguous"):
        fwd(feat, py, py.transpose(2, 3).contiguous().transpose(2, 3), py,
            **static, out_layout="gchw")
    with pytest.raises(ValueError, match="aligned"):
        fwd(feat, py, py, odd, **static, out_layout="ghwc")
    with pytest.raises(ValueError, match="cpu"):
        fwd(feat, py, py.cpu(), py, **static, out_layout="gchw")


# --- slice six: the grouped kernels with shared-memory tiles ----------------

@pytest.mark.parametrize("kind", ["random", "far", "offmap", "zero",
                                  "integer", "nan"])
@pytest.mark.parametrize("cg", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("shape", [(1, 64, 128), (1, 8, 2048), (2, 9, 13)],
                         ids=["64x128", "8x2048", "9x13"])
def test_grouped_kernels_under_their_plans(cuda, shape, cg, kind):
    """``chip_smoke.check_grouped``: the grouped forward in both layouts
    and the grouped backward against their plain versions (a point with a
    NaN coordinate dropped) and against K1/K2 on the same data, with G=4
    on a 64x128 map, staged in bands of rows with halos from Cg=8 on; on
    an 8x2048 map, where nothing is staged from Cg=8 on; on a 9x13 map,
    which one band of the backward owns whole (no zero-fill)
    (``test_torch_dcnv3_grouped_tiles.py`` holds the plans)."""
    from chip_smoke import check_grouped

    check_grouped(*shape, 4, cg, kind,
                  torch.Generator().manual_seed(300 + cg))


@pytest.mark.parametrize("kind", ["random", "far", "offmap", "zero",
                                  "integer", "nan"])
@pytest.mark.parametrize("shape", [(1, 32, 44), (6, 32, 32)],
                         ids=["serve", "train"])
def test_grouped_kernels_at_the_flagship_shapes(cuda, shape, kind):
    """G=32, Cg=8: a request's /16 map in 4 bands of whole maps, a train
    step's in 2 (forward) and 4 (backward)."""
    from chip_smoke import check_grouped

    check_grouped(*shape, 32, 8, kind, torch.Generator().manual_seed(400))


# --- slice five: the auction matcher and the eval path -----------------------

def _step_costs(seed=0):
    """A flagship step's cost batch shape: 42 problems of 100 queries by
    32 slots, 10-30 of them valid."""
    rng = np.random.default_rng(seed)
    c = rng.normal(0, 4, (42, 100, 32)).astype(np.float32)
    for i, n in enumerate(rng.integers(10, 31, 42)):
        c[i, :, n:] = BIG_COST
    return torch.from_numpy(c)


@pytest.mark.parametrize("num_iters", [600, 3, 1])
def test_auction_card_matches_cpu(card, num_iters):
    """The same assignment and repaired count on the card as on the CPU,
    uncapped and capped, and the card's only synchronizations are the
    loop condition's reads that ``stats.syncs`` counts: the costs never
    go to the host."""
    costs = _step_costs()
    want, want_stats = auction_match(costs, num_iters=num_iters,
                                     with_stats=True)
    gpu_costs = costs.to(card)
    out = []
    sites = sync_sites(lambda: out.extend(auction_match(
        gpu_costs, num_iters=num_iters, with_stats=True)))
    got, stats = out
    assert sum(sites.values()) == stats.syncs == want_stats.syncs, sites
    assert got.is_cuda
    torch.testing.assert_close(got.cpu(), want, atol=0, rtol=0)
    assert int(stats.repaired) == int(want_stats.repaired)
    assert int(stats.iterations) == int(want_stats.iterations)
    if num_iters == 1:
        assert int(stats.repaired) > 0


@pytest.mark.parametrize("mode", ["bucketed", "slide"])
def test_eval_card_matches_cpu(cuda, mode):
    """Bucketed whole inference with ``valid_hw`` and slide inference of a
    tiny model on the card against the CPU at 1e-3."""
    cpu = randomize_(Spike2Former(
        T=1, num_classes=5, embed_dim=(8, 16, 24, 32), backbone_heads=4,
        feat_channels=16, num_queries=4, num_decoder_layers=1,
        num_encoder_layers=1, depths_stage3=1, depths_stage4=1,
        dcn_group=4), seed=2).eval()
    gpu = copy.deepcopy(cpu).to(cuda)
    imgs = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (2, 128, 96, 3), dtype=np.uint8))
    before = dcnv3.dcnv3_sample.launches
    if mode == "bucketed":
        valid = [(90, 60), (128, 50)]
        want = inference.whole_logits(cpu, imgs, valid_hw=valid)
        got = inference.whole_logits(gpu, imgs.to(cuda), valid_hw=valid)
    else:
        args = ((64, 64), (48, 48), 5)
        want = inference.slide_logits(cpu, imgs, *args)
        got = inference.slide_logits(gpu, imgs.to(cuda), *args)
    assert dcnv3.dcnv3_sample.launches > before
    torch.testing.assert_close(got.cpu(), want, atol=1e-3, rtol=1e-3)


# --- the train CLI ----------------------------------------------------------

def test_tiny_train_cli_card_matches_cpu(cuda, tmp_path):
    """The train CLI's loop at tiny dims, 4 steps at batch 2 of 64x64
    crops from a seeded tree of 4-class maps (TINY's 4 queries), on the
    card (through K1 and K2) and on the CPU: each logged ``total`` within
    ``chip_smoke.TRAIN_RTOL``; each run's last checkpoint holds its final
    state."""
    from chip_smoke import TRAIN_RTOL

    root = str(tmp_path / "ade")
    write_ade_tree(root, ((96, 128), (128, 96), (80, 80), (100, 90)),
                   seed=4, split="training", num_classes=4, classes=(2, 4))
    opts = TINY_OPTS + ["data.crop_size=(64,64)", "data.batch_size=2",
                        "data.num_workers=2", "train.warmup_iters=1",
                        "train.total_iters=4", "train.checkpoint_interval=2"]
    totals = []
    for dev in ("cpu", "cuda"):
        cfg = get_config(PRESET, list(opts))
        cfg.data.data_root = root
        before = dcnv3.dcnv3_sample_backward.launches
        # the tests' draw (the CLI's own start is flax's laws, whose
        # silent DCN branch and all-zero BN batches leave little to hold)
        drawn = randomize_(build_model(cfg.model), cfg.train.seed)
        res = train_cli.train(cfg, str(tmp_path / dev), log_interval=1,
                              eval_images=0, device=dev,
                              state_dict=drawn.state_dict())
        if dev == "cuda":
            assert dcnv3.dcnv3_sample_backward.launches == before + 4
        totals.append([r["total"] for r in res["logs"]])
        sd = checkpoint.restore_variables(str(tmp_path / dev / "ckpt_4"))
        for k, v in res["state"].model.state_dict().items():
            assert torch.equal(sd[k], v.cpu()), k
    cpu, card = totals
    assert len(cpu) == 4 and all(np.isfinite(cpu))
    np.testing.assert_allclose(card, cpu, rtol=TRAIN_RTOL)


def test_async_checkpoint_holds_the_state_at_its_step(cuda, tmp_path):
    """A save on the card returns before its file is written; the steps
    after it update the parameters and moments in place, and the file
    still holds the state at the save's step, bit for bit."""
    tr = _drawn_trainer(PRESET, TINY_OPTS + ["train.warmup_iters=1"],
                         device="cuda", seed=1)
    rng = np.random.default_rng(0)
    batches = [synthetic_batch(rng, 2, (64, 64), num_classes=4,
                               classes=(2, 4)) for _ in range(4)]
    api.train_steps(tr, batches[:2])
    want = {k: v.cpu().clone() for k, v in tr.state.model.state_dict().items()}
    mu = {k: v.cpu().clone()
          for k, v in tr.state.optimizer.state_dict()["mu"].items()}
    path = checkpoint.save_state(str(tmp_path), tr.state, 2)
    api.train_steps(tr, batches[2:])
    raw = torch.load(path, weights_only=True)
    assert raw["step"] == 2 and raw["optimizer"]["count"] == 2
    moved = 0
    for k, v in want.items():
        assert torch.equal(raw["model"][k], v), k
        moved += not torch.equal(tr.state.model.state_dict()[k].cpu(), v)
    for k, v in mu.items():
        assert torch.equal(raw["optimizer"]["mu"][k], v), k
    assert moved


# --- slice eight: the bf16 forms of K1 and K2, the bf16 model --------------

@pytest.mark.parametrize("cg", [1, 2, 4, 8, 16, 32])
def test_bf16_kernels_match_plain(cuda, cg):
    """K1 and K2 on bf16 features against their plain versions: out and
    dvalue within one bf16 ulp (``chip_smoke.within_one_bf16_ulp``),
    dpy/dpx/dmask within ``chip_smoke.BF16_GRAD_RTOL`` of the largest
    magnitude; the bf16 launch counts move."""
    from chip_smoke import BF16_GRAD_RTOL, within_one_bf16_ulp

    gen = torch.Generator().manual_seed(20 + cg)
    n, h, w, g, p, howo = 2, 9, 13, 4, 9, 60
    value = torch.randn((n, h, w, g * cg), generator=gen).bfloat16()
    py, px = _coords(gen, n, howo, g, p, h, w)
    mask = torch.rand((n, howo, g, p), generator=gen)
    dout = torch.randn((n, howo, g * cg), generator=gen).bfloat16()
    before = (dcnv3.dcnv3_sample.bf16_launches,
              dcnv3.dcnv3_sample_backward.bf16_launches)
    args = [t.to(cuda) for t in (value, py, px, mask)]
    out = dcnv3.dcnv3_sample(*args)
    grads = dcnv3.dcnv3_sample_backward(*args, dout.to(cuda))
    torch.cuda.synchronize()
    assert (dcnv3.dcnv3_sample.bf16_launches,
            dcnv3.dcnv3_sample_backward.bf16_launches) == (
                before[0] + 1, before[1] + 1)
    assert out.dtype == grads[0].dtype == torch.bfloat16
    assert within_one_bf16_ulp(out.cpu(), dcnv3.dcnv3_sample_reference(
        value, py, px, mask))
    want = dcnv3.dcnv3_sample_backward_reference(value, py, px, mask, dout)
    assert within_one_bf16_ulp(grads[0].cpu(), want[0])
    for gv, wv in zip(grads[1:], want[1:]):
        assert gv.dtype == torch.float32
        assert (gv.cpu() - wv).abs().max() <= BF16_GRAD_RTOL * wv.abs().max()


def test_bf16_tiny_model_card_matches_cpu(cuda):
    """The tiny model at bf16 on the card against the CPU at bf16, at
    ``chip_smoke``'s (bf16 tiny) tolerances: class agreement >= 0.99 and
    the largest logit gap <= 0.064 (the JAX package's own
    bf16-against-f32 gap on the tiny model)."""
    from chip_smoke import BF16_AGREEMENT, BF16_LOGIT_GAP

    cfg = get_config(PRESET, TINY_OPTS + ["model.dtype='bfloat16'"])

    cpu = randomize_(build_model(cfg.model), seed=1)
    gpu = copy.deepcopy(cpu).to(cuda)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (1, 64, 64, 3)).astype(np.float32))
    before = dcnv3.dcnv3_sample.bf16_launches
    with torch.inference_mode():
        want = cpu.predict_logits(x).float()
        got = gpu.predict_logits(x.to(cuda)).float().cpu()
    assert dcnv3.dcnv3_sample.bf16_launches == before + 1
    assert torch.isfinite(got).all()
    assert (got.argmax(-1) == want.argmax(-1)).float().mean() >= BF16_AGREEMENT
    assert (got - want).abs().max() <= BF16_LOGIT_GAP


# --- firing rates, TTA, point-sampled losses, the Cityscapes preset ---------

TINY_DIMS = dict(num_classes=5, embed_dim=(8, 16, 24, 32), backbone_heads=4,
                 feat_channels=16, num_queries=4, num_decoder_layers=1,
                 num_encoder_layers=1, depths_stage3=1, depths_stage4=1,
                 dcn_group=4)


def test_firing_rates_card_match_cpu(cuda):
    """Every site's rate and non-fire fraction, T=2 without the collapse
    and every decoder layer, card against CPU: the same keys within
    1e-6."""
    from spike2former_tpu_torch.utils.firing import firing_rates

    cpu = randomize_(Spike2Former(T=2, collapse_t=False,
                                  eval_last_only=False, **TINY_DIMS),
                     seed=2).eval()
    gpu = copy.deepcopy(cpu).to(cuda)
    x = torch.from_numpy(np.random.default_rng(2).normal(
        0, 1, (1, 64, 64, 3)).astype(np.float32))
    want = firing_rates(cpu, x)
    before = dcnv3.dcnv3_sample.launches
    got = firing_rates(gpu, x.to(cuda))
    assert dcnv3.dcnv3_sample.launches == before + 1
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, k


def test_tta_and_inferencer_card_match_cpu(cuda, tmp_path):
    from spike2former_tpu_torch.evaluation.tta import tta_logits

    cpu = randomize_(Spike2Former(T=1, **TINY_DIMS), seed=3).eval()
    gpu = copy.deepcopy(cpu).to(cuda)
    x = torch.from_numpy(np.random.default_rng(4).normal(
        0, 1, (1, 64, 48, 3)).astype(np.float32))
    with torch.inference_mode():
        want = tta_logits(cpu.predict_logits, x, (0.5, 1.0, 1.5))
        got = tta_logits(gpu.predict_logits, x.to(cuda), (0.5, 1.0, 1.5))
    torch.testing.assert_close(got.cpu(), want, atol=1e-3, rtol=1e-3)

    opts = TINY_OPTS + ["data.test_scale=(96,64)"]
    imgs = [np.random.default_rng(i).integers(0, 256, (50, 70, 3),
                                              dtype=np.uint8)
            for i in range(2)]
    outs = []
    for dev in ("cpu", "cuda"):
        inf = api.Inferencer(PRESET, overrides=opts, device=dev)
        randomize_(inf.im.model, 0)      # weights whose spikes fire
        outs.append(inf(imgs, out_dir=str(tmp_path / dev)))
    for a, b in zip(*(o["predictions"] for o in outs)):
        assert (a == b).mean() >= 0.99
    assert [p.split("/")[-1] for p in outs[1]["visualization"]] == [
        "img_0_pred.png", "img_1_pred.png"]


@pytest.mark.parametrize("shape", [(2, 3, 17, 23), (6, 32, 128, 128)])
def test_point_samplers_card_match_cpu(cuda, shape):
    from spike2former_tpu_torch.losses.point_sample import (
        point_sample, point_sample_shared, point_sample_slot,
        uncertain_point_coords)

    gen = torch.Generator().manual_seed(0)
    b, g, h, w = shape
    masks = torch.randn(shape, generator=gen) * 3
    coords = torch.rand((b, g, 300, 2), generator=gen)
    smap = torch.randint(0, g + 1, (b, 4 * h, 4 * w), generator=gen)
    for dt in (torch.float32, torch.bfloat16):
        torch.testing.assert_close(
            point_sample(masks.to(cuda), coords.to(cuda), dtype=dt).cpu(),
            point_sample(masks, coords, dtype=dt), atol=1e-6, rtol=0)
        torch.testing.assert_close(
            point_sample_slot(smap.to(cuda), g, coords.to(cuda),
                              dtype=dt).cpu(),
            point_sample_slot(smap, g, coords, dtype=dt), atol=1e-6, rtol=0)
    shared = coords[:, 0]
    torch.testing.assert_close(
        point_sample_shared(masks.to(cuda), shared.to(cuda)).cpu(),
        point_sample_shared(masks, shared), atol=1e-6, rtol=0)
    assert torch.equal(point_sample_slot(smap.to(cuda), g,
                                         shared.to(cuda)).cpu(),
                       point_sample_slot(smap, g, shared))
    draws = [torch.rand((b, g, 300, 2), generator=gen),
             torch.rand((b, g, 25, 2), generator=gen)]
    picks = []
    for dev in ("cpu", cuda):
        queue = [d.to(dev) for d in draws]
        picks.append(uncertain_point_coords(
            masks.to(dev), 100, 3.0, 0.75, draw=lambda s: queue.pop(0),
            dtype=torch.bfloat16).cpu())
    assert (picks[0] == picks[1]).all(-1).float().mean() >= 0.99


def test_point_train_step_card_matches_cpu(cuda):
    """The tiny model's step with ``train.loss_points``, card against CPU
    on the step's own points (JAX's keys: the same uniforms on both):
    ``total`` within 1e-3 relative (chip_smoke's tiny train tolerance), K1
    and K2 once each, the threefry kernel three times a layer."""
    from spike2former_tpu_torch.engine import train as ttrain

    opts = TINY_OPTS + ["train.loss_points=40", "train.matcher='host'"]
    images, sem = synthetic_batch(np.random.default_rng(0), 2, (64, 64),
                                  num_classes=4, classes=(2, 4))
    totals = []
    # the step's own points: JAX's, the plain threefry on the CPU and the
    # kernel on the card
    for dev in ("cpu", "cuda"):
        tr = _drawn_trainer(PRESET, opts, device=dev, seed=1)
        step = ttrain.make_train_step(
            5, max_gt=tr.cfg.train.max_gt, matcher="host", num_points=40)
        k1, k2, kt = (dcnv3.dcnv3_sample.launches,
                      dcnv3.dcnv3_sample_backward.launches,
                      jr.threefry_kernel.launches)
        _, m = step(tr.state, torch.as_tensor(images, device=dev),
                    torch.as_tensor(sem, device=dev))
        totals.append(float(m["total"]))
        if dev == "cuda":
            assert (dcnv3.dcnv3_sample.launches == k1 + 1
                    and dcnv3.dcnv3_sample_backward.launches == k2 + 1)
            # per layer a matching, an oversampled and a fresh draw
            assert (jr.threefry_kernel.launches - kt) % 3 == 0
            assert jr.threefry_kernel.launches > kt
    assert abs(totals[1] - totals[0]) <= 1e-3 * abs(totals[0])


def test_cityscapes_shapes_kernels_match_plain(cuda):
    """K1 and K2 at the Cityscapes preset's maps: a 512x1024 crop's /16
    map at batch 2 and a 1024x2048 image's at batch 1."""
    gen = torch.Generator().manual_seed(7)
    g, cg, p = 32, 8, 9
    for n, h, w in ((2, 32, 64), (1, 64, 128)):
        value = torch.randn((n, h, w, g * cg), generator=gen)
        py = torch.rand((n, h * w, g, p), generator=gen) * (h + 4) - 2
        px = torch.rand((n, h * w, g, p), generator=gen) * (w + 4) - 2
        mask = torch.rand((n, h * w, g, p), generator=gen)
        dout = torch.randn((n, h * w, g * cg), generator=gen)
        want = dcnv3.dcnv3_sample_reference(value, py, px, mask)
        got = dcnv3.dcnv3_sample(*(t.to(cuda) for t in (value, py, px,
                                                         mask)))
        torch.testing.assert_close(got.cpu(), want, atol=2e-5, rtol=0)
        wants = dcnv3.dcnv3_sample_backward_reference(value, py, px, mask,
                                                      dout)
        gots = dcnv3.dcnv3_sample_backward(
            *(t.to(cuda) for t in (value, py, px, mask, dout)))
        for a, b in zip(gots, wants):
            torch.testing.assert_close(a.cpu(), b, atol=3e-4, rtol=1e-3)


# --- the ServingEngine, K1's operator, export, the SDTv3 family ------------

def test_k1_operator_is_the_kernel_with_k2_as_its_gradient(cuda):
    """``torch.ops.spike2former.dcnv3_sample`` launches K1 (counted) and
    differentiates through K2, against autograd of the plain version."""
    gen = torch.Generator().manual_seed(7)
    n, h, w, g, cg, p = 3, 8, 12, 4, 8, 9
    value = torch.randn((n, h, w, g * cg), generator=gen).cuda()
    py = (torch.rand((n, h * w, g, p), generator=gen) * (h + 2) - 1).cuda()
    px = (torch.rand((n, h * w, g, p), generator=gen) * (w + 2) - 1).cuda()
    mask = torch.rand((n, h * w, g, p), generator=gen).cuda()
    dout = torch.randn((n, h * w, g * cg), generator=gen).cuda()
    leaves = [t.clone().requires_grad_(True) for t in (value, py, px, mask)]
    before = (dcnv3.dcnv3_sample.launches,
              dcnv3.dcnv3_sample_backward.launches)
    out = torch.ops.spike2former.dcnv3_sample(*leaves)
    got = torch.autograd.grad(out, leaves, dout)
    assert (dcnv3.dcnv3_sample.launches - before[0],
            dcnv3.dcnv3_sample_backward.launches - before[1]) == (1, 1)
    ref = [t.clone().requires_grad_(True) for t in (value, py, px, mask)]
    want_out = dcnv3.dcnv3_sample_reference(*ref)
    want = torch.autograd.grad(want_out, ref, dout)
    torch.testing.assert_close(out, want_out, atol=2e-5, rtol=0)
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, atol=3e-4, rtol=1e-3)


def test_export_holds_one_k1_call_per_dcn_layer(cuda, tmp_path):
    from spike2former_tpu_torch.tools import export

    im = _drawn_model(PRESET, overrides=TINY_OPTS + [
        "model.num_encoder_layers=2"])
    x = torch.randn((2, 64, 96, 3), device="cuda")
    program = export.export_model(im.model, x)
    assert export.sampler_calls(program) == 2
    torch.export.save(program, str(tmp_path / "m.pt2"))
    loaded = torch.export.load(str(tmp_path / "m.pt2")).module()
    with torch.no_grad():
        torch.testing.assert_close(loaded(x), im.model.predict_logits(x),
                                   atol=1e-6, rtol=0)


def test_serving_engine_on_the_card_matches_cpu(card):
    """The tiny model's engine on the card: K1 launches 6 a micro-batch
    (here 1 DCN layer: 1), class maps equal to the CPU engine's."""
    from spike2former_tpu_torch.serving import ServingEngine

    opts = TINY_OPTS + ["data.test_scale=(128,96)"]
    rng = np.random.default_rng(3)
    imgs = [rng.integers(0, 255, hw + (3,), dtype=np.uint8)
            for hw in ((96, 128), (60, 45), (150, 70)) * 3]
    maps = {}
    for dev in ("cpu", "cuda"):
        before = dcnv3.dcnv3_sample.launches
        with ServingEngine(PRESET, model=_drawn_model(
                PRESET, overrides=opts, device=dev), device=dev,
                max_batch=4, bucket=64, wait_ms=50.0) as eng:
            maps[dev] = [f.result(timeout=120)
                         for f in [eng.submit(i) for i in imgs]]
            st = eng.stats()
        launched = dcnv3.dcnv3_sample.launches - before
        assert launched == (sum(st["batch_sizes"].values())
                            if dev == "cuda" else 0)
    for a, b in zip(maps["cpu"], maps["cuda"]):
        assert (a == b).mean() >= 0.99


@pytest.mark.parametrize("variant", ["sdtv3", "sdtv3mae"])
def test_sdtv3_tiny_model_card_matches_cpu(cuda, variant):
    cpu = randomize_(Spike2Former(T=4, variant=variant, num_classes=5,
                                  embed_dim=(8, 16, 24, 32),
                                  backbone_heads=4, feat_channels=16,
                                  num_queries=4, num_decoder_layers=1,
                                  num_encoder_layers=1, depths_stage3=1,
                                  depths_stage4=1, dcn_group=4), seed=2)
    gpu = copy.deepcopy(cpu).cuda()
    x = torch.randn((1, 64, 96, 3), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = cpu.eval().predict_logits(x)
        got = gpu.eval().predict_logits(x.cuda()).cpu()
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-3)


# --- panoptic, Mask2Former and DAB-DETR ------------------------------------

def test_panoptic_merge_and_whole_panoptic_card_match_cpu(cuda):
    from spike2former_tpu_torch.data.synthetic import confident_merge_inputs
    from spike2former_tpu_torch.evaluation.tta import panoptic_inference

    cls, masks = (torch.from_numpy(a) for a in confident_merge_inputs())
    want = panoptic_inference(cls, masks, num_things=2)
    got = panoptic_inference(cls.to(cuda), masks.to(cuda), num_things=2)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert (want[0] >= 0).any() and (want[1] > 0).any()
    cpu = randomize_(Spike2Former(T=1, **dict(
        TINY_KW, num_classes=4)), seed=1).eval()
    gpu = copy.deepcopy(cpu).to(cuda)
    x = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (1, 96, 128, 3), dtype=np.uint8))
    k1 = dcnv3.dcnv3_sample.launches
    sem_w, inst_w = inference.whole_panoptic(cpu, x, num_things=2,
                                             object_mask_thr=0.3)
    sem_g, inst_g = inference.whole_panoptic(gpu, x.to(cuda), num_things=2,
                                             object_mask_thr=0.3)
    assert dcnv3.dcnv3_sample.launches == k1 + 1
    assert (sem_g.cpu() == sem_w).float().mean() >= 0.99
    assert (inst_g.cpu() == inst_w).float().mean() >= 0.99


TINY_KW = dict(num_classes=5, embed_dim=(8, 16, 24, 32), backbone_heads=4,
               feat_channels=16, num_queries=4, num_decoder_layers=1,
               num_encoder_layers=1, depths_stage3=1, depths_stage4=1,
               dcn_group=4)


@pytest.mark.parametrize("variant", ["panoptic", "m2f", "dab"])
def test_variant_train_step_card_matches_cpu(cuda, variant):
    """One tiny train step of the panoptic preset, the Mask2Former head
    and the DAB head on the card against the CPU (the host matcher):
    ``total`` within 1e-3 relative, K1 and K2 one launch each."""
    preset, extra = {
        "panoptic": ("SDTv2_maskformer_coco_panoptic",
                     ["model.num_things=2"]),
        "m2f": (PRESET, ["model.masked_attention=True",
                         "model.num_decoder_layers=2"]),
        "dab": (PRESET, ["model.decoder='dab'",
                         "model.num_decoder_layers=2"])}[variant]
    opts = TINY_OPTS + extra + ["train.matcher='host'",
                                "train.warmup_iters=1"]
    rng = np.random.default_rng(0)
    if variant == "panoptic":
        images = rng.uniform(0, 255, (2, 64, 64, 3)).astype(np.float32)
        masks = np.zeros((2, 6, 64, 64), np.uint8)
        for i in range(2):
            masks[i, 0] = 1
            masks[i, 1, 8:30, 10:40] = 1
            masks[i, 2, 40:60, 5:25] = 1
            masks[i, 0] -= masks[i, 1] | masks[i, 2]
        batch = (images, np.asarray([[3, 0, 1, 0, 0, 0]] * 2, np.int32),
                 masks, np.asarray([[1, 1, 1, 0, 0, 0]] * 2, bool))
    else:
        batch = synthetic_batch(rng, 2, (64, 64), num_classes=4,
                                classes=(2, 4))
    totals = []
    for dev in ("cpu", "cuda"):
        tr = _drawn_trainer(preset, opts, device=dev, seed=1)
        k1, k2 = (dcnv3.dcnv3_sample.launches,
                  dcnv3.dcnv3_sample_backward.launches)
        (m,) = api.train_steps(tr, [batch])
        totals.append(m["total"])
        if dev == "cuda":
            assert (dcnv3.dcnv3_sample.launches == k1 + 1
                    and dcnv3.dcnv3_sample_backward.launches == k2 + 1)
    assert np.isfinite(totals).all()
    assert abs(totals[1] - totals[0]) <= 1e-3 * abs(totals[0])


FPN_PRESETS = ("fpn_sdtv3_512x512_19M_ade20k", "fpn_msresnet18_512x512_ade20k",
               "fpn_msresnet104_512x512_ade20k",
               "cascade_fpn_sdtv2_512x512_ade20k")
TINY_FPN = ["model.num_classes=5", "model.embed_dim=(8,16,24,32)",
            "model.backbone_heads=4", "model.depths_stage3=1",
            "model.depths_stage4=1", "model.neck_channels=16",
            "model.head_channels=8", "model.T=2"]


@pytest.mark.parametrize("name", FPN_PRESETS)
def test_fpn_family_card_matches_cpu(cuda, name):
    """The FPN family at tiny widths: logits (1e-3, the LIF and multispike
    neurons on the card), and 2 train steps with the same dropout masks
    (a CPU generator's) within 1e-3 relative; no K1/K2 launch."""
    x = torch.from_numpy(np.random.default_rng(0).normal(
        0, 1, (2, 64, 64, 3)).astype(np.float32))
    logits = {}
    for dev in ("cpu", "cuda"):
        im = _drawn_model(name, overrides=TINY_FPN, device=dev, seed=2)
        with torch.inference_mode():
            logits[dev] = im.model.predict_logits(x.to(dev)).cpu()
    torch.testing.assert_close(logits["cuda"], logits["cpu"], rtol=0,
                               atol=1e-3)

    # the step's own dropout: JAX's masks, the plain threefry on the CPU
    # and the kernel on the card (bitwise the same)
    rng = np.random.default_rng(1)
    batches = [synthetic_batch(rng, 2, (64, 64), num_classes=5)
               for _ in range(2)]
    totals = {}
    k1 = dcnv3.dcnv3_sample.launches
    for dev in ("cpu", "cuda"):
        tr = _drawn_trainer(name, TINY_FPN + ["train.warmup_iters=1"],
                             device=dev, seed=2)
        totals[dev] = [m["total"] for m in api.train_steps(tr, batches)]
    np.testing.assert_allclose(totals["cuda"], totals["cpu"], rtol=1e-3)
    assert dcnv3.dcnv3_sample.launches == k1


def test_pixel_losses_card_match_cpu(cuda):
    """Each pixel loss and its logits gradient on the card against the
    CPU (1e-5 relative; the Lovász stable sort and the OHEM threshold on
    the card), and ``edt_sq`` equal."""
    from spike2former_tpu_torch.losses import pixel

    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.normal(0, 2, (2, 24, 20, 5)).astype(
        np.float32))
    sem = torch.from_numpy(rng.integers(0, 5, (2, 48, 40)))
    sem[0, :3] = 255
    for name, fn in pixel.PIXEL_LOSSES.items():
        out = {}
        for dev in ("cpu", "cuda"):
            lg = logits.to(dev, copy=True).requires_grad_(True)
            v = fn(lg, sem.to(dev))
            v.backward()
            out[dev] = (v.detach().cpu(), lg.grad.cpu())
        torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-5,
                                   atol=1e-6, msg=name)
        torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=1e-4,
                                   atol=1e-6, msg=name)
    mask = sem.clamp(max=4)
    torch.testing.assert_close(pixel.edt_sq(mask.cuda()).cpu(),
                               pixel.edt_sq(mask), rtol=0, atol=0)


def test_msda_and_deformable_encoder_card_match_cpu(cuda):
    """``ms_deform_attn`` (``F.grid_sample`` per level) and a 2-layer
    deformable encoder (seeded weights, the gammas drawn) on the card
    against the CPU on the same inputs."""
    from spike2former_tpu_torch.models.deformable import (
        SpikeDeformableEncoder)
    from spike2former_tpu_torch.ops.msda import ms_deform_attn

    gen = torch.Generator().manual_seed(5)
    shapes = ((8, 10), (4, 5))
    value = torch.randn((2, 100, 4, 8), generator=gen)
    locs = torch.rand((2, 6, 4, 2, 3, 2), generator=gen) * 1.2 - 0.1
    wgt = torch.rand((2, 6, 4, 2, 3), generator=gen)
    want = ms_deform_attn(value, shapes, locs, wgt)
    got = ms_deform_attn(value.to(cuda), shapes, locs.to(cuda),
                         wgt.to(cuda))
    torch.testing.assert_close(got.cpu(), want, atol=2e-5, rtol=1e-4)
    enc = randomize_(SpikeDeformableEncoder(2, 16, 4, 3, 32, num_levels=2),
                     0).eval()
    q = torch.randn((1, 2, 100, 16), generator=gen) + 0.5
    with torch.no_grad():
        want = enc(q, shapes)
        got = enc.to(cuda)(q.to(cuda), shapes)
    assert (got.cpu() - q).abs().max() > 0.1
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["random", "far", "zero", "integer"])
def test_k1_with_a_first_row_matches_plain_on_the_banded_map(cuda, dtype,
                                                             kind):
    """K1 on each half of the output rows of the Cityscapes /16 map
    (64x128, G=32, Cg=8: banded, as no group's map fits a block), the
    value map whole and the first row a kernel argument, as spatially
    sharded inference hands it: within 2e-5 of the plain version in f32,
    one bf16 ulp in bf16; the two halves together are the whole map's
    launch."""
    from chip_smoke import sampler_inputs, within_one_bf16_ulp

    n, h, w, g, cg, p = 1, 64, 128, 32, 8, 9
    gen = torch.Generator().manual_seed(7)
    value, py, px, mask = sampler_inputs(n, h, w, g, cg, p, kind, gen,
                                         device=cuda)
    value = value.to(getattr(torch, dtype))
    whole = dcnv3.dcnv3_sample(value, py, px, mask)
    half = h // 2
    for row0 in (0, half):
        sl = slice(row0 * w, (row0 + half) * w)
        args = [t[:, sl].contiguous() for t in (py, px, mask)]
        plan = dcnv3.tile_plan(n, h, w, half * w, g, cg, p, backward=False,
                               out_rows=half)
        assert 0 < plan.rows < h
        before = dcnv3.dcnv3_sample.launches
        got = dcnv3.dcnv3_sample(value, *args, rows=(row0, half))
        torch.cuda.synchronize()
        assert dcnv3.dcnv3_sample.launches == before + 1
        want = dcnv3.dcnv3_sample_reference(value, *args)
        if dtype == "float32":
            torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-5)
        else:
            assert within_one_bf16_ulp(got.cpu(), want.cpu())
        assert torch.equal(got, whole[:, sl])



@pytest.mark.parametrize("shape", [(), (7,), (3, 5, 2), (4, 6, 128, 128, 8)])
def test_threefry_kernel_is_the_plain_version_bitwise(card, shape):
    """``csrc/threefry.cu`` against the plain threefry: bits, uniforms
    (two ranges) and keep masks bitwise, and every block of the first
    and last axes equal to the slice of the whole draw."""
    k = jr.fold_in(jr.key(3), 11)
    before = jr.threefry_kernel.launches
    pairs = [(jr.bits(k, shape, device=card),
              jr.bits_reference(k, shape)),
             (jr.uniform(k, shape, device=card),
              jr.uniform_reference(k, shape)),
             (jr.uniform(k, shape, -0.3, 2.7, device=card),
              jr.uniform_reference(k, shape, -0.3, 2.7)),
             (jr.bernoulli(k, 0.9, shape, device=card),
              jr.bernoulli_reference(k, 0.9, shape))]
    torch.cuda.synchronize()
    assert jr.threefry_kernel.launches == before + 4
    for got, want in pairs:
        assert torch.equal(got.cpu(), want)
    for axis in ((0, -1) if shape else ()):
        n = shape[axis]
        whole = jr.uniform(k, shape, device=card)
        part = jr.uniform(k, shape, axis=axis, start=n // 3,
                          stop=n - n // 4, device=card)
        assert torch.equal(part, whole.narrow(axis % len(shape), n // 3,
                                              n - n // 4 - n // 3))


def test_init_weights_on_the_card_is_the_cpus(card):
    """The tiny flagship's ``init_weights_`` drawn on the card (uniforms
    through the kernel, the normals' ``erf_inv`` plain) is the CPU's bit
    for bit."""
    from spike2former_tpu_torch.engine.weights import init_weights_

    cfg = get_config(PRESET, TINY_OPTS).model
    cpu = init_weights_(build_model(cfg), 5).state_dict()
    before = jr.threefry_kernel.launches
    got = init_weights_(build_model(cfg).to(card), 5).state_dict()
    assert jr.threefry_kernel.launches > before
    for key, want in cpu.items():
        assert torch.equal(got[key].cpu(), want), key
