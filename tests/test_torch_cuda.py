"""The port's CUDA kernel on the card, held against its plain version.

Marked ``cuda``: these tests skip without a GPU.  On a machine with one:
``python -m pytest tests/test_torch_cuda.py``.
"""
import copy

import numpy as np
import pytest
import torch

from spike2former_tpu_torch.engine.weights import randomize_
from spike2former_tpu_torch.models.segmentor import Spike2Former
from spike2former_tpu_torch.ops import dcnv3

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


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


def test_tiny_train_step_card_matches_cpu(cuda):
    """One tiny train step on the card (through K1 and K2) against the
    same step on the CPU: every loss at 1e-4 relative, grad_norm at 1e-3
    relative (the atomics and cuDNN sum in other orders)."""
    from spike2former_tpu_torch import api

    opts = ["model.num_classes=5", "model.embed_dim=(8,16,24,32)",
            "model.backbone_heads=4", "model.feat_channels=16",
            "model.num_queries=4", "model.num_decoder_layers=1",
            "model.num_encoder_layers=1", "model.depths_stage3=1",
            "model.depths_stage4=1", "model.dcn_group=4",
            "train.warmup_iters=1"]
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    blocks = rng.integers(0, 5, (2, 4, 4))
    sem = np.kron(blocks, np.ones((16, 16), np.int64))
    sem[:, :4] = 255
    out = []
    for dev in ("cpu", cuda):
        tr = api.init_trainer("SDTv2_maskformer_DCNpixelDecoder_ade20k",
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
