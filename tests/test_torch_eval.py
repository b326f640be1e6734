"""The port's eval path against the JAX package: ``bucket_hw`` and
``test_pipeline``; bucketed whole-image inference with ``valid_hw`` (the
mask-aware sine PE and the key-padding mask of the cross-attention) and
sliding-window inference, at tiny dims in both compat modes.

Logits compare at atol/rtol 1e-3, the whole-model tolerance of
tests/test_torch_model.py (tight end-to-end parity is well posed up to
128^2).  Integer outputs and the transforms compare exactly.
"""
import sys
import os

sys.path.insert(0, os.path.dirname(__file__))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spike2former_tpu.data import transforms as jtransforms
from spike2former_tpu.engine import inference as jinf
from spike2former_tpu.models.positional import (
    sine_positional_encoding as jax_sine_pe)
from spike2former_tpu_torch.data import transforms
from spike2former_tpu_torch.engine import inference as tinf
from spike2former_tpu_torch.engine.convert import from_jax_variables
from spike2former_tpu_torch.models.positional import (
    sine_pe_for_shape, sine_positional_encoding)
from spike2former_tpu_torch.models.transformer_decoder import (
    DetrDecoderLayer)

from torch_port_helpers import TINY, make_pair

TOL = 1e-3


def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


@pytest.mark.parametrize("hw,multiple", [((40, 48), 64), ((65, 128), 64),
                                         ((512, 683), 128), ((1, 1), 32),
                                         ((128, 128), 128)])
def test_bucket_hw_matches_jax(hw, multiple):
    assert tinf.bucket_hw(*hw, multiple) == jinf.bucket_hw(*hw, multiple)


@pytest.mark.parametrize("kw", [dict(bucket=128), dict(bucket=0),
                                dict(size_divisor=None),
                                dict(size_divisor=64),
                                dict(bucket=64, scale=(128, 96))])
@pytest.mark.parametrize("shape", [(75, 130), (683, 512), (97, 97)])
def test_test_pipeline_matches_jax(shape, kw):
    img = _u8((*shape, 3), 0)
    seg = np.random.default_rng(1).integers(0, 150, shape).astype(np.int32)
    want = jtransforms.test_pipeline(
        {"image": img, "sem_seg": seg, "meta": {}}, **kw)
    got = transforms.test_pipeline(
        {"image": img, "sem_seg": seg, "meta": {}}, **kw)
    np.testing.assert_array_equal(got["image"], want["image"])
    np.testing.assert_array_equal(got["sem_seg"], want["sem_seg"])
    assert got["meta"] == want["meta"]


@pytest.mark.parametrize("shape,valid", [((2, 8, 12), [(5, 7), (8, 12)]),
                                         ((1, 4, 4), [(1, 3)])])
def test_mask_aware_sine_pe_matches_jax(shape, valid):
    """The PE of a padded map normalises its cumsums over the valid
    region: equal to JAX's, and inside the valid region equal to the PE of
    a map of the valid size."""
    b, h, w = shape
    pad = np.ones(shape, bool)
    for i, (vh, vw) in enumerate(valid):
        pad[i, :vh, :vw] = False
    want = np.asarray(jax_sine_pe(jnp.asarray(pad, jnp.float32), 8))
    got = sine_positional_encoding(torch.from_numpy(pad), 8).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    for i, (vh, vw) in enumerate(valid):
        np.testing.assert_allclose(got[i, :vh, :vw],
                                   sine_pe_for_shape(vh, vw, 8).numpy(),
                                   atol=1e-6, rtol=1e-6)


def test_cross_attention_ignores_masked_keys():
    """Keys and values at masked positions change nothing (masked scores
    are zeroed, the dense form is taken); unmasked, they change the
    output.  The layer holds 1200 keys, over the factored form's 1024."""
    torch.manual_seed(0)
    layer = DetrDecoderLayer(16, 4, 32).eval()
    with torch.no_grad():
        for p in layer.parameters():
            p.normal_(0.5, 0.5)
    t, b, nq, nk, c = 1, 2, 5, 1200, 16
    q, qpos = torch.randn(t, b, nq, c), torch.randn(b, nq, c)
    kv, kpos = torch.randn(t, b, nk, c), torch.randn(b, nk, c)
    mask = torch.zeros(b, 1, 1, nk, dtype=torch.bool)
    mask[0, ..., 700:] = True
    mask[1, ..., 100:] = True
    kv2 = torch.where(mask[:, 0, 0, :, None], 5 * torch.randn_like(kv), kv)
    with torch.no_grad():
        out = layer(q, kv, kv, qpos, kpos, cross_attn_mask=mask)
        out2 = layer(q, kv2, kv2, qpos, kpos, cross_attn_mask=mask)
        free = layer(q, kv2, kv2, qpos, kpos)
    torch.testing.assert_close(out2, out, atol=0, rtol=0)
    assert not torch.allclose(free, out)


def _live_attention_pair(compat, seed=1, gain=16.0):
    """``make_pair`` with the decoder's cross-attention carrying signal.  At
    the tiny dims' random weights its q/k/v spikes reach at most 1/8, so
    its output spike is 0 whatever the keys are, and a key mask would
    change nothing; the q/k/v BN scales are raised ``gain``-fold on both
    sides."""
    jm, variables, pm = make_pair(TINY, compat=compat, seed=seed)

    def boost(path, x):
        names = [str(getattr(k, "key", k)) for k in path]
        if ("cross_attn" in names and names[-1] == "scale"
                and {"q", "k", "v"} & set(names)):
            return x * gain
        return x

    variables = jax.tree_util.tree_map_with_path(boost, variables)
    pm.load_state_dict(from_jax_variables(variables), strict=True)
    return jm, variables, pm


@pytest.mark.parametrize("compat", [False, True])
@pytest.mark.parametrize("bucket,valid", [((64, 64), [(30, 40), (64, 20)]),
                                          ((128, 96), [(90, 60),
                                                       (128, 50)])])
def test_bucketed_whole_logits_match_jax(compat, bucket, valid):
    """Images padded bottom-right to a bucket shape, with their valid
    extents: the logits against JAX's ``whole_logits(valid_hw=...)``, and
    the masking is load-bearing (the logits without ``valid_hw``
    differ).  Each image leaves at least one token of the /32 level, the
    one the tiny model's decoder layer attends, in the padding."""
    jm, variables, pm = _live_attention_pair(compat)
    imgs = _u8((len(valid), *bucket, 3), 2)
    for i, (vh, vw) in enumerate(valid):
        imgs[i, vh:] = 0
        imgs[i, :, vw:] = 0
    want = np.asarray(jinf.whole_logits(jm, variables, jnp.asarray(imgs),
                                        valid_hw=valid))
    got = tinf.whole_logits(pm, torch.from_numpy(imgs), valid_hw=valid)
    assert got.shape == (len(valid), *bucket, TINY["num_classes"])
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    unmasked = tinf.whole_logits(pm, torch.from_numpy(imgs)).numpy()
    assert np.abs(unmasked - got.numpy()).max() > 10 * TOL


@pytest.mark.parametrize("compat", [False, True])
def test_padded_tokens_are_masked_in_the_decoder(compat):
    """Whatever the pixel decoder hands the transformer decoder at padded
    tokens, the class scores and the valid region's mask logits do not
    move: the features of every padded token of the three decoder levels
    are replaced by noise (the backbone's global attention and the convs'
    halo, which do see padded pixels, act before this point)."""
    _, _, pm = _live_attention_pair(compat)
    vh, vw = 80, 56
    x = torch.from_numpy(np.random.default_rng(3).normal(
        0, 1, (1, 128, 96, 3)).astype(np.float32))
    valid = torch.tensor([[vh, vw]])

    def noisy(module, args, out):
        mask_features, memory, levels = out
        noisy_levels = []
        for lvl in levels:
            h, w = lvl.shape[2:4]
            s = 128 // h
            pad = torch.ones(h, w, dtype=torch.bool)
            pad[:-(-vh // s), :-(-vw // s)] = False
            noisy_levels.append(torch.where(
                pad[None, None, :, :, None],
                10 * torch.randn_like(lvl), lvl))
        return mask_features, memory, noisy_levels

    with torch.no_grad():
        cls, masks = pm(x, valid)
        handle = pm.head.pixel_decoder.register_forward_hook(noisy)
        try:
            cls2, masks2 = pm(x, valid)
            cls_free, _ = pm(x)
        finally:
            handle.remove()
    torch.testing.assert_close(cls2, cls, atol=0, rtol=0)
    torch.testing.assert_close(masks2[..., :vh // 2, :vw // 2],
                               masks[..., :vh // 2, :vw // 2], atol=0, rtol=0)
    assert not torch.allclose(cls_free, cls)


# compat=True (~60 s of JAX compiles) runs with --runslow: the windows are
# the same, and the bucketed whole test holds the compat model's logits
@pytest.mark.parametrize("compat", [
    False, pytest.param(True, marks=pytest.mark.slow)])
@pytest.mark.parametrize("hw,crop,stride", [((48, 48), (32, 32), (16, 16)),
                                            ((48, 48), (32, 32), (32, 32)),
                                            ((32, 32), (32, 32), (32, 32)),
                                            ((40, 72), (32, 32), (16, 16))])
def test_slide_logits_match_jax(compat, hw, crop, stride):
    """Window origins clamped to the image's edge, the windows batched,
    overlap averaging: JAX's ``slide_logits`` on the same weights, with
    the windows in one chunk and in chunks of 3."""
    jm, variables, pm = make_pair(TINY, compat=compat, seed=4)
    imgs = _u8((2, *hw, 3), 5)
    k = TINY["num_classes"]
    want = np.asarray(jinf.slide_logits(jm, variables, jnp.asarray(imgs),
                                        crop, stride, k))
    for wb in (None, 3):
        got = tinf.slide_logits(pm, torch.from_numpy(imgs), crop, stride, k,
                                window_batch=wb)
        assert got.shape == (2, *hw, k) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    if hw == crop:
        np.testing.assert_allclose(
            tinf.whole_logits(pm, torch.from_numpy(imgs)).numpy(), want,
            atol=TOL, rtol=TOL)


def test_slide_origins_cover_the_image_and_touch_its_edge():
    origins = tinf.slide_origins(683, 512, (512, 512), (341, 341))
    assert origins == [(0, 0), (171, 0)]
    assert tinf.slide_origins(48, 48, (32, 32), (16, 16)) == [
        (0, 0), (0, 16), (16, 0), (16, 16)]
