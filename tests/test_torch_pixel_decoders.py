"""The port's Transformer-encoder and FPN pixel decoders
(``models/pixel_decoder.py``) against the JAX package's on the CPU, at the
shapes of JAX's tests/test_head.py::test_transformer_encoder_pixel_decoder
(levels of 8, 16, 24 and 32 channels at 16, 8, 4 and 2 px, T=2, B=1;
feat and out 32, 4 heads, FFN 64) and one encoder layer more.

The same seeded weights are carried across by ``from_jax_variables`` and
loaded strictly; inputs are seeded activations around the q8 spike range.
Every output (mask features, memory, the three multi-scale maps) is held
within 1e-4 absolute in inference and 5e-4 in training mode (BN on the
batch's statistics, flax's one-pass variance against the port's
two-pass one), and the updated running statistics within 1e-5 relative.
JAX builds both decoders without a ``compat`` switch (their ``MSDAFFN`` at
its default, ``compat=False``), so there is one mode to hold;
``MSDAFFN``'s compat mode is held in ``test_torch_head.py``.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spike2former_tpu.models import pixel_decoder as jp
from spike2former_tpu_torch.engine.convert import from_jax_variables
from spike2former_tpu_torch.models import pixel_decoder as tp

from torch_port_helpers import load_port

ATOL, TRAIN_ATOL = 1e-4, 5e-4
IN_CHANNELS = (8, 16, 24, 32)
LEVELS = ((16, 8), (8, 16), (4, 24), (2, 32))       # (size, channels)


def _feats(seed, t=2, b=1, levels=LEVELS):
    rng = np.random.default_rng(seed)
    return [rng.normal(0.4, 0.8, (t, b, s, s, c)).astype(np.float32)
            for s, c in levels]


def _pair(kind, layers=1):
    if kind == "transformer":
        kw = dict(in_channels=IN_CHANNELS, feat_channels=32,
                  out_channels=32, num_encoder_layers=layers,
                  feedforward_channels=64)
        return (jp.TransformerEncoderPixelDecoder(**kw, num_heads=4),
                tp.TransformerEncoderPixelDecoder(**kw, num_heads=4))
    kw = dict(in_channels=IN_CHANNELS, feat_channels=32, out_channels=32)
    return jp.FPNPixelDecoder(**kw), tp.FPNPixelDecoder(**kw)


CASES = {"transformer": ("transformer", 1),
         "transformer_2_layers": ("transformer", 2),
         "fpn": ("fpn", 1)}


def _flat(out):
    mask, memory, outs = out
    return [mask, memory, *outs]


@pytest.mark.parametrize("case", sorted(CASES))
def test_pixel_decoder_matches_jax_in_inference(case):
    jm, pm = _pair(*CASES[case])
    feats = _feats(1)
    variables = load_port(jm, pm, feats, seed=2)
    want = jax.jit(jm.apply)(variables, [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        got = pm.eval()([torch.from_numpy(f) for f in feats])
    for name, g, w in zip(("mask_feature", "memory", "/16", "/8", "/4"),
                          _flat(got), _flat(want)):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, err_msg=name)
        assert np.ptp(w) > 0.1, name


@pytest.mark.parametrize("case", sorted(CASES))
def test_pixel_decoder_matches_jax_in_training(case):
    jm, pm = _pair(*CASES[case])
    feats = _feats(3)
    variables = load_port(jm, pm, feats, seed=4)
    want, upd = jax.jit(lambda v, f: jm.apply(v, f, True,
                                              mutable=["batch_stats"]))(
        variables, [jnp.asarray(f) for f in feats])
    got = pm.train()([torch.from_numpy(f) for f in feats])
    for name, g, w in zip(("mask_feature", "memory", "/16", "/8", "/4"),
                          _flat(got), _flat(want)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=TRAIN_ATOL, err_msg=name)
    sd = pm.state_dict()
    stats = from_jax_variables({"batch_stats": upd["batch_stats"]})
    assert stats
    for k, w in stats.items():
        np.testing.assert_allclose(sd[k].numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    _flat(got)[0].sum().backward()
    assert all(p.grad is not None for n, p in pm.named_parameters()
               if n.startswith(("mask_feature", "lateral_0")))


def test_shapes_as_in_jax_test_head():
    """JAX's tests/test_head.py:57-70 on the port (ones as input), and the
    FPN decoder's mask features 2 px larger each way (its padded 1x1
    head) with the /16 input as its memory."""
    feats = [torch.ones((2, 1, s, s, c)) for s, c in LEVELS]
    _, pm = _pair("transformer")
    mask, memory, outs = pm.eval()(feats)
    assert mask.shape == (2, 1, 16, 16, 32)
    assert memory.shape == (2, 1, 2, 2, 32)
    assert [o.shape[2] for o in outs] == [2, 4, 8]
    _, pm = _pair("fpn")
    mask, memory, outs = pm.eval()(feats)
    assert mask.shape == (2, 1, 18, 18, 32)
    assert memory is feats[-1]
    assert [o.shape[2] for o in outs] == [4, 8, 16]


@pytest.mark.parametrize("kind", ["transformer", "fpn"])
def test_full_width_decoders_load_jax_variables_strictly(kind):
    """At the flagship head's widths (feat 256, 8 heads, FFN 1024, the
    backbone's (32, 64, 128, 360) levels): JAX's variable tree
    (``jax.eval_shape``, no compute) maps onto the port's state_dict key
    for key."""
    chans = (32, 64, 128, 360)
    if kind == "transformer":
        jm = jp.TransformerEncoderPixelDecoder(chans, 256, 256, 6, 8, 1024)
        pm = tp.TransformerEncoderPixelDecoder(chans, 256, 256, 6, 8, 1024)
    else:
        jm = jp.FPNPixelDecoder(chans, 256, 256)
        pm = tp.FPNPixelDecoder(chans, 256, 256)
    feats = [jnp.zeros((1, 1, s, s, c)) for s, c in
             zip((16, 8, 4, 2), chans)]
    variables = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                               feats))
    sd = from_jax_variables(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), variables))
    assert set(sd) == set(pm.state_dict())
    pm.load_state_dict(sd, strict=True)
