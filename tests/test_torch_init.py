"""The port's initial weights (``engine/weights.py:init_weights_``) against
flax's ``model.init`` of the JAX package, leaf by leaf, for every
MaskFormer preset (``compat`` off and on) and the head's two other
decoders, and ``fast_init_`` against ``utils/initfast.py:fast_variables``
(``tests/torch_init_laws.py`` says how the leaves are pooled and held).

Tiny widths (``torch_port_helpers.TINY``), 64x64 inputs.  Presets whose
JAX module and port config are equal at these widths (the SDTv2 presets
differ in ``num_classes`` only, which TINY sets) are compared once and
the result is reused for the others (``check_preset``).
"""
import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

import pytest

from spike2former_tpu_torch.engine.config import (PRESETS, build_model,
                                                  get_config)

from torch_init_laws import check_preset
from torch_port_helpers import TINY

TINY_OPTS = [f"model.{k}={v!r}".replace(" ", "") for k, v in TINY.items()]
MASKFORMER = [p for p in PRESETS if "fpn" not in p]
FLAGSHIP = "SDTv2_maskformer_DCNpixelDecoder_ade20k"

@pytest.mark.parametrize("compat", [False, True])
@pytest.mark.parametrize("preset", MASKFORMER)
def test_initial_leaves_follow_flax_laws(preset, compat):
    counts = check_preset(preset, TINY_OPTS + [f"model.compat={compat}"])
    assert counts["random"] > 50 and counts["constant"] > 200


@pytest.mark.parametrize("option", ["model.decoder='dab'",
                                    "model.masked_attention=True"])
def test_head_variants_follow_flax_laws(option):
    """The DAB-DETR decoder (its anchors ``normal(1.0)``) and the
    Mask2Former mode, on the flagship."""
    counts = check_preset(FLAGSHIP, TINY_OPTS + [option,
                                                 "model.num_decoder_layers=2"])
    assert counts["random"] > 50


def test_the_laws_a_module_states():
    """The leaves whose law is not flax's default: each is drawn (or set)
    as its JAX module declares it."""
    from spike2former_tpu_torch.engine.weights import init_laws
    from spike2former_tpu_torch.models import initializers as init

    laws = init_laws(build_model(get_config(FLAGSHIP, TINY_OPTS).model))
    dcn = "head.pixel_decoder.encoder_0.dcn."
    assert laws[dcn + "offset_conv.weight"] == init.zeros
    assert laws[dcn + "mask_conv.weight"] == init.zeros
    assert laws[dcn + "offset_conv.bias"] == init.zeros
    assert laws["head.query_feat"] == init.normal(1.0)
    assert laws["head.level_embed"] == init.normal(1.0)
    assert laws["head.cls_embed.weight"] == init.truncated_normal(0.02)
    assert laws["head.mask_embed.Dense_2.weight"] == init.truncated_normal(
        0.02)
    assert laws["head.shortcut_kernel"] == init.uniform_fan_in(
        TINY["num_queries"])
    assert laws["head.pixel_decoder.encoder_0.gamma2"] == init.constant(1e-6)
    # a Dense kernel: lecun_normal over its fan_in
    assert laws["head.mask_embed.Dense_0.weight"] == init.lecun_normal(
        TINY["feat_channels"])


def test_fast_init_follows_fast_variables():
    counts = check_preset(FLAGSHIP, TINY_OPTS, fast=True)
    assert counts["random"] > 300
