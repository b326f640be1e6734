"""The port's initial weights (``engine/weights.py:init_weights_``) against
flax's ``model.init`` of the JAX package, leaf by leaf, for the FPN
family's presets (``compat`` off and on), the parametric LIF, and the
library modules no preset builds; ``fast_init_`` against
``fast_variables`` on MS-ResNet-18 (the zero-scale BN) and the PLIF
model (a leaf without an axis).  ``tests/torch_init_laws.py`` says how
the leaves are pooled and held; equal models are compared once, as in
``tests/test_torch_init.py``.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

import jax.numpy as jnp
import numpy as np
import pytest

from spike2former_tpu.models import attention as jatt
from spike2former_tpu.models import cyclemlp as jcyc
from spike2former_tpu.models import deformable as jdef
from spike2former_tpu.models import pixel_decoder as jpd
from spike2former_tpu.models import spikeformer_lib as jlib
from spike2former_tpu.models import tebn as jtebn
from spike2former_tpu.ops import rnn as jrnn
from spike2former_tpu_torch.engine.config import PRESETS
from spike2former_tpu_torch.models import attention as tatt
from spike2former_tpu_torch.models import cyclemlp as tcyc
from spike2former_tpu_torch.models import deformable as tdef
from spike2former_tpu_torch.models import pixel_decoder as tpd
from spike2former_tpu_torch.models import spikeformer_lib as tlib
from spike2former_tpu_torch.models import tebn as ttebn
from spike2former_tpu_torch.ops import rnn as trnn

from test_torch_fpn import TINY_FPN
from torch_init_laws import check_preset, compare_init

FPN_PRESETS = [p for p in PRESETS if "fpn" in p]
C = 16


def _x(*shape):
    return jnp.asarray(np.random.default_rng(0).normal(0.5, 1.0, shape),
                       jnp.float32)


@pytest.mark.parametrize("compat", [False, True])
@pytest.mark.parametrize("preset", FPN_PRESETS)
def test_initial_leaves_follow_flax_laws(preset, compat):
    counts = check_preset(preset, TINY_FPN + [f"model.compat={compat}"])
    assert counts["random"] > 30 and counts["constant"] > 100


def test_plif_neurons_follow_flax_laws():
    """PLIF's ``w``: flax's ``constant(0.0)``, a leaf without an axis."""
    counts = check_preset("fpn_sdtv3_512x512_10M_ade20k",
                          TINY_FPN + ["model.neuron='plif'"])
    assert counts["random"] > 30


# (JAX module, port module, init args) of the library modules
LIBRARY = {
    "deformable_encoder": lambda: (
        jdef.SpikeDeformableEncoder(num_layers=2, embed_dims=C, num_heads=4,
                                    num_points=3, feedforward_channels=32),
        tdef.SpikeDeformableEncoder(num_layers=2, embed_dims=C, num_heads=4,
                                    num_points=3, feedforward_channels=32,
                                    num_levels=2),
        (_x(1, 2, 80, C), ((8, 8), (4, 4)), _x(1, 2, 80, C))),
    "transformer_pixel_decoder": lambda: (
        jpd.TransformerEncoderPixelDecoder(
            in_channels=(8, 16, 24, 32), feat_channels=32, out_channels=32,
            num_encoder_layers=1, feedforward_channels=64, num_heads=4),
        tpd.TransformerEncoderPixelDecoder(
            in_channels=(8, 16, 24, 32), feat_channels=32, out_channels=32,
            num_encoder_layers=1, feedforward_channels=64, num_heads=4),
        ([_x(2, 1, s, s, c) for s, c in ((16, 8), (8, 16), (4, 24),
                                         (2, 32))],)),
    "fpn_pixel_decoder": lambda: (
        jpd.FPNPixelDecoder(in_channels=(8, 16, 24, 32), feat_channels=32,
                            out_channels=32),
        tpd.FPNPixelDecoder(in_channels=(8, 16, 24, 32), feat_channels=32,
                            out_channels=32),
        ([_x(2, 1, s, s, c) for s, c in ((16, 8), (8, 16), (4, 24),
                                         (2, 32))],)),
    "spikeformer_decoder_layer": lambda: (
        jlib.SpikeformerDecoderLayer(32, 4, 64),
        tlib.SpikeformerDecoderLayer(32, 4, 64),
        (_x(1, 2, 8, 32), _x(1, 2, 16, 32))),
    "base_transformer_decoder_layer": lambda: (
        jlib.BaseTransformerDecoderLayer(32, 4, 64),
        tlib.BaseTransformerDecoderLayer(32, 4, 64),
        (_x(1, 2, 8, 32), _x(1, 2, 16, 32))),
    "query_proposal": lambda: (
        jlib.QueryProposal(num_queries=12, num_classes=3),
        tlib.QueryProposal(C, num_queries=12, num_classes=3),
        (_x(2, 8, 8, C), _x(1, 8, 8, C))),
    "cycle_block": lambda: (jcyc.CycleBlock(C), tcyc.CycleBlock(C),
                            (_x(2, 5, 6, C),)),
    "linear_ca": lambda: (
        jatt.LinearSpikeMHA(C, 4, mode="CA"),
        tatt.LinearSpikeMHA(C, 4, mode="CA"),
        (_x(1, 2, 5, C), _x(1, 2, 3, 4, C), _x(1, 2, 3, 4, C))),
    "pem_cross_attention": lambda: (
        jatt.PEMCrossAttention(C, 4), tatt.PEMCrossAttention(C, 4),
        (_x(2, 6, C), _x(2, 4, 5, C))),
    "lstm": lambda: (jrnn.SpikingLSTM(4), trnn.SpikingLSTM(6, 4),
                     (_x(5, 2, 6),)),
    "gru": lambda: (jrnn.SpikingGRU(4), trnn.SpikingGRU(6, 4),
                    (_x(5, 2, 6),)),
    "vanilla_rnn": lambda: (jrnn.SpikingVanillaRNN(4),
                            trnn.SpikingVanillaRNN(6, 4), (_x(5, 2, 6),)),
    "tebn": lambda: (jtebn.TEBN(T=4), ttebn.TEBN(4, 6),
                     (_x(3, 2, 5, 4, 6),)),
    "tdbn": lambda: (jtebn.TDBN(0.5, 2.0), ttebn.TDBN(6, 0.5, 2.0),
                     (_x(3, 2, 5, 4, 6),)),
}


@pytest.mark.parametrize("name", sorted(LIBRARY))
def test_library_modules_follow_flax_laws(name):
    jm, pm, args = LIBRARY[name]()
    counts = compare_init(jm, pm, *args)
    assert counts["constant"] + counts["random"] > 0


@pytest.mark.parametrize("preset,opts", [
    ("fpn_msresnet18_512x512_ade20k", []),
    ("fpn_sdtv3_512x512_10M_ade20k", ["model.neuron='plif'"])])
def test_fast_init_follows_fast_variables(preset, opts):
    counts = check_preset(preset, TINY_FPN + opts, fast=True)
    assert counts["random"] > 30 and counts["constant"] > 0
