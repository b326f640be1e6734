"""The port's FPN family (``models/fpn.py``, ``msresnet.py``,
``cascade.py``, ``tebn.py`` and the six presets)
against the JAX package's on the CPU, at tiny dims, with the same seeded
weights (``torch_port_helpers.randomize_variables``, every BN scale drawn
non-zero: MS-ResNet's zero-init ones would silence each residual branch)
carried across by ``from_jax_variables`` and loaded strictly.

Tolerances: module outputs and logits within 1e-4 absolute (float32
convolutions summed in another order; the binary LIF spikes and the
multispike levels of these seeded inputs sit away from their thresholds,
so each spike is the same on both sides); BN running statistics within
1e-5 relative.  The train step and the CLIs: ``test_torch_fpn_train.py``.
"""
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spike2former_tpu.engine.config import build_model as jax_build_model
from spike2former_tpu.engine.config import get_config as jax_get_config
from spike2former_tpu.models import fpn as jfpn
from spike2former_tpu.models import msresnet as jmsr
from spike2former_tpu.models import tebn as jtebn
from spike2former_tpu_torch.engine.config import (PRESETS, build_model,
                                                  get_config)
from spike2former_tpu_torch.engine.convert import from_jax_variables
from spike2former_tpu_torch.engine.weights import randomize_
from spike2former_tpu_torch.models import fpn as tfpn
from spike2former_tpu_torch.models import msresnet as tmsr
from spike2former_tpu_torch.models import tebn as ttebn
from spike2former_tpu_torch.models.layers import BatchNorm

from torch_port_helpers import images, randomize_variables, run_both

ATOL = 1e-4
NEURON_KINDS = ("lif", "if", "eif", "plif", "multispike")
FPN_PRESETS = ("fpn_sdtv3_512x512_10M_ade20k", "fpn_sdtv3_512x512_19M_ade20k",
               "fpn_msresnet18_512x512_ade20k",
               "fpn_msresnet34_512x512_ade20k",
               "fpn_msresnet104_512x512_ade20k",
               "cascade_fpn_sdtv2_512x512_ade20k")
# tiny widths of the FPN family for the CPU
TINY_FPN = ["model.num_classes=5", "model.embed_dim=(8,16,24,32)",
            "model.backbone_heads=4", "model.depths_stage3=1",
            "model.depths_stage4=1", "model.neck_channels=16",
            "model.head_channels=8"]


def _feats(channels, hws, t=2, b=2, seed=0, scale=1.5):
    rng = np.random.default_rng(seed)
    return [(rng.normal(0.3, scale, (t, b, h, w, c))).astype(np.float32)
            for c, (h, w) in zip(channels, hws)]


def _close(got, want, atol=ATOL):
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=atol, rtol=0)


# --- neck, head, neurons, TEBN / TDBN ---------------------------------------

@pytest.mark.parametrize("neuron", NEURON_KINDS)
def test_neck_matches_jax(neuron):
    chans, hws = (4, 8, 12, 16), ((16, 12), (8, 6), (4, 3), (4, 3))
    feats = _feats(chans, hws)
    want, got = run_both(jfpn.FPNNeck(chans, 8, neuron),
                         tfpn.FPNNeck(chans, 8, neuron), feats, seed=1)
    _close(got, want)
    assert all(0 < float((g != 0).mean()) for g in got)


@pytest.mark.parametrize("strides", [(2, 4, 8, 16), (4, 8, 16, 32)])
@pytest.mark.parametrize("neuron", ("lif", "plif", "multispike"))
def test_head_matches_jax(neuron, strides):
    feats = _feats((8,) * 4, ((16, 12), (8, 6), (4, 3), (2, 2)), seed=2)
    want, got = run_both(
        jfpn.FPNHead(5, channels=6, feature_strides=strides, neuron=neuron),
        tfpn.FPNHead(5, 8, 6, strides, neuron), feats, seed=3)
    _close(got, want)
    assert got.shape == (2, 16, 12, 5)


def test_neuron_module_is_the_multistep_lif_or_a_spike_site():
    from spike2former_tpu_torch.models.layers import Spike

    assert isinstance(tfpn.Neuron("multispike").Spike_0, Spike)
    assert tfpn.Neuron("multispike").Spike_0.kind == "multispike_norm"
    assert [n for n, _ in tfpn.Neuron("plif").named_parameters()] == ["w"]
    assert not list(tfpn.Neuron("lif").parameters())


def _bn_train(jax_module, port_module, x, seed):
    """One training-mode call of both: output and the new statistics."""
    variables = jax.eval_shape(jax_module.init, jax.random.PRNGKey(0),
                               jnp.asarray(x))
    variables = randomize_variables(variables, seed)
    port_module.load_state_dict(from_jax_variables(variables), strict=True)
    y, upd = jax_module.apply(variables, jnp.asarray(x), True,
                              mutable=["batch_stats"])
    got = port_module.train()(torch.from_numpy(x))
    want_sd = from_jax_variables({"batch_stats": upd["batch_stats"]})
    return np.asarray(y), got.detach().numpy(), want_sd, port_module


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("kind", ["tebn", "tdbn"])
def test_tebn_and_tdbn_match_jax(kind, train):
    x = _feats((6,), ((5, 4),), t=3, seed=4)[0]
    jm = jtebn.TEBN(T=4) if kind == "tebn" else jtebn.TDBN(0.5, 2.0)
    pm = ttebn.TEBN(4, 6) if kind == "tebn" else ttebn.TDBN(6, 0.5, 2.0)
    if not train:
        want, got = run_both(jm, pm, x, seed=5)
        _close(got, want, 1e-5)
        return
    want, got, want_sd, pm = _bn_train(jm, pm, x, 5)
    _close(got, want, 1e-5)
    for k, w in want_sd.items():
        np.testing.assert_allclose(pm.state_dict()[k].numpy(), w.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


# --- MS-ResNet ---------------------------------------------------------------

@pytest.mark.parametrize("case", ["18_stride2", "18_stride1", "104_stride2",
                                  "104_wider"])
def test_msresnet_block_matches_jax(case):
    flavour, kind = case.split("_")
    stride = 2 if kind == "stride2" else 1
    cin = 6 if kind == "wider" else 8
    x = _feats((cin,), ((10, 8),), seed=6, scale=3.0)[0][0]
    want, got = run_both(
        jmsr.SnnBasicBlock(8, stride, flavour == "104"),
        tmsr.SnnBasicBlock(cin, 8, stride, flavour == "104"), x, seed=7)
    _close(got, want)


@pytest.mark.parametrize("variant", ["msresnet18", "msresnet34",
                                     "msresnet104"])
def test_msresnet_pyramid_and_classify_tail_match_jax(variant):
    x = images((64, 96), b=2, seed=8)
    jm = jmsr.MSResNet(variant, width=4, T=2, num_classes=7)
    pm = tmsr.MSResNet(variant, width=4, T=2, num_classes=7)
    variables = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x), False, True))
    variables = randomize_variables(variables, 9)
    pm.load_state_dict(from_jax_variables(variables), strict=True)
    pm.eval()
    for classify in (False, True):
        want = jax.jit(lambda v, x: jm.apply(v, x, False, classify))(
            variables, jnp.asarray(x))
        with torch.no_grad():
            got = pm(torch.from_numpy(x), classify)
        _close(jax.tree_util.tree_map(lambda t: t.numpy(), got),
               jax.tree_util.tree_map(np.asarray, want))
    assert [f.shape[2:4] for f in pm(torch.from_numpy(x))] == [
        (16, 24), (8, 12), (4, 6), (2, 3)]


def test_randomize_draws_the_zero_init_scales_non_zero():
    m = tmsr.MSResNet("msresnet18", width=4)
    assert float(m.stage0_block0.conv_bn_2.scale.abs().max()) == 0.0
    randomize_(m, 0)
    scales = [mod.scale for mod in m.modules() if isinstance(mod, BatchNorm)]
    assert len(scales) == 1 + 8 * 2 + 4
    assert all(float(s.abs().min()) > 0 for s in scales)


# --- whole models ------------------------------------------------------------

def _pair(name, opts=(), seed=0, hw=(64, 64)):
    """(jax model, variables, port model) of preset ``name`` at the tiny
    widths plus ``opts``."""
    opts = TINY_FPN + list(opts)
    jm = jax_build_model(jax_get_config(name, opts).model)
    variables = jax.eval_shape(
        lambda: jm.init({"params": jax.random.PRNGKey(0),
                         "dropout": jax.random.PRNGKey(0)},
                        jnp.zeros((1, *hw, 3)), True))
    variables = randomize_variables(variables, seed)
    pm = build_model(get_config(name, opts).model)
    pm.load_state_dict(from_jax_variables(variables), strict=True)
    return jm, variables, pm.eval()


def _predict(jm, variables, pm, x):
    want = jax.jit(lambda v, x: jm.apply(v, x, method=jm.predict_logits))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = pm.predict_logits(torch.from_numpy(x))
    return np.asarray(want), got.numpy()


PREDICT_CASES = {
    "sdtv2": ("fpn_sdtv3_512x512_10M_ade20k",
              ["model.variant='sdtv2'", "model.T=2"]),
    "sdtv3": ("fpn_sdtv3_512x512_10M_ade20k", ["model.T=2"]),
    "msresnet18": ("fpn_msresnet18_512x512_ade20k", []),
    "msresnet34": ("fpn_msresnet34_512x512_ade20k", ["model.T=2"]),
    "msresnet104": ("fpn_msresnet104_512x512_ade20k", []),
    **{f"sdtv2_{n}": ("fpn_sdtv3_512x512_10M_ade20k",
                      ["model.variant='sdtv2'", "model.T=2",
                       f"model.neuron='{n}'"]) for n in NEURON_KINDS},
    "cascade_3_stages": ("cascade_fpn_sdtv2_512x512_ade20k",
                         ["model.num_stages=3", "model.T=2"]),
}


@pytest.mark.parametrize("case", sorted(PREDICT_CASES))
def test_predict_logits_matches_jax(case):
    name, opts = PREDICT_CASES[case]
    jm, variables, pm = _pair(name, opts, seed=11)
    x = images((64, 48), b=2, seed=12)
    want, got = _predict(jm, variables, pm, x)
    assert got.shape == (2, 64, 48, 5)
    _close(got, want)
    assert np.ptp(want) > 0.1


def test_predict_logits_ignores_valid_hw_as_jax_does():
    jm, variables, pm = _pair("fpn_msresnet18_512x512_ade20k", seed=13)
    x = torch.from_numpy(images((64, 64), seed=14))
    with torch.no_grad():
        torch.testing.assert_close(
            pm.predict_logits(x, torch.tensor([[40, 50]])),
            pm.predict_logits(x), rtol=0, atol=0)


def test_cascade_stages_refine_the_previous_logits():
    jm, variables, pm = _pair("cascade_fpn_sdtv2_512x512_ade20k",
                              ["model.num_stages=3", "model.T=2"], seed=15)
    x = images((64, 64), seed=16)
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    assert len(got) == len(want) == 3
    _close([g.numpy() for g in got], [np.asarray(w) for w in want])
    assert float((got[2] - got[1]).abs().max()) > 0


# --- presets and config --------------------------------------------------------

@pytest.mark.parametrize("name", FPN_PRESETS)
def test_preset_equals_jax_and_loads_its_variables_strictly(name):
    """The preset's every field as JAX's sets it; the port builds it at
    full width, and JAX's variable tree of it (``jax.eval_shape``, no
    compute) loads with ``strict=True``."""
    got, want = get_config(name), jax_get_config(name)
    for section in ("model", "data", "train", "test"):
        g, w = getattr(got, section), getattr(want, section)
        for f in dataclasses.fields(g):
            assert getattr(g, f.name) == getattr(w, f.name), (section, f.name)
    jm = jax_build_model(want.model)
    variables = jax.eval_shape(
        lambda: jm.init({"params": jax.random.PRNGKey(0),
                         "dropout": jax.random.PRNGKey(0)},
                        jnp.zeros((1, 64, 64, 3)), True))
    sd = from_jax_variables(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), variables))
    pm = build_model(got.model)
    pm.load_state_dict(sd, strict=True)
    assert sum(p.numel() for p in pm.parameters()) == sum(
        int(np.prod(s.shape))
        for s in jax.tree_util.tree_leaves(variables["params"]))


def test_new_keys_override_as_in_jax():
    opts = ["model.kind='cascade'", "model.num_stages=3",
            "model.neck_channels=64", "model.head_channels=32",
            "model.neuron='eif'",
            "train.loss_decode=(('ce',1.0),('tversky',0.5,{'alpha':0.4}))"]
    got = get_config("SDTv2_maskformer_DCNpixelDecoder_ade20k", opts)
    want = jax_get_config("SDTv2_maskformer_DCNpixelDecoder_ade20k", opts)
    for key in ("kind", "num_stages", "neck_channels", "head_channels",
                "neuron"):
        assert getattr(got.model, key) == getattr(want.model, key)
    assert got.train.loss_decode == want.train.loss_decode
    assert set(FPN_PRESETS) < set(PRESETS)
    with pytest.raises(AttributeError, match="unknown config key"):
        get_config(FPN_PRESETS[0], ["model.neurons='lif'"])
