"""The port's SDTv3 (E-SpikeFormer) and SDTv3-MAE backbones and models
against the JAX package on the same seeded weights and inputs.

Tolerances: the spike functions and their gradients exactly (the same
float ops), exact half-integers included; blocks 1e-5 (f32 in another
summation order); pyramids 1e-4 and full-model logits 1e-3, as for
SDTv2 (tests/test_torch_backbone.py, test_torch_model.py); the train
step at tests/test_torch_train.py's tolerances; the golden reference
state dicts through ``convert_reference`` at 1e-3, as
tests/test_convert_sdtv3.py holds JAX; bf16 at
tests/test_torch_bf16_model.py's (class agreement >= 0.99, gap <= 0.064)
against JAX compiled under ``EXACT_BF16``; ``collapse_t``, ``remat`` and
packed residuals change no number.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spike2former_tpu.models import sdtv2 as js
from spike2former_tpu.models import layers as jl
from spike2former_tpu.ops import spike as jspike
from spike2former_tpu_torch import api
from spike2former_tpu_torch.data.synthetic import synthetic_batch
from spike2former_tpu_torch.engine import convert_reference as cref
from spike2former_tpu_torch.engine.config import (PRESETS, build_model,
                                                  get_config)
from spike2former_tpu_torch.engine.convert import from_jax_variables
from spike2former_tpu_torch.models import layers as tl
from spike2former_tpu_torch.models import sdtv2 as ts
from spike2former_tpu_torch.models.layers import Spike
from spike2former_tpu_torch.models.segmentor import Spike2Former
from spike2former_tpu_torch.ops import spike as tspike
from spike2former_tpu_torch.utils.firing import firing_rates

from torch_port_helpers import (EXACT_BF16, TINY, images, jit_exact,
                                make_pair, run_both, spikes)

VARIANTS = ("sdtv3", "sdtv3mae")
V3_PRESETS = ("SDTv3_b_Spike2former_ade20k_512x512",
              "SDTv3_b_Spike2former_voc_512x512",
              "SDTv3_b_Spike2former_Cityscapes_512x1024",
              "SDTv3MAE_Spike2former_ade20k_512x512")


# --- the spike functions ----------------------------------------------------

SPIKES = {"multispike_norm": (jspike.multispike_norm, tspike.multispike_norm),
          "multispike4": (jspike.multispike4, tspike.multispike4),
          "multispike8": (jspike.multispike8, tspike.multispike8),
          "qspike": (jspike.qspike, tspike.qspike)}


def _spike_inputs():
    """Exact half-integers (where half-to-even and half-up part), the
    interval ends, values beyond them and seeded randoms."""
    halves = np.arange(-1.5, 9.0, 0.5)
    ends = np.array([0.0, 4.0, 8.0, -0.0, 1e-7, 3.9999998, 7.9999995,
                     8.000001, 4.000001, -1e-7])
    rand = np.random.default_rng(0).uniform(-2, 10, 200)
    return np.concatenate([halves, ends, rand]).astype(np.float32)


@pytest.mark.parametrize("name", sorted(SPIKES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spike_function_and_gradient_match_jax(name, dtype):
    jfn, tfn = SPIKES[name]
    x = _spike_inputs()
    g = np.random.default_rng(1).normal(0, 1, x.shape).astype(np.float32)
    xj = jnp.asarray(x, getattr(jnp, dtype))
    gj = jnp.asarray(g, getattr(jnp, dtype))
    want, vjp = jax.vjp(jfn, xj)
    (want_g,) = vjp(gj)
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True)
    got = tfn(xt)
    got.backward(torch.from_numpy(g).to(getattr(torch, dtype)))
    assert got.dtype == xt.dtype
    np.testing.assert_array_equal(got.detach().float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    np.testing.assert_array_equal(xt.grad.float().numpy(),
                                  np.asarray(want_g.astype(jnp.float32)))


def test_multispike8_rounds_half_up_and_gates_the_open_interval():
    x = torch.tensor([0.5, 1.5, 2.5, 0.0, 8.0, 7.5, 3.5], requires_grad=True)
    y = tspike.multispike8(x)
    assert (y * 8).tolist() == [1, 2, 3, 0, 8, 8, 4]
    y.sum().backward()
    assert x.grad.tolist() == [1, 1, 1, 0, 0, 1, 1]
    x = torch.tensor([0.5, 1.5, 2.5, 0.0, 4.0], requires_grad=True)
    y = tspike.multispike_norm(x)
    assert (y * 4).tolist() == [0, 2, 2, 0, 4]      # half to even
    y.sum().backward()
    assert x.grad.tolist() == [0.25] * 5           # closed interval


# --- blocks -----------------------------------------------------------------

def _x5(c, seed=0, t=1, h=4, w=6):
    return spikes((t, 2, h, w, c), seed) * 4.0 - 1.0


BLOCKS = {
    "SpikeAttention_conv1x1": (
        lambda: js.SpikeAttention(16, 4, qkv_proj="conv1x1", lamda_ratio=4,
                                  scale_mult=2.0, spike="multispike_norm"),
        lambda: ts.SpikeAttention(16, 4, qkv_proj="conv1x1", lamda_ratio=4,
                                  scale_mult=2.0, spike="multispike_norm"),
        _x5(16, t=2)),
    "CSWinSpikeAttention": (
        lambda: js.CSWinSpikeAttention(16, 4),
        lambda: ts.CSWinSpikeAttention(16, 4), _x5(16, t=2)),
    "CSWinSpikeAttention_last": (
        lambda: js.CSWinSpikeAttention(16, 4, last_stage=True),
        lambda: ts.CSWinSpikeAttention(16, 4, last_stage=True), _x5(16)),
    "MSBlock_v3": (
        lambda: js.MSBlock(16, 4, with_sepconv=True, qkv_proj="conv1x1",
                           lamda_ratio=4, scale_mult=2.0,
                           spike="multispike_norm"),
        lambda: ts.MSBlock(16, 4, with_sepconv=True, qkv_proj="conv1x1",
                           lamda_ratio=4, scale_mult=2.0,
                           spike="multispike_norm"), _x5(16)),
    "MSBlockCSWin": (lambda: js.MSBlockCSWin(16, 4),
                     lambda: ts.MSBlockCSWin(16, 4), _x5(16)),
    "MSConvBlock_v3": (
        lambda: jl.MSConvBlock(8, sepconv_dw_bn=True, sepconv_num_spikes=3,
                               spike="multispike8"),
        lambda: tl.MSConvBlock(8, sepconv_dw_bn=True, sepconv_num_spikes=3,
                               spike="multispike8"), _x5(8, t=2)),
    "DownSampling_ms4": (
        lambda: jl.DownSampling(12, spike="multispike_norm"),
        lambda: tl.DownSampling(8, 12, spike="multispike_norm"), _x5(8)),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_matches_jax(name):
    make_j, make_t, x = BLOCKS[name]
    want, got = run_both(make_j(), make_t(), x, seed=1)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_cswin_refuses_a_map_that_does_not_split():
    with pytest.raises(ValueError, match="stripes"):
        ts.CSWinSpikeAttention(16, 4)(torch.zeros(1, 1, 4, 5, 16))


# --- pyramids and models ----------------------------------------------------

BACKBONE = dict(embed_dim=TINY["embed_dim"], num_heads=4, depths_stage3=2,
                depths_stage4=1)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("hw", [(64, 64), (64, 96)])
def test_pyramid_matches_jax(variant, hw):
    want, got = run_both(
        js.SpikingMetaFormer(T=2, variant=variant, **BACKBONE),
        ts.SpikingMetaFormer(T=2, variant=variant, **BACKBONE),
        images(hw, b=2), seed=2)
    assert len(got) == 4
    if variant == "sdtv3mae":     # averaged over T, kept as T=1, /16 last
        assert got[3].shape[0] == 1 and got[3].shape[-1] == 24
    for lvl, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4,
                                   err_msg=f"level {lvl}")


def _logits_jax(jm, variables, x):
    return np.asarray(jax.jit(lambda v, a: jm.apply(
        v, a, method=type(jm).predict_logits))(variables, jnp.asarray(x)))


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("compat", [False, True])
def test_model_logits_match_jax(variant, compat):
    jm, variables, pm = make_pair(dict(TINY, variant=variant), compat=compat,
                                  T=4, seed=4)
    x = images((64, 96), seed=1)
    want = _logits_jax(jm, variables, x)
    with torch.no_grad():
        got = pm.predict_logits(torch.from_numpy(x)).numpy()
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("variant", VARIANTS)
def test_collapse_t_is_exact_at_t4(variant):
    """T=4 computed four times: the four time slices of every pyramid
    level are bit-identical (what the collapse rests on; every v3 spike
    kind is stateless), and the collapsed model's logits equal them up
    to the ulps that PyTorch's CPU convolutions give a batch of 8 rather
    than 2 (1e-5; measured 1.2e-7); both against JAX's uncollapsed
    model at 1e-3."""
    jm, variables, full = make_pair(dict(TINY, variant=variant), T=4,
                                    collapse_t=False, seed=6)
    fast = Spike2Former(T=4, collapse_t=True, variant=variant, **TINY)
    fast.load_state_dict(full.state_dict(), strict=True)
    x = torch.from_numpy(images((64, 64), seed=2))
    with torch.no_grad():
        levels = full.backbone(x)
        lf = full.predict_logits(x)
        lc = fast.eval().predict_logits(x)
    steps = 1 if variant == "sdtv3mae" else 4    # MAE: averaged over T
    for y in levels:
        assert y.shape[0] == steps
        assert all(torch.equal(y[i], y[0]) for i in range(steps))
    np.testing.assert_allclose(lc.numpy(), lf.numpy(), atol=1e-5, rtol=0)
    want = _logits_jax(jm, variables, x.numpy())
    np.testing.assert_allclose(lf.numpy(), want, atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(lc.numpy(), want, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("variant", VARIANTS)
def test_from_jax_variables_is_strict_and_covers_the_gammas(variant):
    """Every JAX variable maps to one port key and back (``strict``), the
    MAE layer-scale gammas included, and the MAE model has no down4."""
    jm, variables, pm = make_pair(dict(TINY, variant=variant), seed=1)
    sd = from_jax_variables(variables)
    assert set(sd) == set(pm.state_dict())
    gammas = [k for k in sd if ".layer_scale" in k]
    if variant == "sdtv3mae":
        assert len(gammas) == 3 * 2 and not any(".down4." in k for k in sd)
        # drawn at O(1), as randomize_torch draws them: no silent branch
        assert min(float(sd[k].abs().mean()) for k in gammas) > 0.1
    else:
        assert not gammas and any(".down4." in k for k in sd)


@pytest.mark.parametrize("variant", VARIANTS)
def test_firing_sites_and_rates_match_jax(variant):
    """observe_spikes under flax's site names, each rate scaled by its
    kind's D (4 for multispike_norm, 8 for multispike8)."""
    from test_torch_firing import jax_rates

    jm, variables, pm = make_pair(dict(TINY, variant=variant,
                                       eval_last_only=False), T=2,
                                  collapse_t=False, seed=5)
    x = images((64, 64), seed=1)
    want = jax_rates(jm, variables, jnp.asarray(x))
    got = firing_rates(pm, torch.from_numpy(x))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    kind = "multispike8" if variant == "sdtv3mae" else "multispike_norm"
    bb = {m.kind for n, m in pm.named_modules()
          if isinstance(m, Spike) and n.startswith("backbone.")}
    assert bb == {kind}


# --- the train step ---------------------------------------------------------

@pytest.mark.parametrize("variant", VARIANTS)
def test_train_step_matches_jax(variant):
    """One step with the host matcher, T=4 collapsed (the presets'):
    losses, gradients and the state after it, at test_torch_train.py's
    tolerances.  The MAE model is held to JAX's step in float64: at
    these random weights its gradients reach 3e11, and JAX's float32
    ``grad_norm`` is 1.05e-3 off JAX's own float64 run (9.80882e11
    against 9.81909e11), where the port's float32 step reads 9.81908e11
    (``tests/torch_train_precision.py``'s measure)."""
    import test_torch_train as tt

    cfg = dict(TINY, lazy_masks=True, norm_eval=True, variant=variant)
    jm, variables, pm = make_pair(cfg=cfg, T=4, seed=3)
    batches = [tt._batch(seed=0)]
    if variant == "sdtv3mae":
        from spike2former_tpu.models import Spike2Former as JaxSpike2Former

        with jax.enable_x64(True):
            jm = JaxSpike2Former(T=4, dtype=jnp.float64, **cfg)
            want, wgrads, wstate = tt._run_jax(
                jm, jax.tree_util.tree_map(
                    lambda a: np.asarray(a, np.float64), variables),
                batches, 1, "host", 32)
    else:
        want, wgrads, wstate = tt._run_jax(jm, variables, batches, 1,
                                           "host", 32)
    got, ggrads, gstate = tt._run_port(pm, batches, 1, "host", 32)
    tt._check_metrics(want, got)
    tt._check_grads(wgrads[0], ggrads[0])
    tt._check_state(wstate, gstate, wgrads[0])
    dcn = "head.pixel_decoder.encoder_0.dcn."
    assert ggrads[0][dcn + "offset_conv.weight"].abs().max() > 0


# --- bf16, remat and packed residuals ---------------------------------------

@pytest.mark.parametrize("variant", VARIANTS)
def test_bf16_model_matches_jax_bf16(variant):
    jm, variables, pm = make_pair(dict(TINY, variant=variant),
                                  fan_in_scaled=True, dtype="bfloat16")
    x = images((64, 64), seed=0)
    want = np.asarray(jit_exact(lambda v, xx: jm.apply(
        v, xx, method=type(jm).predict_logits), variables, jnp.asarray(x))
        .astype(jnp.float32))
    with torch.no_grad():
        got = pm.predict_logits(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.isfinite(got).all() and np.abs(want).max() > 0.1
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.99
    assert np.abs(got - want).max() <= 0.064


PRESET_OF = {"sdtv3": "SDTv3_b_Spike2former_ade20k_512x512",
             "sdtv3mae": "SDTv3MAE_Spike2former_ade20k_512x512"}


def _one_step(variant, dtype="float32", remat=False, packed=False):
    opts = [f"model.{k}={v!r}".replace(" ", "") for k, v in TINY.items()]
    opts += ["train.warmup_iters=1", f"model.remat={remat}",
             f"model.dtype='{dtype}'", f"train.packed_residuals={packed}"]
    tr = api.init_trainer(PRESET_OF[variant], opts, device="cpu", seed=1)
    packed_sites = [m for m in tr.state.model.modules()
                    if isinstance(m, (tl.Conv2d, tl.Linear)) and m.packed]
    assert bool(packed_sites) == packed
    batch = synthetic_batch(np.random.default_rng(2), 2, (64, 64),
                            num_classes=4)
    metrics = api.train_steps(tr, [batch])[0]
    model = tr.state.model
    return (metrics, {k: p.grad.clone() for k, p in model.named_parameters()},
            {k: v.clone() for k, v in model.state_dict().items()})


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_and_packed_residuals_change_no_number(variant, dtype):
    """A train step with ``model.remat`` and ``train.packed_residuals``
    bit-identical to one without (the multispike codes are ``y * 4`` and
    ``y * 8``)."""
    m0, g0, s0 = _one_step(variant, dtype)
    m1, g1, s1 = _one_step(variant, dtype, remat=True, packed=True)
    assert m0 == m1 and np.isfinite(m0["total"])
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k


def test_packed_code_scale_follows_the_spike_kind():
    for variant, scale in (("sdtv2", 8.0), ("sdtv3", 4.0),
                           ("sdtv3mae", 8.0)):
        m = Spike2Former(variant=variant, **TINY)
        scales = {c.code_scale for c in m.backbone.modules()
                  if isinstance(c, tl.Conv2d) and c.spike_input}
        assert scales == {scale}, variant


# --- the reference converter ------------------------------------------------

GOLDEN = dict(num_classes=5, embed_dim=(8, 16, 24, 32), backbone_heads=4,
              feat_channels=16, num_queries=4, num_decoder_layers=2,
              num_encoder_layers=2, depths_stage3=1, depths_stage4=1,
              dcn_group=4)
DEPTHS = {k: GOLDEN[k] for k in ("depths_stage3", "depths_stage4",
                                  "num_encoder_layers", "num_decoder_layers")}


def _golden(variant, seed=21):
    from test_convert_sdtv3 import _randomize_layer_scales
    from torch_golden import GoldenSpike2Former, randomize_torch

    g = GOLDEN
    golden = GoldenSpike2Former(
        num_classes=g["num_classes"], embed_dim=g["embed_dim"],
        heads=g["backbone_heads"], T=1, feat=g["feat_channels"],
        num_queries=g["num_queries"], dec_layers=g["num_decoder_layers"],
        enc_layers=g["num_encoder_layers"], group=g["dcn_group"],
        depths_stage3=g["depths_stage3"], depths_stage4=g["depths_stage4"],
        variant=variant)
    randomize_torch(golden, seed=seed)
    _randomize_layer_scales(golden, seed=seed)
    return golden


@pytest.mark.parametrize("variant", VARIANTS)
def test_golden_state_dict_through_convert_reference(variant):
    """A reference-format v3 / MAE state dict through the port's
    converter, loaded strictly into ``compat=True``: the golden's final
    class and mask logits within 1e-3 (tests/test_convert_sdtv3.py)."""
    golden = _golden(variant)
    sd = {k: v.detach().numpy() for k, v in golden.state_dict().items()}
    pm = Spike2Former(T=1, compat=True, variant=variant, **GOLDEN)
    pm.load_state_dict(from_jax_variables(cref.convert_spike2former(
        sd, variant=variant, **DEPTHS)), strict=True)
    x = np.random.default_rng(3).normal(0, 1, (1, 3, 32, 32)).astype(
        np.float32)
    with torch.no_grad():
        cls_t, mask_t = golden(torch.from_numpy(x))
        cls_p, mask_p = pm.eval()(torch.from_numpy(x.transpose(0, 2, 3, 1)))
    np.testing.assert_allclose(cls_p[-1].numpy(), cls_t[-1].numpy(),
                               atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(mask_p[-1].numpy(), mask_t[-1].numpy(),
                               atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("given, asked", [("sdtv3", "sdtv2"),
                                          ("sdtv2", "sdtv3"),
                                          ("sdtv2", "sdtv3mae"),
                                          ("sdtv3mae", "sdtv3"),
                                          ("sdtv3", "sdtv3mae")])
def test_a_state_dict_of_another_variant_fails_loudly(given, asked):
    sd = {k: v.detach().numpy() for k, v in
          _golden(given, seed=1).state_dict().items()}
    with pytest.raises(KeyError):
        cref.convert_spike2former(sd, variant=asked, **DEPTHS)


def test_eval_cli_reads_a_v3_checkpoint_by_model_variant(tmp_path):
    """``--torch-checkpoint`` with the MAE preset picks the MAE key map."""
    from torch_port_helpers import write_ade_tree
    from spike2former_tpu_torch.tools import test as eval_cli

    path = str(tmp_path / "golden.pth")
    torch.save({"state_dict": _golden("sdtv3mae").state_dict()}, path)
    root = write_ade_tree(tmp_path / "ade", n=2, seed=1)
    opts = [f"model.{k}={v!r}".replace(" ", "") for k, v in GOLDEN.items()]
    opts += ["data.test_scale=(128,96)", "model.T=1"]
    assert eval_cli.main(["SDTv3MAE_Spike2former_ade20k_512x512",
                          "--device", "cpu", "--data-root", root,
                          "--torch-checkpoint", path,
                          "--cfg-options", *opts]) == 0
    with pytest.raises(KeyError):
        eval_cli.main(["SDTv3_b_Spike2former_ade20k_512x512", "--device",
                       "cpu", "--data-root", root, "--torch-checkpoint",
                       path, "--cfg-options", *opts])


# --- the presets ------------------------------------------------------------

@pytest.mark.parametrize("name", V3_PRESETS)
def test_presets_match_jax(name):
    from spike2former_tpu.engine.config import get_config as jax_get_config

    want, got = jax_get_config(name), get_config(name)
    assert name in PRESETS
    for part in ("model", "data", "train", "test"):
        for k, v in vars(getattr(got, part)).items():
            assert v == getattr(getattr(want, part), k), (part, k)
    assert got.model.T == 4 and got.model.collapse_t
    assert build_model(got.model).backbone.variant == got.model.variant


def test_unported_kinds_are_refused_with_a_reason():
    """Every model kind of the JAX package is ported (the FPN family
    among them, in float32 and bfloat16); a kind that is none of them, a
    dtype that is neither and a preset that does not exist are refused
    with a reason."""
    for kind in ("fpn", "cascade"):
        assert get_config(V3_PRESETS[0],
                          [f"model.kind='{kind}'"]).model.kind == kind
    with pytest.raises(ValueError, match="model.kind must be one of"):
        build_model(get_config(V3_PRESETS[0], ["model.kind='unet'"]).model)
    m = build_model(get_config("fpn_sdtv3_512x512_10M_ade20k",
                               ["model.dtype='bfloat16'"]).model)
    assert m.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in m.parameters())
    with pytest.raises(ValueError, match="model.dtype must be one of"):
        build_model(get_config("fpn_sdtv3_512x512_10M_ade20k",
                               ["model.dtype='float16'"]).model)
    with pytest.raises(KeyError, match="no preset 'fpn_sdtv3_1B'"):
        get_config("fpn_sdtv3_1B")
