"""The port's spiking DAB-DETR decoder (``models/dab_detr.py``,
``model.decoder='dab'``) against the JAX package's: ``inverse_sigmoid``
and ``coordinate_to_encoding``, the decoder's outputs and refined
anchors, the model, its train step (``query_anchors``' gradient among the
others) and its weights.

Tolerances: the encodings at 1e-6; the decoder at 1e-5 (a stack of
blocks, f32 in another summation order); the model's logits at 1e-3 (the
end-to-end tolerance of ``tests/test_full_model_parity.py``); the train
step at ``tests/test_torch_train.py``'s tolerances, held to JAX's step in
float64 with the host matcher, as ``tests/test_torch_mask2former.py``
does.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spike2former_tpu.models import Spike2Former as JaxSpike2Former
from spike2former_tpu.models import dab_detr as jd
from spike2former_tpu_torch.engine import train as ttrain
from spike2former_tpu_torch.engine.config import (TrainConfig, build_model,
                                                  get_config)
from spike2former_tpu_torch.engine.convert import from_jax_variables
from spike2former_tpu_torch.models import dab_detr as td
from spike2former_tpu_torch.models.segmentor import Spike2Former

from test_torch_train import (_batch, _check_grads, _check_metrics,
                              _check_state, _run_jax)
from torch_port_helpers import TINY, load_port, make_pair, spikes

DAB = dict(TINY, num_decoder_layers=2, decoder="dab")


def test_inverse_sigmoid_matches_jax():
    x = np.concatenate([np.linspace(-0.5, 1.5, 41),
                        [0.0, 1e-4, 1e-3, 0.999, 1.0]]).astype(np.float32)
    np.testing.assert_allclose(
        td.inverse_sigmoid(torch.from_numpy(x)).numpy(),
        np.asarray(jd.inverse_sigmoid(jnp.asarray(x))), atol=1e-6, rtol=0)


@pytest.mark.parametrize("d", [2, 4])
def test_coordinate_to_encoding_matches_jax(d):
    coord = np.random.default_rng(d).uniform(0.02, 0.98, (2, 5, d)).astype(
        np.float32)
    want = np.asarray(jd.coordinate_to_encoding(jnp.asarray(coord), 8))
    got = td.coordinate_to_encoding(torch.from_numpy(coord), 8).numpy()
    assert got.shape == want.shape == (2, 5, 8 * d)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("masked", [False, True], ids=["open", "padded"])
def test_decoder_matches_jax(masked):
    """Two layers: each layer's queries and the anchors it attended with,
    with and without a padding mask on the keys."""
    c, t, b, nq, nk = 16, 1, 2, 5, 24
    rng = np.random.default_rng(1)
    query = spikes((t, b, nq, c), 1) * 3 - 1
    key = spikes((t, b, nk, c), 2) * 3 - 1
    key_pos = rng.normal(0, 1, (b, nk, c)).astype(np.float32)
    anchors = rng.normal(0, 1, (b, nq, 4)).astype(np.float32)
    mask = np.zeros((b, 1, 1, nk), bool)
    if masked:
        mask[0, ..., 18:] = mask[1, ..., 20:] = True
    jm = jd.DABDetrDecoder(embed_dims=c, num_heads=4, num_layers=2,
                           feedforward_channels=32)
    tm = td.DABDetrDecoder(c, 4, 2, 32)
    variables = load_port(jm, tm, query, key, key_pos, anchors, mask,
                          seed=4)
    want = jax.jit(lambda v, *a: jm.apply(v, *a))(
        variables, *(jnp.asarray(a)
                     for a in (query, key, key_pos, anchors, mask)))
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a)
                   for a in (query, key, key_pos, anchors)),
                 cross_attn_mask=torch.from_numpy(mask))
    assert got[0].shape == (2, t, b, nq, c) and got[1].shape == (2, b, nq, 4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)
    assert np.abs(np.asarray(want[0])).max() > 0.1
    assert not np.allclose(want[1][0], want[1][1])    # anchors refined


def test_refined_anchors_are_detached():
    """The refinement carries no gradient into the next layer's anchor:
    the second layer's reference gets a gradient only through its own
    regression branch."""
    tm = td.DABDetrDecoder(16, 4, 2, 32)
    anchors = torch.randn(1, 3, 4, requires_grad=True)
    out, refs = tm(torch.rand(1, 1, 3, 16), torch.rand(1, 1, 6, 16),
                   torch.randn(1, 6, 16), anchors)
    (g,) = torch.autograd.grad(refs[1].sum(), anchors, retain_graph=True)
    # sigmoid(reg + inverse_sigmoid(sigmoid(a))) depends on ``a`` through
    # the un-detached first reference only
    assert g.abs().sum() > 0
    (g2,) = torch.autograd.grad(out[1].sum(), anchors, retain_graph=True)
    assert torch.isfinite(g2).all()


@pytest.mark.parametrize("compat", [False, True])
def test_model_matches_jax(compat):
    """Eval (the last layer) and training mode (every layer, dense
    masks), the latter against JAX's model in float64: the head's BNs run
    on batch statistics, and flax's one-pass float32 variance flips a few
    q8 levels against the exact one."""
    jm, variables, pm = make_pair(cfg=DAB, compat=compat, seed=1)
    x = np.random.default_rng(0).normal(0, 1, (2, 64, 96, 3)).astype(
        np.float32)
    want = jax.jit(lambda v, a: jm.apply(v, a))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    with jax.enable_x64(True):
        jm64 = JaxSpike2Former(T=1, compat=compat, dtype=jnp.float64, **DAB)
        want_train = jax.jit(lambda v, a: jm64.apply(
            v, a, True, mutable=["batch_stats"])[0])(
            jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                   variables), jnp.asarray(x, jnp.float64))
    got_train = pm.train()(torch.from_numpy(x))
    assert got_train[0].shape[0] == DAB["num_decoder_layers"] + 1
    for g, w in (*zip(got, want), *zip(got_train, want_train)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=1e-3, rtol=1e-3)


def _run_port(pm, batches):
    """``test_torch_train._run_port`` with the host matcher, reading a
    parameter without a gradient (the DAB head leaves ``query_embed``
    unused) as a zero one, as JAX differentiates every leaf and the
    port's AdamW updates such a parameter."""
    state = ttrain.init_state(pm, TrainConfig(warmup_iters=1))
    step = ttrain.make_train_step(TINY["num_classes"], matcher="host",
                                  loss_at="gt")
    metrics, grads = [], []
    for images, sem in batches:
        state, m = step(state, torch.from_numpy(images),
                        torch.from_numpy(sem).long())
        metrics.append({k: float(v) for k, v in m.items()})
        grads.append({k: torch.zeros_like(p) if p.grad is None
                      else p.grad.clone() for k, p in pm.named_parameters()})
    return metrics, grads, {k: v.clone() for k, v in pm.state_dict().items()}


@pytest.mark.parametrize("compat", [False, True])
def test_train_step_matches_jax(compat):
    """One semantic train step on the DAB model (lazy masks): losses,
    every gradient (``head.query_anchors`` non-zero among them) and the
    state after it."""
    cfg = dict(DAB, lazy_masks=True, norm_eval=True)
    _, variables, pm = make_pair(cfg=cfg, compat=compat, seed=3)
    batches = [_batch(seed=0)]
    with jax.enable_x64(True):
        jm = JaxSpike2Former(T=1, compat=compat, dtype=jnp.float64, **cfg)
        want, wgrads, wstate = _run_jax(
            jm, jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                       variables),
            batches, 1, "host", 32)
    got, ggrads, gstate = _run_port(pm, batches)
    _check_metrics(want, got)
    _check_grads(wgrads[0], ggrads[0])
    _check_state(wstate, gstate, wgrads[0])
    assert ggrads[0]["head.query_anchors"].abs().max() > 0
    assert pm.head.query_embed.grad is None


def test_weights_load_strictly():
    """The DAB model's JAX variables (``dab_decoder/...`` and
    ``query_anchors``, no ``decoder_i``) load with ``strict=True``."""
    _, variables, pm = make_pair(cfg=DAB)
    sd = from_jax_variables(variables)
    assert set(sd) == set(pm.state_dict())
    assert sd["head.query_anchors"].shape == (TINY["num_queries"], 4)
    assert any(k.startswith("head.dab_decoder.layer_1.cross_attn.")
               for k in sd)
    assert not any(k.startswith("head.decoder_") for k in sd)
    # the cross-attention's query position projection is the first
    # layer's only, and the content scale starts at the second layer
    assert "head.dab_decoder.layer_0.cross_attn.qpos_proj.weight" in sd
    assert "head.dab_decoder.layer_1.cross_attn.qpos_proj.weight" not in sd
    assert "head.dab_decoder.query_scale.Dense_0.weight" in sd


def test_dab_with_masked_attention_raises_jax_error():
    opts = [f"model.{k}={v!r}".replace(" ", "") for k, v in TINY.items()]
    cfg = get_config("SDTv2_maskformer_DCNpixelDecoder_ade20k",
                     opts + ["model.decoder='dab'"])
    assert build_model(cfg.model).head.decoder == "dab"
    jm = JaxSpike2Former(T=1, decoder="dab", masked_attention=True, **TINY)
    with pytest.raises(ValueError) as want:
        jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                       jnp.zeros((1, 64, 64, 3)))
    cfg.model.masked_attention = True
    with pytest.raises(ValueError) as got:
        build_model(cfg.model)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="unknown decoder"):
        Spike2Former(T=1, decoder="deformable", **TINY)
