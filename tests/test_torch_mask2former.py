"""The port's Mask2Former mode of the MaskFormer head
(``model.masked_attention``) against the JAX package's: the attention-mask
rule, the head (eval, and training mode with lazy and with dense masks),
the model, its train step and its weights.

Tolerances: the mask rule exactly; the head's logits and factored masks
at 1e-4 (``tests/test_torch_head.py``'s multi-layer stacks) and its BN
statistics at 1e-5; the model's logits at 1e-3 (the end-to-end tolerance
of ``tests/test_full_model_parity.py``); the train step at
``tests/test_torch_train.py``'s tolerances, held to JAX's step in float64
with the host matcher (JAX's float32 step drifts from its own float64 run
by more than those tolerances at random weights, as
``tests/test_torch_panoptic.py``'s step fixture records; JAX's auction
does not run in float64).
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
from spike2former_tpu.models import maskformer_head as jh
from spike2former_tpu_torch.engine.config import build_model, get_config
from spike2former_tpu_torch.engine.convert import from_jax_variables
from spike2former_tpu_torch.losses.criterion import LazyMasks
from spike2former_tpu_torch.models import maskformer_head as th

from test_torch_head import HEAD, _pyramid
from test_torch_train import (_batch, _check_grads, _check_metrics,
                              _check_state, _run_jax, _run_port)
from torch_port_helpers import TINY, load_port, make_pair

M2F_HEAD = dict(HEAD, masked_attention=True)


def test_attn_mask_matches_jax():
    """Logits resized to coarser, equal and finer levels; a query whose
    resized logits are all negative (its row stays open); the padding
    mask ORed in."""
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 1, (2, 5, 8, 12)).astype(np.float32)
    logits[0, 1] = -np.abs(logits[0, 1]) - 0.1     # every key masked
    logits[1, 2] = np.abs(logits[1, 2]) + 0.1      # no key masked
    for hw in ((4, 6), (8, 12), (16, 24), (3, 5)):
        pad = rng.uniform(size=(2, 1, 1, hw[0] * hw[1])) < 0.2
        for p in (None, pad):
            want = np.asarray(jh.mask2former_attn_mask(
                jnp.asarray(logits), hw,
                pad_mask=None if p is None else jnp.asarray(p)))
            got = th.mask2former_attn_mask(
                torch.from_numpy(logits), hw,
                None if p is None else torch.from_numpy(p)).numpy()
            assert got.dtype == want.dtype == bool
            np.testing.assert_array_equal(got, want)
            assert not got[0, 0, 1].all() and got.any()


def _head_pair(compat, **kw):
    feats = _pyramid(10, b=2)
    jm = jh.MaskFormerHead(compat=compat, **dict(M2F_HEAD, **kw))
    tm = th.MaskFormerHead(compat=compat, **dict(M2F_HEAD, **kw))
    variables = load_port(jm, tm, feats, seed=5)
    return jm, tm, variables, feats


@pytest.mark.parametrize("compat", [False, True])
def test_head_eval_matches_jax(compat):
    """Every layer's class and mask logits (``eval_last_only`` off), and
    the last layer's alone."""
    jm, tm, variables, feats = _head_pair(compat, eval_last_only=False)
    want = jax.jit(lambda v, f: jm.apply(v, f, False))(
        variables, [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        got = tm([torch.from_numpy(f) for f in feats])
        tm.eval_last_only = True
        last = tm([torch.from_numpy(f) for f in feats])
    assert got[0].shape == (HEAD["num_decoder_layers"] + 1, 2, 4, 6)
    assert (np.abs(np.asarray(want[1])) > 1e-6).mean() > 0.2
    for g, w, lg in zip(got, want, last):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4)
        torch.testing.assert_close(lg[0], g[-1])


@pytest.mark.parametrize("lazy", [True, False], ids=["lazy", "dense"])
@pytest.mark.parametrize("compat", [False, True])
def test_head_train_matches_jax(compat, lazy):
    """Training mode: every layer's class scores and masks (the factored
    embeddings and features with ``lazy_masks``, else the dense logits),
    and the BN statistics the forward moves (the query-axis BN's once per
    layer), against JAX's head in float64: the pixel decoder's BNs run on
    batch statistics here, and flax's one-pass float32 variance flips a
    few q8 levels of the mask features against the exact one."""
    jm, tm, variables, feats = _head_pair(compat, lazy_masks=lazy)
    with jax.enable_x64(True):
        jm = jh.MaskFormerHead(compat=compat, dtype=jnp.float64,
                               **dict(M2F_HEAD, lazy_masks=lazy))
        (cls_w, masks_w), upd = jax.jit(
            lambda v, f: jm.apply(v, f, True, mutable=["batch_stats"]))(
            jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                   variables),
            [jnp.asarray(f, jnp.float64) for f in feats])
    cls_g, masks_g = tm.train()([torch.from_numpy(f) for f in feats])
    pairs = [(cls_g, cls_w)]
    if lazy:
        assert isinstance(masks_g, LazyMasks)
        pairs += [(masks_g.embeds, masks_w.embeds),
                  (masks_g.feats, masks_w.feats)]
    else:
        pairs.append((masks_g, masks_w))
    for g, w in pairs:
        assert g.shape[0] == w.shape[0]
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=1e-4, rtol=1e-4)
    sd = tm.state_dict()
    for k, w in from_jax_variables({"batch_stats": upd["batch_stats"]}
                                   ).items():
        np.testing.assert_allclose(sd[k].numpy(), w.numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("compat", [False, True])
def test_model_matches_jax(compat):
    jm, variables, pm = make_pair(
        cfg=dict(TINY, num_decoder_layers=2, masked_attention=True),
        compat=compat, seed=1)
    x = np.random.default_rng(0).normal(0, 1, (2, 64, 96, 3)).astype(
        np.float32)
    want = jax.jit(lambda v, a: jm.apply(v, a))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-3,
                                   rtol=1e-3)


@pytest.mark.parametrize("compat", [False, True])
def test_train_step_matches_jax(compat):
    """One step of the semantic train step on the Mask2Former model
    (lazy masks): losses, gradients and the state after it."""
    cfg = dict(TINY, num_decoder_layers=2, masked_attention=True,
               lazy_masks=True, norm_eval=True)
    _, variables, pm = make_pair(cfg=cfg, compat=compat, seed=3)
    batches = [_batch(seed=0)]
    with jax.enable_x64(True):
        jm = JaxSpike2Former(T=1, compat=compat, dtype=jnp.float64, **cfg)
        want, wgrads, wstate = _run_jax(
            jm, jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                       variables),
            batches, 1, "host", 32)
    got, ggrads, gstate = _run_port(pm, batches, 1, "host", 32)
    _check_metrics(want, got)
    assert "d1.loss_mask" in got[0]
    _check_grads(wgrads[0], ggrads[0])
    _check_state(wstate, gstate, wgrads[0])


def test_weights_load_strictly_and_add_no_parameter():
    """The JAX variables of the Mask2Former model load with
    ``strict=True``; the mode adds no parameter, in either package."""
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    trees = [jax.eval_shape(JaxSpike2Former(T=1, masked_attention=m,
                                            **TINY).init,
                            jax.random.PRNGKey(0), x) for m in (False, True)]
    for col in ("params", "batch_stats"):
        assert (jax.tree_util.tree_structure(trees[0][col])
                == jax.tree_util.tree_structure(trees[1][col]))
    jm, variables, pm = make_pair(cfg=dict(TINY, masked_attention=True))
    assert pm.head.masked_attention
    plain = make_pair(cfg=TINY)[2]
    assert pm.state_dict().keys() == plain.state_dict().keys()
    assert set(from_jax_variables(variables)) == set(pm.state_dict())


def test_config_builds_the_masked_head():
    opts = [f"model.{k}={v!r}".replace(" ", "") for k, v in TINY.items()]
    cfg = get_config("SDTv2_maskformer_DCNpixelDecoder_ade20k",
                     opts + ["model.masked_attention=True"])
    assert cfg.model.masked_attention and cfg.model.decoder == "detr"
    assert build_model(cfg.model).head.masked_attention
