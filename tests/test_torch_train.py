"""The port's semantic train step against the JAX package's
``make_train_step`` (``loss_at='gt'``, lazy masks, ``norm_eval``; the host
matcher, and the preset's defaults: the auction matcher with
``compact_gt``), at tiny dims, 64x64 crops and batch 2, on the same seeded
weights, images and semantic maps.

One JAX train step is compiled per module and run for two steps; a
recording optimizer keeps the gradients it was given.

Tolerances (f32 on both sides):
* every loss key and ``total``: 1e-4 relative; ``grad_norm`` 5e-4
  relative (with compat=True the JAX f32 step's is 1.9e-4 off its own f64
  run, 346.1443 against 346.2090, where the port's reads 346.2095);
* gradients, leaf by leaf: 1e-3 of the largest gradient, plus 1e-4
  relative.  The JAX f32 step is up to 5.8e-4 of the largest gradient off
  a JAX f64 run of itself (compat=True, second step), while JAX f64 and
  the port in f64 agree within 2.5e-7 of it and the port's f32 step stays
  within 3.2e-6 of its f64 run (``torch_train_precision.py --compat
  --jax-f64``);
* BN running statistics after two steps: 1e-5 relative, 1e-6 absolute;
* parameters after two steps: 1e-4 (a tenth of a step at lr 1e-3) where
  the last gradient stands above 1e-2 of the largest, 2.2e-3 elsewhere.
  Adam divides each gradient element by its own magnitude, so an element
  at the level of the JAX side's rounding noise (biases that feed a
  training-mode BN have a true gradient of 0) moves by up to the rate in
  either direction.
"""
import sys
import os

sys.path.insert(0, os.path.dirname(__file__))

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from spike2former_tpu.engine import train as jtrain
from spike2former_tpu.engine.optim import make_optimizer
from spike2former_tpu.models import layers as jlayers
from spike2former_tpu_torch.engine import train as ttrain
from spike2former_tpu_torch.engine.config import TrainConfig
from spike2former_tpu_torch.engine.convert import from_jax_variables
from spike2former_tpu_torch.losses.criterion import LazyMasks
from spike2former_tpu_torch.models import layers as tlayers

from torch_port_helpers import TINY, make_pair

NUM_CLASSES = TINY["num_classes"]
LOSS_RTOL, GRAD_NORM_RTOL = 1e-4, 5e-4
GRAD_RTOL, GRAD_ATOL_FRAC = 1e-4, 1e-3
STATS_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_ATOL, PARAM_NOISE_ATOL, NOISE_FRAC = 1e-4, 2.2e-3, 1e-2


def _batch(b=2, hw=(64, 64), seed=0, num_classes=NUM_CLASSES):
    """uint8 images and piecewise-constant semantic maps of classes
    below ``num_classes``, with ignore pixels."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (b, *hw, 3), dtype=np.uint8)
    blocks = rng.integers(0, num_classes, (b, hw[0] // 16, hw[1] // 16))
    sem = np.kron(blocks, np.ones((16, 16), np.int64)).astype(np.int32)
    sem[:, :4, :] = 255
    return images, sem


def _recording(tx):
    """``tx`` whose state also keeps the last gradients it was given."""
    def init(params):
        return tx.init(params), jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        upd, inner = tx.update(grads, state[0], params)
        return upd, (inner, grads)

    return optax.GradientTransformation(init, update)


def _run_jax(jm, variables, batches, accum_steps, matcher, compact_gt,
             compiler_options=None):
    """JAX's jitted step over ``batches``; ``compiler_options`` (e.g.
    ``torch_port_helpers.EXACT_BF16``) go to its compilation."""
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])
    tx = _recording(make_optimizer(params, warmup_iters=1))
    state = jtrain.TrainState(jnp.zeros((), jnp.int32), params, stats,
                              tx.init(params))
    step = jax.jit(jtrain.make_train_step(
        jm, tx, num_classes=NUM_CLASSES, matcher=matcher, loss_at="gt",
        accum_steps=accum_steps, compact_gt=compact_gt))
    if compiler_options:
        images, sem = batches[0]
        step = step.lower(state, jnp.asarray(images), jnp.asarray(sem)
                          ).compile(compiler_options=compiler_options)
    metrics, grads = [], []
    for images, sem in batches:
        state, m = step(state, jnp.asarray(images), jnp.asarray(sem))
        metrics.append({k: float(v) for k, v in m.items()})
        grads.append(jax.tree_util.tree_map(np.asarray, state.opt_state[1]))
    final = jax.tree_util.tree_map(
        np.asarray, {"params": state.params, "batch_stats": state.batch_stats})
    return metrics, grads, final


def _run_port(pm, batches, accum_steps, matcher, compact_gt):
    state = ttrain.init_state(pm, TrainConfig(warmup_iters=1))
    step = ttrain.make_train_step(NUM_CLASSES, matcher=matcher, loss_at="gt",
                                  accum_steps=accum_steps,
                                  compact_gt=compact_gt)
    metrics, grads = [], []
    for images, sem in batches:
        state, m = step(state, torch.from_numpy(images),
                        torch.from_numpy(sem).long())
        metrics.append({k: float(v) for k, v in m.items()})
        grads.append({k: p.grad.clone() for k, p in pm.named_parameters()})
    return metrics, grads, {k: v.clone() for k, v in pm.state_dict().items()}


def _run_both(accum_steps, compat=False, matcher="host", compact_gt=32,
              batches=None):
    cfg = dict(TINY, lazy_masks=True, norm_eval=True)
    jm, variables, pm = make_pair(cfg=cfg, compat=compat, seed=3)
    batches = batches or [_batch(seed=0), _batch(seed=1)]
    return (_run_jax(jm, variables, batches, accum_steps, matcher, compact_gt),
            _run_port(pm, batches, accum_steps, matcher, compact_gt))


@pytest.fixture(scope="module")
def two_steps():
    return _run_both(accum_steps=1)


def _check_metrics(want, got):
    for w, g in zip(want, got):
        assert set(g) == set(w)
        for k in w:
            rtol = GRAD_NORM_RTOL if k == "grad_norm" else LOSS_RTOL
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=1e-7,
                                       err_msg=k)
        assert g["total"] > 0 and np.isfinite(g["total"])


def _check_grads(want_tree, got):
    want = from_jax_variables({"params": want_tree})
    assert set(want) == set(got)
    top = max(float(w.abs().max()) for w in want.values())
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), err_msg=k,
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL_FRAC * top)


def _check_state(want_tree, got, last_grads):
    want = from_jax_variables(want_tree)
    grads = from_jax_variables({"params": last_grads})
    assert set(want) == set(got)
    top = max(float(g.abs().max()) for g in grads.values())
    for k, w in want.items():
        g, w = got[k].numpy(), w.numpy()
        if k not in grads:  # BN running statistics
            np.testing.assert_allclose(g, w, err_msg=k, **STATS_TOL)
            continue
        atol = np.where(grads[k].abs().numpy() >= NOISE_FRAC * top,
                        PARAM_ATOL, PARAM_NOISE_ATOL)
        assert (np.abs(g - w) <= atol).all(), (k, np.abs(g - w).max())


def test_train_step_losses_match_jax(two_steps):
    (want, _, _), (got, _, _) = two_steps
    _check_metrics(want, got)
    assert {"loss_cls", "d0.loss_mask", "total", "grad_norm",
            "dropped_gt"} <= set(got[0])


def test_train_step_gradients_match_jax(two_steps):
    (_, want, _), (_, got, _) = two_steps
    for w, g in zip(want, got):
        _check_grads(w, g)
    # the DCN offset and mask heads learn (the sampler's gradient)
    dcn = "head.pixel_decoder.encoder_0.dcn."
    for name in ("offset_conv.weight", "mask_conv.weight"):
        assert got[0][dcn + name].abs().max() > 0


def test_train_step_state_after_two_steps_matches_jax(two_steps):
    (_, wgrads, want), (_, _, got) = two_steps
    _check_state(want, got, wgrads[-1])


def test_accum_steps_2_matches_jax():
    (want, wgrads, wstate), (got, ggrads, gstate) = _run_both(accum_steps=2)
    _check_metrics(want, got)
    _check_grads(wgrads[-1], ggrads[-1])
    _check_state(wstate, gstate, wgrads[-1])


# compat=True (~25 s alone: one more JAX compile of the step) runs with
# --runslow: the compat=False case holds the auction step, and
# test_train_forward_matches_jax[True] the compat model's train forward
@pytest.mark.parametrize("compat", [
    False, pytest.param(True, marks=pytest.mark.slow)])
def test_train_step_at_the_preset_defaults_matches_jax(compat):
    """The preset's own step, ``matcher='auction'`` and ``compact_gt=32``
    (at 5 classes the 5 GT slots are all inside the compact width), two
    steps: losses, ``repaired_gt`` (0), gradients and state.  The auction
    assumes no more valid GT slots than queries, as the flagship's 100
    queries and 64 slots keep it, so the maps hold 4 classes for the 4
    queries."""
    t = TrainConfig()
    assert (t.matcher, t.compact_gt) == ("auction", 32)
    batches = [_batch(seed=0, num_classes=4), _batch(seed=1, num_classes=4)]
    (want, wgrads, wstate), (got, ggrads, gstate) = _run_both(
        accum_steps=1, compat=compat, matcher=t.matcher,
        compact_gt=t.compact_gt, batches=batches)
    _check_metrics(want, got)
    assert all(m["repaired_gt"] == 0 for m in got)
    for w, g in zip(wgrads, ggrads):
        _check_grads(w, g)
    _check_state(wstate, gstate, wgrads[-1])


# Both cases (~25 s alone each: a JAX compile of the step) run with
# --runslow: the branches are the loss's, which
# tests/test_torch_criterion_compact.py holds against JAX in both
# (test_auction_compact_loss_matches_jax), and the defaults test above
# holds the auction step
@pytest.mark.parametrize("compat", [
    pytest.param(False, marks=pytest.mark.slow),
    pytest.param(True, marks=pytest.mark.slow)])
def test_train_step_compact_gt_branches_match_jax(compat):
    """``compact_gt=3`` of the 5 slots: the first batch holds 2 classes (the
    GT axis is cut to 3 slots), the second 4 in one map (a valid slot past
    the compact width: the full-width branch)."""
    batches = [_batch(seed=0, num_classes=2), _batch(seed=1, num_classes=4)]
    sem = batches[1][1]
    assert max(len(np.unique(s[s != 255])) for s in sem) == 4
    (want, wgrads, _), (got, ggrads, _) = _run_both(
        accum_steps=1, compat=compat, matcher="auction", compact_gt=3,
        batches=batches)
    _check_metrics(want, got)
    for w, g in zip(wgrads, ggrads):
        _check_grads(w, g)


# --- train-mode modules ------------------------------------------------------

def _flax_bn_train(module, x, variables):
    y, upd = module.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    return np.asarray(y), jax.tree_util.tree_map(np.asarray, upd)


@pytest.mark.parametrize("kind", ["BatchNorm", "BNAndPad"])
def test_train_mode_batchnorm_matches_flax(kind):
    """Batch statistics (biased variance), the running update
    ``0.9 * ra + 0.1 * batch`` and, for BNAndPad, the pad value from the
    updated running statistics."""
    rng = np.random.default_rng(0)
    c = 6
    x = (rng.normal(size=(3, 5, 4, c)) * 2 + 1).astype(np.float32)
    if kind == "BatchNorm":
        jmod = jlayers.BatchNorm(use_running_average=False)
        tmod = tlayers.BatchNorm(c)
        call = jmod
    else:
        jmod = jlayers.BNAndPad()
        tmod = tlayers.BNAndPad(c)

        class Train(fnn.Module):
            @fnn.compact
            def __call__(self, x):
                return jlayers.BNAndPad(name="BNAndPad_0")(x, True)
        call = Train()
    variables = call.init(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape), jnp.float32),
        variables)
    want, upd = _flax_bn_train(call, x, variables)
    sd = from_jax_variables(variables)
    prefix = "BNAndPad_0." if kind == "BNAndPad" else ""
    tmod.load_state_dict({k[len(prefix):]: v for k, v in sd.items()})
    got = tmod.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5,
                               rtol=1e-5)
    new = from_jax_variables(upd)
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(tmod, k).numpy(),
                                   new[prefix + k].numpy(), rtol=1e-6,
                                   atol=1e-7)


def test_norm_eval_keeps_backbone_bns_frozen():
    _, _, pm = make_pair(cfg=dict(TINY, norm_eval=True))
    pm.train()
    assert not any(m.training for m in pm.backbone.modules())
    assert pm.head.training and pm.head.shortcut_bn.training
    before = pm.backbone.down1_1.BatchNorm_0.mean.clone()
    pm(torch.zeros((1, 64, 64, 3)))
    torch.testing.assert_close(pm.backbone.down1_1.BatchNorm_0.mean, before)
    pm.eval()
    assert not pm.head.training


@pytest.mark.parametrize("compat", [False, True])
def test_train_forward_matches_jax(compat):
    """Training-mode forward: class scores of all L+1 = 2 supervised
    layers, the factored mask embeddings and features, and the BN
    statistics it updates, against the JAX model's ``apply(..., True)``."""
    cfg = dict(TINY, lazy_masks=True, norm_eval=True)
    jm, variables, pm = make_pair(cfg=cfg, compat=compat, seed=2)
    x = np.random.default_rng(3).normal(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    (cls_w, lm_w), upd = jax.jit(
        lambda v, x: jm.apply(v, x, True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    cls_g, lm_g = pm.train()(torch.from_numpy(x))
    assert isinstance(lm_g, LazyMasks)
    assert cls_g.shape == (TINY["num_decoder_layers"] + 1, 2,
                           TINY["num_queries"], NUM_CLASSES + 1)
    for g, w in ((cls_g, cls_w), (lm_g.embeds, lm_w.embeds),
                 (lm_g.feats, lm_w.feats)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=1e-4, rtol=1e-4)
    stats = from_jax_variables({"batch_stats": upd["batch_stats"]})
    sd = pm.state_dict()
    for k, w in stats.items():
        np.testing.assert_allclose(sd[k].numpy(), w.numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=k)


@pytest.mark.slow
def test_train_step_compat_matches_jax():
    """The same two steps with ``compat=True`` (the reference's layout
    quirks change the head's numbers): losses, gradients and state.  At
    this seed some queries' mask embeddings spike to all zeros, so their
    logits are exactly 0 and the focal loss's derivative conventions at 0
    (``losses.focal_terms``) carry the gradient."""
    (want, wgrads, wstate), (got, ggrads, gstate) = _run_both(
        accum_steps=1, compat=True)
    _check_metrics(want, got)
    for w, g in zip(wgrads, ggrads):
        _check_grads(w, g)
    _check_state(wstate, gstate, wgrads[-1])
