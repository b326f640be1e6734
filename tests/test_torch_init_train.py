"""The first train step from a fresh initial state, the port's
(``api.init_trainer``, flax's laws from ``engine/weights.py``) against the
JAX package's (``engine/train.py:init_state``, flax's ``model.init``), on
the flagship preset at tiny widths (``torch_port_helpers.TINY``), the
preset's step (the auction, ``compact_gt=32``), batch 2 of 64x64 with
maps of 4 classes for the 4 queries.

* Each side's own draw, 8 seeds a side: the first step's ``total`` loss
  and ``grad_norm`` agree in mean within 3 pooled standard errors (the
  draws differ, the laws do not).
* JAX's own ``model.init`` (``PRNGKey(0)``) converted by
  ``from_jax_variables``: one step on each side (JAX's in float64 with
  the host matcher), the losses and every gradient held as
  ``tests/test_torch_train.py`` holds them.  At flax's
  init the DCN offset and mask kernels are zero: every sampling tap lies
  on the reference grid (the pad ring too), the offset and mask BNs see an
  all-zero batch (variance 0), and the mask spikes are all 0, so the
  sampler's output and its gradient vanish in this step.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spike2former_tpu.engine import train as jtrain
from spike2former_tpu.engine.config import build_model as jax_build_model
from spike2former_tpu.engine.config import get_config as jax_get_config
from spike2former_tpu.engine.optim import make_optimizer
from spike2former_tpu_torch import api
from spike2former_tpu_torch.engine.convert import from_jax_variables

from test_torch_train import (_batch, _check_grads, _check_metrics,
                              _recording)
from torch_port_helpers import TINY

PRESET = "SDTv2_maskformer_DCNpixelDecoder_ade20k"
OPTS = [f"model.{k}={v!r}".replace(" ", "") for k, v in TINY.items()] + [
    "train.warmup_iters=1"]
SEEDS = range(8)
BATCH = _batch(seed=0, num_classes=4)


@pytest.fixture(scope="module")
def jax_side():
    """JAX's jitted ``init_state`` (as ``tools/train.py`` runs it) and its
    first step at the preset's matcher: seed -> (the initial variables,
    the step's metrics)."""
    cfg = jax_get_config(PRESET, OPTS)
    jm, t = jax_build_model(cfg.model), cfg.train
    sample = jnp.zeros((1, 64, 64, 3), jnp.float32)
    shapes = jax.eval_shape(lambda k: jm.init(k, sample),
                            jax.random.PRNGKey(0))
    tx = make_optimizer(shapes["params"], warmup_iters=1)
    init = jax.jit(lambda k: jtrain.init_state(jm, tx, k, sample))
    step = jax.jit(jtrain.make_train_step(
        jm, tx, num_classes=cfg.model.num_classes, max_gt=t.max_gt,
        matcher=t.matcher, loss_at=t.loss_at, compact_gt=t.compact_gt))

    def first_step(seed):
        state = init(jax.random.PRNGKey(seed))
        _, m = step(state, jnp.asarray(BATCH[0]), jnp.asarray(BATCH[1]))
        variables = jax.tree_util.tree_map(np.asarray, {
            "params": state.params, "batch_stats": state.batch_stats})
        return variables, {k: float(v) for k, v in m.items()}
    return first_step


def _port_step(*opts, **kw):
    tr = api.init_trainer(PRESET, OPTS + list(opts), device="cpu", **kw)
    metrics = api.train_steps(tr, [BATCH])[0]
    grads = {k: p.grad.clone() for k, p in tr.state.model.named_parameters()
             if p.grad is not None}
    return metrics, grads


def test_first_step_from_fresh_inits_agrees_in_mean(jax_side):
    want = [jax_side(s)[1] for s in SEEDS]
    got = [_port_step(seed=s)[0] for s in SEEDS]
    for k in ("total", "grad_norm"):
        w = np.array([m[k] for m in want])
        g = np.array([m[k] for m in got])
        assert np.isfinite(w).all() and np.isfinite(g).all()
        se = np.sqrt(w.var(ddof=1) / len(w) + g.var(ddof=1) / len(g))
        assert abs(w.mean() - g.mean()) <= 3 * se, (k, w, g)
        assert se > 0, k     # the seeds draw different weights


def test_one_step_from_jax_exact_init_matches_jax(jax_side):
    """JAX's step runs in float64 with the host matcher (its auction does
    not run under x64), as the panoptic and DAB step tests run it: its f32
    step drifts from its own f64 run by more than the step tolerances
    (here a q8 level flips in the backbone's last attention); the port's
    f32 step with the host matcher is held to it."""
    variables = jax_side(0)[0]
    cfg = jax_get_config(PRESET, OPTS)
    with jax.enable_x64(True):
        jm = jax_build_model(cfg.model).clone(dtype=jnp.float64)
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     variables)
        tx = _recording(make_optimizer(v64["params"], warmup_iters=1))
        step = jax.jit(jtrain.make_train_step(
            jm, tx, num_classes=cfg.model.num_classes,
            max_gt=cfg.train.max_gt, matcher="host",
            loss_at=cfg.train.loss_at, compact_gt=cfg.train.compact_gt))
        new, m = step(jtrain.TrainState(
            jnp.zeros((), jnp.int32), v64["params"], v64["batch_stats"],
            tx.init(v64["params"])), jnp.asarray(BATCH[0]),
            jnp.asarray(BATCH[1]))
        want = {k: float(v) for k, v in m.items()}
        want_grads = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32), new.opt_state[1])
    got, grads = _port_step("train.matcher='host'",
                            state_dict=from_jax_variables(variables))
    _check_metrics([want], [got])
    # the port leaves no .grad on parameters the loss does not reach; JAX
    # hands back zeros there
    zero = from_jax_variables({"params": want_grads})
    grads = {k: grads.get(k, torch.zeros_like(v)) for k, v in zero.items()}
    _check_grads(want_grads, grads)
    # the DCN branch is silent at flax's init (its input spikes and mask
    # spikes 0): no gradient reaches its offset and mask kernels
    dcn = "head.pixel_decoder.encoder_0.dcn."
    for name in ("offset_conv.weight", "mask_conv.weight"):
        assert float(grads[dcn + name].abs().max()) == 0.0
