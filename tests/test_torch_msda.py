"""The port's multi-scale deformable attention (``ops/msda.py``) and the
spiking Deformable-DETR encoder (``models/deformable.py``) against the JAX
package's on the CPU; mirrors JAX's tests/test_msda.py.

``ms_deform_attn`` is held to JAX's selector contraction and to an
independent ``F.grid_sample`` golden at atol 2e-5 / rtol 1e-4 (JAX's own
test's tolerance), with sampling locations up to 0.1 outside [0, 1] on
every side.  The modules run with the same seeded weights (the
layer-scale gammas drawn, so the attention branch shows), carried across
by ``from_jax_variables`` and loaded strictly, in inference and training
mode (BN batch statistics, running statistics updated), within 1e-4
absolute in inference and 5e-4 in training, where flax's one-pass batch
variance (E[x^2] - E[x]^2) and the port's two-pass one differ in their
last bits on channels of near-constant input (measured 1.2e-4).  JAX's
deformable modules take no ``compat`` switch (their ``MSDAFFN`` is built
at its default, ``compat=False``), so there is one mode to hold;
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

from spike2former_tpu.models import deformable as jdef
from spike2former_tpu.ops.msda import ms_deform_attn as jax_msda
from spike2former_tpu_torch.engine.convert import from_jax_variables
from spike2former_tpu_torch.models import deformable as tdef
from spike2former_tpu_torch.ops.msda import ms_deform_attn

from test_msda import torch_msda_golden
from torch_port_helpers import randomize_variables

ATOL, RTOL = 2e-5, 1e-4       # the sampler
MODULE_ATOL = 1e-4            # the modules in inference
TRAIN_ATOL = 5e-4             # and in training

# (b, heads, dim, nq, p, level shapes)
SAMPLER_CASES = {
    "two_levels": (2, 4, 8, 6, 4, ((8, 10), (4, 5))),
    "four_levels": (1, 8, 4, 11, 3, ((16, 12), (8, 6), (4, 3), (2, 2))),
    "one_level_wide": (2, 2, 16, 5, 2, ((3, 17),)),
}


def _sampler_inputs(case, seed=0):
    b, heads, dim, nq, p, shapes = SAMPLER_CASES[case]
    rng = np.random.default_rng(seed)
    total = sum(h * w for h, w in shapes)
    value = rng.normal(size=(b, total, heads, dim)).astype(np.float32)
    locs = rng.uniform(-0.1, 1.1, size=(b, nq, heads, len(shapes), p, 2)
                       ).astype(np.float32)
    weights = rng.uniform(0, 1, size=(b, nq, heads, len(shapes), p)
                          ).astype(np.float32)
    return value, shapes, locs, weights


@pytest.mark.parametrize("case", SAMPLER_CASES)
def test_ms_deform_attn_matches_jax_and_grid_sample(case):
    value, shapes, locs, weights = _sampler_inputs(case)
    want = np.asarray(jax_msda(jnp.asarray(value), shapes,
                               jnp.asarray(locs), jnp.asarray(weights)))
    got = ms_deform_attn(torch.from_numpy(value), shapes,
                         torch.from_numpy(locs), torch.from_numpy(weights))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(
        got.numpy(), torch_msda_golden(value, shapes, locs, weights),
        atol=ATOL, rtol=RTOL)
    # some samples leave the maps: the zero padding is exercised
    assert ((locs < 0) | (locs > 1)).any()


def test_ms_deform_attn_returns_the_value_dtype_and_is_differentiable():
    value, shapes, locs, weights = _sampler_inputs("two_levels", 1)
    v = torch.from_numpy(value).requires_grad_()
    out = ms_deform_attn(v.bfloat16(), shapes, torch.from_numpy(locs),
                         torch.from_numpy(weights))
    assert out.dtype == torch.bfloat16
    out.float().sum().backward()
    assert v.grad is not None and float(v.grad.abs().max()) > 0


def test_encoder_reference_points_match_jax():
    shapes = ((8, 8), (4, 6), (3, 2))
    want = np.asarray(jdef.encoder_reference_points(shapes))
    got = tdef.encoder_reference_points(shapes)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(got[0, 0].numpy(), [0.5 / 8, 0.5 / 8])


def load_port(jm, pm, *args, seed):
    """Init ``jm`` on the numpy ``args`` and the static ``SHAPES`` (no
    compute), redraw its variables from ``seed`` and load them strictly
    into ``pm``; returns the variables."""
    arrays = [a if a is None else jnp.asarray(a) for a in args]
    variables = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                               *arrays[:-1], SHAPES,
                                               arrays[-1]))
    variables = randomize_variables(variables, seed)
    pm.load_state_dict(from_jax_variables(variables), strict=True)
    return variables


SHAPES = ((8, 8), (4, 4))
N_TOK = sum(h * w for h, w in SHAPES)


def _tokens(seed, c=16, t=1, b=2, n=N_TOK):
    return np.random.default_rng(seed).normal(0.5, 1.0, (t, b, n, c)
                                              ).astype(np.float32)


def _attn_pair():
    return (jdef.SpikeMSDeformAttention(16, num_heads=4, num_levels=2,
                                        num_points=3),
            tdef.SpikeMSDeformAttention(16, num_heads=4, num_levels=2,
                                        num_points=3))


@pytest.mark.parametrize("query_pos", [False, True])
def test_spike_msdeform_attention_matches_jax(query_pos):
    q, v = _tokens(1, n=5), _tokens(2)
    ref = np.random.default_rng(3).uniform(0, 1, (5, 2, 2)).astype(
        np.float32)
    pos = _tokens(4, n=5) if query_pos else None
    jm, pm = _attn_pair()
    variables = load_port(jm, pm, q, v, ref, pos, seed=5)
    want = np.asarray(jax.jit(
        lambda vv, *a: jm.apply(vv, *a, SHAPES, pos))(variables, q, v, ref))
    with torch.no_grad():
        got = pm.eval()(torch.from_numpy(q), torch.from_numpy(v),
                        torch.from_numpy(ref), SHAPES,
                        None if pos is None else torch.from_numpy(pos))
    assert got.shape == want.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, atol=MODULE_ATOL)
    assert np.ptp(want) > 0.1


def _encoder_pair(layers=2):
    kw = dict(num_layers=layers, embed_dims=16, num_heads=4, num_points=3,
              feedforward_channels=32)
    return (jdef.SpikeDeformableEncoder(**kw),
            tdef.SpikeDeformableEncoder(**kw, num_levels=len(SHAPES)))


def test_deformable_encoder_matches_jax_in_inference():
    q, pos = _tokens(6), _tokens(7)
    jm, pm = _encoder_pair()
    variables = load_port(jm, pm, q, pos, seed=8)
    want = np.asarray(jax.jit(lambda vv, x, p: jm.apply(vv, x, SHAPES, p))(
        variables, q, pos))
    with torch.no_grad():
        got = pm.eval()(torch.from_numpy(q), SHAPES, torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), want, atol=MODULE_ATOL)
    assert np.abs(want - q).max() > 0.1       # the drawn gammas show


def test_deformable_encoder_matches_jax_in_training():
    """Training mode: BN on the batch's statistics; the output and the
    updated running statistics."""
    q = _tokens(9)
    jm, pm = _encoder_pair()
    variables = load_port(jm, pm, q, None, seed=10)
    want, upd = jax.jit(lambda vv, x: jm.apply(
        vv, x, SHAPES, None, True, mutable=["batch_stats"]))(variables, q)
    got = pm.train()(torch.from_numpy(q), SHAPES)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TRAIN_ATOL)
    sd = pm.state_dict()
    for k, w in from_jax_variables({"batch_stats": upd["batch_stats"]}
                                   ).items():
        np.testing.assert_allclose(sd[k].numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_deformable_encoder_end_to_end_as_in_jax_test():
    """JAX's test_spike_deformable_encoder_end_to_end on the port: shapes,
    finite values, the layer-scale (1e-6 at init) keeps the residual
    tiny; the attention alone with its default init."""
    q = torch.from_numpy(_tokens(0))
    ref = tdef.encoder_reference_points(SHAPES)
    assert ref.shape == (N_TOK, 2, 2)
    attn = tdef.SpikeMSDeformAttention(16, num_heads=4, num_levels=2,
                                       num_points=3).eval()
    out = attn(q, q, ref, SHAPES)
    assert out.shape == q.shape and torch.isfinite(out).all()
    enc = tdef.SpikeDeformableEncoder(num_layers=2, embed_dims=16,
                                      num_heads=4, num_points=3,
                                      feedforward_channels=32, num_levels=2)
    out = enc.train()(q, SHAPES)
    out.sum().backward()
    assert out.shape == q.shape and torch.isfinite(out).all()
    assert float((out - q).abs().max().detach()) < 1e-2
    assert enc.layer_0.gamma1.grad is not None


def test_deformable_modules_load_jax_variables_strictly():
    """The full-width encoder (feat 256, 8 heads, 3 levels, 4 points):
    JAX's variable tree (``jax.eval_shape``, no compute) maps onto the
    port's state_dict key for key."""
    kw = dict(num_layers=2, embed_dims=256, num_heads=8, num_points=4,
              feedforward_channels=1024)
    shapes = ((4, 4), (2, 2), (1, 1))
    jm = jdef.SpikeDeformableEncoder(**kw)
    q = jnp.zeros((1, 1, 21, 256))
    variables = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), q,
                                               shapes))
    sd = from_jax_variables(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), variables))
    pm = tdef.SpikeDeformableEncoder(**kw, num_levels=3)
    assert set(sd) == set(pm.state_dict())
    pm.load_state_dict(sd, strict=True)
