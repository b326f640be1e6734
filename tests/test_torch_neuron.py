"""The port's multi-step neurons and surrogate spike functions
(``spike2former_tpu_torch/ops/neuron.py``) against the JAX package's
``ops/neuron.py`` on the CPU: the spike trains, the final membrane and the
BPTT gradients (to the input sequence, to ``v_init`` and to PLIF's ``w``)
of each neuron under each surrogate, with the reset soft or hard and
``detach_reset`` both ways.

Tolerances: spikes exactly (the charge is the same float32 arithmetic in
the same order, and no potential of these seeded inputs sits on the
threshold), the final membrane within 1e-6 and gradients within 1e-5,
absolute plus relative.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spike2former_tpu.ops import neuron as jn
from spike2former_tpu_torch.ops import neuron as pn

T, SHAPE = 4, (3, 7)
GRAD_TOL = 1e-5


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.6, 1.2, (T, *SHAPE)).astype(np.float32)
    v0 = rng.normal(0.0, 0.5, SHAPE).astype(np.float32)
    cot_s = rng.normal(0.0, 1.0, (T, *SHAPE)).astype(np.float32)
    cot_v = rng.normal(0.0, 1.0, SHAPE).astype(np.float32)
    return x, v0, cot_s, cot_v


def _jax_run(fn, x, v0, cot_s, cot_v, w=None):
    """spikes, v, and the gradients of <spikes, cot_s> + <v, cot_v> to
    x, v0 (and w)."""

    def loss(x, v0, w):
        out = fn(x, v0) if w is None else fn(x, v0, w)
        return (jnp.sum(out.spikes * cot_s) + jnp.sum(out.v * cot_v),
                out)

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2) if w is not None else (0, 1),
        has_aux=True))(x, v0, w)
    return [np.asarray(a) for a in (out.spikes, out.v, *grads)]


def _port_run(fn, x, v0, cot_s, cot_v, w=None):
    xt = torch.tensor(x, requires_grad=True)
    vt = torch.tensor(v0, requires_grad=True)
    args = [xt, vt]
    if w is not None:
        wt = torch.tensor(w, requires_grad=True)
        args.append(wt)
    out = fn(*args)
    loss = (out.spikes * torch.from_numpy(cot_s)).sum() + (
        out.v * torch.from_numpy(cot_v)).sum()
    loss.backward()
    grads = [xt.grad, vt.grad] + ([wt.grad] if w is not None else [])
    return [a.detach().numpy() for a in (out.spikes, out.v, *grads)]


def _check(got, want):
    spikes_g, v_g, *grads_g = got
    spikes_w, v_w, *grads_w = want
    np.testing.assert_array_equal(spikes_g, spikes_w)
    np.testing.assert_allclose(v_g, v_w, atol=1e-6, rtol=1e-6)
    for g, w in zip(grads_g, grads_w):
        np.testing.assert_allclose(g, w, atol=GRAD_TOL, rtol=GRAD_TOL)


RESETS = {"hard": 0.0, "soft": None}


@pytest.mark.parametrize("detach", [False, True])
@pytest.mark.parametrize("reset", sorted(RESETS))
@pytest.mark.parametrize("surrogate", sorted(pn.SURROGATES))
def test_lif_under_each_surrogate_matches_jax(surrogate, reset, detach):
    x, v0, cs, cv = _inputs()
    kw = dict(tau=2.0, v_reset=RESETS[reset], surrogate=surrogate,
              detach_reset=detach)
    want = _jax_run(lambda x, v: jn.multistep_lif(x, v_init=v, **kw),
                    x, v0, cs, cv)
    got = _port_run(lambda x, v: pn.multistep_lif(x, v_init=v, **kw),
                    x, v0, cs, cv)
    assert 0 < want[0].mean() < 1, "some spikes fire and some do not"
    _check(got, want)


NEURONS = {
    "if": (jn.multistep_if, pn.multistep_if, {}),
    "lif_no_decay_input": (jn.multistep_lif, pn.multistep_lif,
                           dict(tau=3.0, decay_input=False)),
    "lif_threshold": (jn.multistep_lif, pn.multistep_lif,
                      dict(tau=1.5, v_threshold=0.7)),
    "eif": (jn.multistep_eif, pn.multistep_eif,
            dict(tau=2.0, delta_t=1.0, theta_rh=0.8)),
}


@pytest.mark.parametrize("detach", [False, True])
@pytest.mark.parametrize("reset", sorted(RESETS))
@pytest.mark.parametrize("name", sorted(NEURONS))
def test_neuron_matches_jax(name, reset, detach):
    jfn, pfn, kw = NEURONS[name]
    kw = dict(kw, v_reset=RESETS[reset], detach_reset=detach,
              surrogate="atan" if name == "eif" else "sigmoid")
    x, v0, cs, cv = _inputs(1)
    if name == "eif":       # keep exp((v - 0.8) / 1) moderate
        x, v0 = x * 0.5, v0 * 0.5
    want = _jax_run(lambda x, v: jfn(x, v_init=v, **kw), x, v0, cs, cv)
    got = _port_run(lambda x, v: pfn(x, v_init=v, **kw), x, v0, cs, cv)
    assert 0 < want[0].mean() < 1
    _check(got, want)


@pytest.mark.parametrize("detach", [False, True])
@pytest.mark.parametrize("reset", sorted(RESETS))
def test_plif_and_its_w_gradient_match_jax(reset, detach):
    x, v0, cs, cv = _inputs(2)
    w = np.float32(0.3)
    kw = dict(v_reset=RESETS[reset], detach_reset=detach,
              surrogate="erf")
    want = _jax_run(lambda x, v, w: jn.multistep_plif(x, w, v_init=v, **kw),
                    x, v0, cs, cv, w)
    got = _port_run(lambda x, v, w: pn.multistep_plif(x, w, v_init=v, **kw),
                    x, v0, cs, cv, w)
    assert abs(float(want[-1])) > 1e-3, "w's gradient is not silent"
    _check(got, want)


def test_qif_matches_jax_and_equals_qspike_from_rest():
    from spike2former_tpu_torch.ops.spike import qspike

    x, v0, cs, cv = _inputs(3)
    x = x * 4.0
    want = _jax_run(lambda x, v: jn.multistep_qif(x, v_init=v), x, v0, cs,
                    cv)
    got = _port_run(lambda x, v: pn.multistep_qif(x, v_init=v), x, v0, cs,
                    cv)
    _check(got, want)
    one = torch.from_numpy(x[:1])
    torch.testing.assert_close(pn.multistep_qif(one).spikes, qspike(one),
                               rtol=0, atol=0)


@pytest.mark.parametrize("name", sorted(pn.SURROGATES))
def test_surrogate_fires_at_exactly_zero_and_takes_jax_derivative(name):
    """Heaviside ``v >= 0``: a potential exactly at threshold fires; the
    derivative at and around 0 (piecewise-quadratic's edges included) is
    JAX's."""
    v = np.array([-2.0, -1.0, -0.5, -1e-3, 0.0, 1e-3, 0.5, 1.0, 2.0],
                 np.float32)
    g = np.linspace(0.5, 1.5, v.size).astype(np.float32)
    jf = jn.SURROGATES[name]
    want_y, vjp = jax.vjp(jf, jnp.asarray(v))
    (want_g,) = vjp(jnp.asarray(g))
    vt = torch.tensor(v, requires_grad=True)
    y = pn.SURROGATES[name](vt)
    y.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(want_y))
    assert y[4] == 1.0 and y[3] == 0.0
    np.testing.assert_allclose(vt.grad.numpy(), np.asarray(want_g),
                               atol=1e-6, rtol=1e-6)
