"""The FPN family at ``model.dtype='bfloat16'`` against the JAX package's
bf16 build on the CPU, at the tiny widths of ``test_torch_fpn.py``: the
multi-step neurons on bf16 input (a bf16 membrane carried across T), the
neck with each neuron kind, whole-model logits of the FPN with SDTv3 and
with MS-ResNet-18 / -104 and of the cascade, and one train step of each.

The JAX references are compiled under ``torch_port_helpers.EXACT_BF16``
(no XLA excess precision: each bf16 op rounds, as op-by-op JAX does).

Tolerances, set from what JAX's own bf16 does on these inputs:
* neurons, neck and logits: within one bf16 ulp of the largest magnitude
  (2^-7 of it) and the classes equal on >= 0.99 of the pixels.  Measured:
  bit-equal (MS-ResNet-104's average-pool shortcut sums its window in
  bf16, as XLA does; an f32 sum rounded once is one ulp off on 30% of the
  elements and moves the logits by 2.2);
* the train step: each loss term, ``total`` and ``grad_norm`` within 2e-2
  relative (measured at most 1.3e-2, ``grad_norm`` of MS-ResNet-18); all
  gradients, as one vector, within 5e-2 relative L2 of JAX's and at a
  cosine of at least 0.999 (measured 2.2e-2 to 3.3e-2 and 0.9995).  JAX
  sums some bf16 reductions in bf16 (a bias's gradient: up to 1.8 of its
  largest element apart), the port in f32; JAX's own f32 step is 1.07 to
  2.34 relative L2 away from its bf16 one on the same weights.
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
from spike2former_tpu.engine.optim import make_optimizer
from spike2former_tpu.models import fpn as jfpn
from spike2former_tpu.ops import neuron as jneuron
from spike2former_tpu_torch import api
from spike2former_tpu_torch.engine.convert import from_jax_variables
from spike2former_tpu_torch.models import fpn as tfpn
from spike2former_tpu_torch.ops import neuron as tneuron

from test_torch_fpn import TINY_FPN, _feats, _pair
from test_torch_fpn_train import (SPEC, TRAIN_CASES, _given_dropout,
                                  _jax_dropout_masks, _run_port_fpn,
                                  _seg_batch)
from test_torch_train import _recording
from torch_port_helpers import images, jit_exact, load_port, to_torch

BF16 = torch.bfloat16
ULP = 2.0 ** -7            # one bf16 ulp, relative, at the top of a binade
AGREEMENT = 0.99
LOSS_RTOL = 2e-2
GRAD_REL_L2, GRAD_COS = 5e-2, 0.999
OPT = ["model.dtype='bfloat16'"]


def _within_one_ulp_of_the_largest(got: np.ndarray, want: np.ndarray):
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= ULP * np.abs(want).max(), (err, np.abs(want).max())


def _np(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# JAX's parametric LIF fails at bf16 (its ``lax.scan`` carries the
# membrane in bf16 and gets f32 back from the f32 ``w``): no reference
BF16_NEURONS = ("lif", "if", "eif", "multispike")


@pytest.mark.parametrize("kind", BF16_NEURONS[:3])
def test_multistep_neurons_carry_a_bf16_membrane_as_jax(kind):
    """bf16 input: JAX's ``lax.scan`` starts the membrane in the input's
    dtype and rounds it each step; the port's loop over T does too."""
    x = _feats((6,), ((5, 4),), t=4, seed=1, scale=1.5)[0]
    xb = jnp.asarray(x, jnp.bfloat16)
    # tau a Python float (weakly typed in JAX: the membrane stays bf16)
    jarg = targ = {"lif": (2.0,), "if": (), "eif": (2.0,)}[kind]
    jfn = getattr(jneuron, f"multistep_{kind}")
    tfn = getattr(tneuron, f"multistep_{kind}")
    want = jit_exact(lambda v: tuple(jfn(v, *jarg, detach_reset=True)), xb)
    got = tfn(torch.from_numpy(x).to(BF16), *targ, detach_reset=True)
    for g, wv in zip(got, want):
        assert g.dtype == BF16 and wv.dtype == jnp.bfloat16
        _within_one_ulp_of_the_largest(g.float().numpy(), _np(wv))
    assert 0 < float(got.spikes.float().mean()) < 1


@pytest.mark.parametrize("neuron", BF16_NEURONS)
def test_neck_matches_jax_at_bf16(neuron):
    chans, hws = (4, 8, 12, 16), ((16, 12), (8, 6), (4, 3), (4, 3))
    feats = [f.astype(np.float32) for f in _feats(chans, hws)]
    jm = jfpn.FPNNeck(chans, 8, neuron, dtype=jnp.bfloat16)
    pm = tfpn.FPNNeck(chans, 8, neuron, dtype=BF16)
    fb = [jnp.asarray(f, jnp.bfloat16) for f in feats]
    variables = load_port(jm, pm, fb, seed=1)
    want = jit_exact(jm.apply, variables, fb)
    with torch.no_grad():
        got = pm.eval()([to_torch(f).to(BF16) for f in feats])
    for g, w in zip(got, want):
        assert g.dtype == BF16 and w.dtype == jnp.bfloat16
        _within_one_ulp_of_the_largest(g.float().numpy(), _np(w))


PREDICT_CASES = {
    "fpn_sdtv3": ("fpn_sdtv3_512x512_10M_ade20k", ["model.T=2"]),
    "fpn_msresnet18": ("fpn_msresnet18_512x512_ade20k", []),
    "fpn_msresnet104": ("fpn_msresnet104_512x512_ade20k", []),
    "cascade": ("cascade_fpn_sdtv2_512x512_ade20k", ["model.T=2"]),
}


@pytest.mark.parametrize("case", sorted(PREDICT_CASES))
def test_predict_logits_match_jax_at_bf16(case):
    name, opts = PREDICT_CASES[case]
    jm, variables, pm = _pair(name, opts + OPT, seed=11)
    x = images((64, 48), b=2, seed=12)
    want = jit_exact(lambda v, xx: jm.apply(v, xx, method=jm.predict_logits),
                     variables, jnp.asarray(x))
    with torch.no_grad():
        got = pm.predict_logits(torch.from_numpy(x))
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    assert all(p.dtype == torch.float32 for p in pm.parameters())
    got, want = got.float().numpy(), _np(want)
    assert got.shape == (2, 64, 48, 5) and np.ptp(want) > 0.1
    _within_one_ulp_of_the_largest(got, want)
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= AGREEMENT


def _jax_step_exact(jm, variables, batch, keep):
    """One of JAX's FPN steps, compiled under ``EXACT_BF16``, dropping by
    ``keep``: (metrics, gradients)."""
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])
    tx = _recording(make_optimizer(params, warmup_iters=1))
    state = jtrain.TrainState(jnp.zeros((), jnp.int32), params, stats,
                              tx.init(params))
    step = jtrain.make_train_step_fpn(jm, tx, loss_decode=SPEC)

    def with_mask(state, imgs, sem, keep):
        with _given_dropout(keep):
            return step(state, imgs, sem)

    state, m = jit_exact(with_mask, state, jnp.asarray(batch[0]),
                         jnp.asarray(batch[1]), keep)
    return ({k: float(v) for k, v in m.items()},
            from_jax_variables({"params": state.opt_state[1]}))


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_train_step_matches_jax_at_bf16(case):
    name, opts = TRAIN_CASES[case]
    jm, variables, pm = _pair(name, opts + OPT, seed=17)
    batch = _seg_batch(0)
    masks = _jax_dropout_masks(jm, variables, batch[0], 1)
    want, wgrads = _jax_step_exact(jm, variables, batch, masks[0])
    got, ggrads, _ = _run_port_fpn(pm, [batch], masks)
    assert set(got[0]) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[0][k], w, rtol=LOSS_RTOL, err_msg=k)
    keys = sorted(wgrads)
    assert set(keys) <= set(ggrads[0])
    assert all(g.dtype == torch.float32 for g in ggrads[0].values())
    assert all(p.dtype == torch.float32 for p in pm.parameters())
    g = torch.cat([ggrads[0][k].reshape(-1) for k in keys])
    w = torch.cat([wgrads[k].float().reshape(-1) for k in keys])
    assert torch.isfinite(g).all()
    rel = float((g - w).norm() / w.norm())
    cos = float(torch.dot(g, w) / (g.norm() * w.norm()))
    assert rel <= GRAD_REL_L2 and cos >= GRAD_COS, (rel, cos)


def test_api_serves_and_trains_the_fpn_family_at_bf16():
    im = api.init_model("fpn_sdtv3_512x512_19M_ade20k",
                        overrides=TINY_FPN + OPT + ["model.T=2"],
                        device="cpu")
    img = np.random.default_rng(0).integers(0, 256, (70, 90, 3), np.uint8)
    pred = api.inference_model(im, img)
    assert pred.shape == (70, 90) and 0 <= pred.min() and pred.max() < 5
    tr = api.init_trainer("cascade_fpn_sdtv2_512x512_ade20k",
                          TINY_FPN + OPT + ["model.T=2"], device="cpu")
    m = api.train_steps(tr, [_seg_batch(4)])
    assert all(np.isfinite(v) for v in m[0].values())
    assert all(p.dtype == torch.float32
               for p in tr.state.model.parameters())
