"""Packed spike residuals (``ops/spike_op.py``, ``train.packed_residuals``)
against the JAX package's ``ops/spike_op.py`` and against the port's own
unpacked path.

* ``pack_codes`` gives JAX's bytes (the half-split nibble pairing) and
  ``unpack_codes`` inverts it;
* the packed conv and dense layers are bit-identical to the plain ones in
  outputs and gradients, and so is a whole train step of the tiny model:
  metrics, gradients and every parameter and BN statistic after it, in
  float32 and in bfloat16 (JAX's ``tests/test_spike_op.py:98-170``
  property);
* a packed site saves only ``uint8`` tensors for the backward.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spike2former_tpu.ops import spike_op as jspike_op
from spike2former_tpu_torch import api
from spike2former_tpu_torch.data.synthetic import synthetic_batch
from spike2former_tpu_torch.models import layers as tl
from spike2former_tpu_torch.ops import spike_op

from torch_port_helpers import TINY, spikes

PRESET = "SDTv2_maskformer_DCNpixelDecoder_ade20k"
DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("shape", [(7,), (4, 5), (2, 3, 3), (16,)])
def test_pack_codes_gives_jax_bytes(shape):
    k = np.random.default_rng(0).integers(0, 16, shape).astype(np.uint8)
    want = np.asarray(jspike_op.pack_codes(jnp.asarray(k)))
    got = spike_op.pack_codes(torch.from_numpy(k))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        spike_op.unpack_codes(got, shape).numpy(), k)


# (conv factory, input channels): a 3x3 conv with bias, a depthwise 7x7, a
# strided one and a 1x1 without bias
CONVS = {
    "3x3_bias": (lambda dt: tl.conv2d(8, 12, 3, pad=1, bias=True, dtype=dt,
                                      spike_input=True), 8),
    "dw7x7": (lambda dt: tl.conv2d(8, 8, 7, pad=3, groups=8, dtype=dt,
                                   spike_input=True), 8),
    "3x3_s2": (lambda dt: tl.conv2d(8, 6, 3, stride=2, pad=1, bias=True,
                                    dtype=dt, spike_input=True), 8),
    "1x1": (lambda dt: tl.conv2d(8, 16, 1, dtype=dt, spike_input=True), 8),
}


def _site_grads(site, x, packed):
    """Output and gradients of ``site`` (a conv or dense layer) on spikes
    ``x``, packed or not; the tensors it saved for the backward."""
    torch.manual_seed(0)
    for p in site.parameters():
        p.grad = None
    site.packed = packed
    xx = x.clone().requires_grad_()
    saved = []

    def pack(t):
        saved.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = (tl.conv_nhwc(site, xx) if isinstance(site, tl.Conv2d)
               else site(xx))
    g = torch.from_numpy(np.random.default_rng(1).normal(
        size=out.shape)).to(out.dtype)
    out.backward(g)
    return ([out.detach(), xx.grad] + [p.grad for p in site.parameters()],
            saved)


def _check_site(site, x):
    plain, _ = _site_grads(site, x, False)
    packed, saved = _site_grads(site, x, True)
    for a, b in zip(plain, packed):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert saved and all(t.dtype == torch.uint8 for t in saved), [
        t.dtype for t in saved]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(CONVS))
def test_packed_conv_is_the_plain_conv(name, dtype):
    make, cin = CONVS[name]
    site = make(dtype)
    x = torch.from_numpy(spikes((2, 9, 10, cin), seed=2))
    _check_site(site, x.to(dtype))
    _check_site(site, x)      # f32 spikes into a conv computing in dtype


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 5, 16), (2, 3, 4, 16), (7, 16)])
def test_packed_linear_is_the_plain_linear(shape, dtype):
    site = tl.Linear(16, 24, dtype=dtype, spike_input=True)
    x = torch.from_numpy(spikes(shape, seed=3))
    _check_site(site, x.to(dtype))
    nobias = tl.Linear(16, 8, bias=False, dtype=dtype, spike_input=True)
    _check_site(nobias, x)


def _one_step(dtype, packed):
    opts = [f"model.{k}={v!r}".replace(" ", "") for k, v in TINY.items()]
    opts += ["train.warmup_iters=1", f"model.dtype='{dtype}'",
             f"train.packed_residuals={packed}"]
    tr = api.init_trainer(PRESET, opts, device="cpu", seed=1)
    packed_sites = [m for m in tr.state.model.modules()
                    if getattr(m, "packed", False)]
    assert bool(packed_sites) == packed
    batch = synthetic_batch(np.random.default_rng(2), 2, (64, 64),
                            num_classes=4)
    metrics = api.train_steps(tr, [batch])[0]
    model = tr.state.model
    return (metrics, {k: p.grad.clone() for k, p in model.named_parameters()},
            {k: v.clone() for k, v in model.state_dict().items()})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_residuals_change_no_number_of_a_train_step(dtype):
    m0, g0, s0 = _one_step(dtype, False)
    m1, g1, s1 = _one_step(dtype, True)
    assert m0 == m1
    assert set(g0) == set(g1) and set(s0) == set(s1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k
