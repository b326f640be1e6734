"""Port DCNv3 core and module against the JAX package.

The port's ``dcnv3_core`` (plain sampler on the CPU) is held to JAX
``dcnv3_core(impl="xla")`` and to the TPU kernel ``dcnv3_sample_pallas_t5``
run in Pallas interpret mode (patched exactly as tests/test_dcnv3.py does),
at atol 2e-5: the f32 tolerance of tests/test_dcnv3.py, where the two sides
sum the same products in another order.
"""
import sys
import os
import unittest.mock as mock

sys.path.insert(0, os.path.dirname(__file__))

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spike2former_tpu.models.dcn import DCNv3 as JaxDCNv3
from spike2former_tpu.ops import dcnv3_core as jax_dcnv3_core
from spike2former_tpu_torch.models.dcn import DCNv3
from spike2former_tpu_torch.ops import dcnv3

from torch_port_helpers import run_both, spikes

ATOL = 2e-5

# (n, h, w, g, gc, offset std, stride, pad, dilation)
CASES = [
    (2, 7, 9, 4, 8, 2.0, 1, 1, 1),     # taps leave the map
    (1, 6, 5, 2, 4, 0.0, 1, 1, 1),     # zero offsets: integer coordinates
    (2, 8, 6, 4, 2, 1.5, 2, 1, 1),     # stride 2
    (1, 9, 9, 2, 8, 1.0, 1, 2, 2),     # dilation 2
    (1, 5, 11, 8, 1, 4.0, 1, 1, 1),    # far off the map, Cg = 1
]


def _inputs(n, h, w, g, gc, std, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, h, w, g * gc)).astype(np.float32)
    # offsets for every input pixel; sliced to the output grid by the caller
    off = (rng.normal(size=(n, h, w, g * 18)) * std).astype(np.float32)
    mask = rng.uniform(0, 1, size=(n, h, w, g * 9)).astype(np.float32)
    return x, off, mask


def _kw(g, gc, stride, pad, dil):
    return dict(group=g, group_channels=gc, stride_h=stride, stride_w=stride,
                pad_h=pad, pad_w=pad, dilation_h=dil, dilation_w=dil)


def _out_hw(h, w, stride, pad, dil):
    return ((h + 2 * pad - 2 * dil - 1) // stride + 1,
            (w + 2 * pad - 2 * dil - 1) // stride + 1)


@pytest.mark.parametrize("case", CASES)
def test_dcnv3_core_matches_jax_xla(case):
    n, h, w, g, gc, std, stride, pad, dil = case
    x, off, mask = _inputs(n, h, w, g, gc, std)
    ho, wo = _out_hw(h, w, stride, pad, dil)
    off, mask = off[:, :ho, :wo], mask[:, :ho, :wo]
    kw = _kw(g, gc, stride, pad, dil)
    want = np.asarray(jax_dcnv3_core(jnp.asarray(x), jnp.asarray(off),
                                     jnp.asarray(mask), impl="xla", **kw))
    got = dcnv3.dcnv3_core(torch.from_numpy(x), torch.from_numpy(off),
                           torch.from_numpy(mask), **kw).numpy()
    assert got.shape == want.shape == (n, ho, wo, g * gc)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("case", CASES[:2])
def test_dcnv3_core_matches_pallas_t5_interpret(case):
    n, h, w, g, gc, std, *_ = case
    x, off, mask = _inputs(n, h, w, g, gc, std, seed=7)
    from jax.experimental import pallas as pl
    orig = pl.pallas_call

    def interp_call(*args, **kw):
        kw["interpret"] = True
        kw.pop("cost_estimate", None)
        return orig(*args, **kw)

    with mock.patch.object(pl, "pallas_call", interp_call):
        want = np.asarray(jax_dcnv3_core(
            jnp.asarray(x), jnp.asarray(off), jnp.asarray(mask),
            group=g, group_channels=gc, impl="pallas"))
    got = dcnv3.dcnv3_core(torch.from_numpy(x), torch.from_numpy(off),
                           torch.from_numpy(mask), group=g,
                           group_channels=gc).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-5)


def test_zero_offset_center_mask_is_identity():
    n, h, w, g, gc = 1, 6, 6, 2, 4
    x = np.random.default_rng(1).normal(size=(n, h, w, g * gc)).astype(
        np.float32)
    off = np.zeros((n, h, w, g * 18), np.float32)
    mask = np.zeros((n, h, w, g, 9), np.float32)
    mask[..., 4] = 1.0  # centre point in x-major order
    got = dcnv3.dcnv3_core(torch.from_numpy(x), torch.from_numpy(off),
                           torch.from_numpy(mask.reshape(n, h, w, -1)),
                           group=g, group_channels=gc).numpy()
    np.testing.assert_allclose(got, x, atol=1e-5)


def test_reference_sampler_integer_coordinates_use_floor_taps():
    """At an exact integer coordinate the floor tap carries weight 1 and the
    next tap weight 0, also on the last row/column of the map."""
    value = torch.arange(12.0).reshape(1, 3, 4, 1)
    py = torch.tensor([[[[0.0, 2.0, 2.0, -1.0, 3.0]]]])
    px = torch.tensor([[[[0.0, 3.0, 1.0, 0.0, 0.0]]]])
    mask = torch.tensor([[[[1.0, 10.0, 100.0, 1000.0, 1000.0]]]])
    out = dcnv3.dcnv3_sample_reference(value, py, px, mask)
    assert out.item() == 0.0 + 10 * 11.0 + 100 * 9.0


@pytest.mark.parametrize("compat", [False, True])
def test_dcnv3_module_matches_jax(compat):
    channels, group = 16, 4
    x = spikes((1, 2, 6, 7, channels), seed=3) * 3.0 - 0.5
    want, got = run_both(JaxDCNv3(channels=channels, group=group,
                                  compat=compat),
                         DCNv3(channels=channels, group=group,
                               compat=compat), x, seed=2)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_cpu_tensor_takes_plain_path_and_counts_nothing():
    x, off, mask = _inputs(1, 5, 5, 2, 4, 1.0)
    before = dcnv3.dcnv3_sample.launches
    dcnv3.dcnv3_core(torch.from_numpy(x), torch.from_numpy(off),
                     torch.from_numpy(mask), group=2, group_channels=4)
    assert dcnv3.dcnv3_sample.launches == before


# --- backward (K2) -----------------------------------------------------------
# Gradients at atol 3e-4 / rtol 1e-3, the tolerance of the JAX package's own
# backward-kernel test (tests/test_dcnv3.py:117-156): the coordinate
# gradients difference neighbouring taps, so f32 rounding of the taps shows
# at that level.

def _interpret():
    from jax.experimental import pallas as pl
    orig = pl.pallas_call

    def interp_call(*args, **kw):
        kw["interpret"] = True
        kw.pop("cost_estimate", None)
        return orig(*args, **kw)

    return mock.patch.object(pl, "pallas_call", interp_call)


def _sample_case(kind, n=2, h=6, w=7, g=2, cg=4, p=9, seed=0):
    """value, [N, HoWo, G, P] coordinates and mask, dout; ``kind``:
    'random' (taps leave the map), 'zero' (zero offsets: every coordinate
    an integer at its kernel point) or 'integer' (integer offsets)."""
    rng = np.random.default_rng(seed)
    value = rng.normal(size=(n, h, w, g * cg)).astype(np.float32)
    k = int(round(p ** 0.5))
    ii, jj = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    kx, ky = np.meshgrid(np.arange(k), np.arange(k), indexing="ij")
    by = ii.reshape(-1, 1) + ky.reshape(1, -1) - k // 2
    bx = jj.reshape(-1, 1) + kx.reshape(1, -1) - k // 2
    shape = (n, h * w, g, p)
    by = np.broadcast_to(by[None, :, None], shape).astype(np.float32)
    bx = np.broadcast_to(bx[None, :, None], shape).astype(np.float32)
    if kind == "random":
        py = by + 2.0 * rng.normal(size=shape)
        px = bx + 2.0 * rng.normal(size=shape)
    elif kind == "integer":
        py = by + rng.integers(-2, 3, shape)
        px = bx + rng.integers(-2, 3, shape)
    else:
        py, px = by, bx
    mask = rng.uniform(0.2, 1.0, shape)
    dout = rng.normal(size=(n, h * w, g * cg))
    return tuple(np.ascontiguousarray(a, np.float32)
                 for a in (value, py, px, mask, dout))


@pytest.mark.parametrize("kind", ["random", "zero", "integer"])
def test_backward_reference_matches_pallas_t5_bwd_interpret(kind):
    """The plain K2 against the TPU kernel ``dcnv3_sample_pallas_t5_bwd``
    in interpret mode, layouts converted."""
    from spike2former_tpu.ops.pallas.dcnv3_kernel import (
        dcnv3_sample_pallas_t5_bwd)

    value, py, px, mask, dout = _sample_case(kind)
    n, h, w, c = value.shape
    _, howo, g, p = py.shape
    cg = c // g
    feat = value.reshape(n, h, w, g, cg).transpose(0, 3, 1, 2, 4).reshape(
        n, g, h, w * cg)
    coords = [a.transpose(0, 2, 3, 1) for a in (py, px, mask)]
    dout_t = dout.reshape(n, howo, g, cg).transpose(0, 2, 3, 1)
    with _interpret():
        dfeat, dpy, dpx, dm = dcnv3_sample_pallas_t5_bwd(
            *(jnp.asarray(a) for a in (feat, *coords, dout_t)),
            num_points=p, h_in=h, w_in=w, group=g, group_channels=cg)
    want = (np.asarray(dfeat).reshape(n, g, h, w, cg).transpose(
                0, 2, 3, 1, 4).reshape(n, h, w, c),
            *(np.asarray(a).transpose(0, 3, 1, 2) for a in (dpy, dpx, dm)))
    got = dcnv3.dcnv3_sample_backward_reference(
        *(torch.from_numpy(a) for a in (value, py, px, mask, dout)))
    for name, gv, wv in zip(("dvalue", "dpy", "dpx", "dmask"), got, want):
        assert gv.shape == wv.shape, name
        np.testing.assert_allclose(gv.numpy(), wv, atol=3e-4, rtol=1e-3,
                                   err_msg=name)


def test_backward_reference_is_autograd_of_plain_sampler():
    value, py, px, mask, dout = (torch.from_numpy(a).requires_grad_()
                                 for a in _sample_case("random", seed=3))
    out = dcnv3.dcnv3_sample_reference(value, py, px, mask)
    want = torch.autograd.grad(out, (value, py, px, mask), dout)
    before = dcnv3.dcnv3_sample_backward.launches
    got = dcnv3.dcnv3_sample_backward(value.detach(), py.detach(),
                                      px.detach(), mask.detach(), dout)
    assert dcnv3.dcnv3_sample_backward.launches == before
    for gv, wv in zip(got, want):
        torch.testing.assert_close(gv, wv, atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("case", [CASES[0], CASES[1], CASES[2]])
def test_dcnv3_core_gradients_match_jax_xla(case):
    """Gradients to x, offset and mask of the port's ``dcnv3_core`` (the
    plain sampler's autograd on the CPU) against
    ``jax.grad(dcnv3_core(impl="xla"))``."""
    import jax

    n, h, w, g, gc, std, stride, pad, dil = case
    x, off, mask = _inputs(n, h, w, g, gc, std, seed=4)
    ho, wo = _out_hw(h, w, stride, pad, dil)
    off, mask = off[:, :ho, :wo], mask[:, :ho, :wo]
    cot = np.random.default_rng(5).normal(
        size=(n, ho, wo, g * gc)).astype(np.float32)
    kw = _kw(g, gc, stride, pad, dil)

    def loss(xx, oo, mm):
        return jnp.sum(jax_dcnv3_core(xx, oo, mm, impl="xla", **kw)
                       * jnp.asarray(cot))

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(off), jnp.asarray(mask))
    ts = [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_()
          for a in (x, off, mask)]
    (dcnv3.dcnv3_core(*ts, **kw) * torch.from_numpy(cot)).sum().backward()
    for name, t, wv in zip(("dx", "doffset", "dmask"), ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(wv),
                                   atol=3e-4, rtol=1e-3, err_msg=name)
