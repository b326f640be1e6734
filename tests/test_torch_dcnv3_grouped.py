"""The grouped-layout sampler family K3-K7 against the JAX package.

Each TPU kernel of ``spike2former_tpu/ops/pallas/dcnv3_kernel.py`` that no
model path calls (``dcnv3_sample_pallas_t``, ``_pallas``, ``_pallas_t4``,
``_pallas_tg`` and ``_pallas_t_bwd``) runs in Pallas interpret mode,
patched as tests/test_dcnv3.py does, and its counterpart in
``spike2former_tpu_torch/ops/dcnv3_grouped.py`` takes the plain path on
the CPU on the same numpy inputs.  Tolerances are tests/test_dcnv3.py's:
atol 2e-5 / rtol 1e-5 for the forward, where the two sides sum the same
products in another order, and atol 3e-4 / rtol 1e-3 for the gradients,
where the coordinate gradients difference neighbouring taps.
"""
import unittest.mock as mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spike2former_tpu.ops.pallas import dcnv3_kernel
from spike2former_tpu_torch.ops import dcnv3_grouped
from spike2former_tpu_torch.ops.dcnv3_grouped import (
    JAX_COUNTERPARTS, dcnv3_sample_grouped, dcnv3_sample_grouped_backward)

FWD_ATOL, FWD_RTOL = 2e-5, 1e-5
BWD_ATOL, BWD_RTOL = 3e-4, 1e-3

FORWARD = ("dcnv3_sample_pallas_t", "dcnv3_sample_pallas",
           "dcnv3_sample_pallas_t4", "dcnv3_sample_pallas_tg")
BACKWARD = "dcnv3_sample_pallas_t_bwd"

# name: (n, g, h, w, cg, p, howo, coordinates)
CASES = {
    "off_map": (1, 2, 5, 6, 4, 9, 30, "uniform"),
    "zero_offsets": (1, 2, 5, 6, 4, 9, 30, "integer"),
    "cg1": (1, 2, 5, 6, 1, 9, 30, "uniform"),
    "cg8": (1, 2, 5, 6, 8, 9, 30, "uniform"),
    "odd_howo": (1, 2, 5, 6, 4, 9, 37, "uniform"),
    "n2_g2": (2, 2, 6, 7, 4, 9, 42, "uniform"),
    # JAX tiles HoWo into two tiles here: K6 and K7 at Cg = 8, and K3 and
    # K5 too at Cg = 16; K7 then carries dfeat from one tile to the next
    "tiled_cg8": (1, 1, 4, 32, 8, 9, 2048, "uniform"),
    "tiled_cg16": (1, 1, 4, 32, 16, 9, 2048, "uniform"),
}


def _case(name, seed=0):
    """feat [N, G, H, W*Cg], py/px/mask [N, G, P, HoWo], dout
    [N, G, Cg, HoWo] as f32 numpy arrays, and the static arguments.
    'uniform' coordinates reach up to 3 pixels past every edge, so some
    taps and whole points leave the map; 'integer' ones are exact integers
    from -1 to H (zero offsets put every coordinate on one)."""
    n, g, h, w, cg, p, howo, coords = CASES[name]
    rng = np.random.default_rng(seed)
    shape = (n, g, p, howo)
    feat = rng.normal(size=(n, g, h, w * cg))
    if coords == "uniform":
        py = rng.uniform(-3, h + 2, shape)
        px = rng.uniform(-3, w + 2, shape)
    else:
        py = rng.integers(-1, h + 1, shape)
        px = rng.integers(-1, w + 1, shape)
    mask = rng.uniform(0.2, 1.0, shape)
    dout = rng.normal(size=(n, g, cg, howo))
    arrays = tuple(np.ascontiguousarray(a, np.float32)
                   for a in (feat, py, px, mask, dout))
    return arrays, dict(num_points=p, h_in=h, w_in=w, group=g,
                        group_channels=cg)


def _interpret():
    from jax.experimental import pallas as pl
    orig = pl.pallas_call

    def interp_call(*args, **kw):
        kw["interpret"] = True
        kw.pop("cost_estimate", None)
        return orig(*args, **kw)

    return mock.patch.object(pl, "pallas_call", interp_call)


def _jax(name, arrays, static):
    with _interpret():
        out = getattr(dcnv3_kernel, name)(
            *(jnp.asarray(a) for a in arrays), **static)
    return tuple(np.asarray(o) for o in out) if isinstance(out, tuple) \
        else np.asarray(out)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("name", FORWARD)
def test_forward_matches_pallas_interpret(name, case):
    (feat, py, px, mask, _), static = _case(case)
    want = _jax(name, (feat, py, px, mask), static)
    got = JAX_COUNTERPARTS[name](
        *(torch.from_numpy(a) for a in (feat, py, px, mask)), **static)
    assert got.shape == want.shape
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, atol=FWD_ATOL,
                               rtol=FWD_RTOL)


@pytest.mark.parametrize("case", CASES)
def test_backward_matches_pallas_t_bwd_interpret(case):
    arrays, static = _case(case, seed=1)
    want = _jax(BACKWARD, arrays, static)
    got = JAX_COUNTERPARTS[BACKWARD](
        *(torch.from_numpy(a) for a in arrays), **static)
    for name, gv, wv in zip(("dfeat", "dpy", "dpx", "dmask"), got, want):
        assert gv.shape == wv.shape, name
        assert gv.dtype == torch.float32, name
        assert np.abs(wv).max() > 0.1, name
        np.testing.assert_allclose(gv.numpy(), wv, atol=BWD_ATOL,
                                   rtol=BWD_RTOL, err_msg=name)


@pytest.mark.parametrize("case", ["off_map", "zero_offsets", "tiled_cg8"])
@pytest.mark.parametrize("layout", ["gchw", "ghwc"])
def test_autograd_matches_pallas_t_bwd_interpret(layout, case):
    """Autograd of the forward in K3's layout (gchw) and K4's (ghwc)
    against K7, the JAX backward, fed the same cotangent in K3's
    layout."""
    (feat, py, px, mask, dout), static = _case(case, seed=2)
    want = _jax(BACKWARD, (feat, py, px, mask, dout), static)
    ins = [torch.from_numpy(a).requires_grad_()
           for a in (feat, py, px, mask)]
    out = dcnv3_sample_grouped(*ins, **static, out_layout=layout)
    cot = torch.from_numpy(dout)
    if layout == "ghwc":
        cot = cot.transpose(2, 3)
    got = torch.autograd.grad(out, ins, cot)
    for name, gv, wv in zip(("dfeat", "dpy", "dpx", "dmask"), got, want):
        np.testing.assert_allclose(gv.numpy(), wv, atol=BWD_ATOL,
                                   rtol=BWD_RTOL, err_msg=name)


def test_layouts_are_transposes_and_cpu_counts_no_launch():
    (feat, py, px, mask, _), static = _case("n2_g2")
    ins = [torch.from_numpy(a) for a in (feat, py, px, mask)]
    before = (dcnv3_sample_grouped.launches,
              dcnv3_sample_grouped_backward.launches)
    gchw = dcnv3_sample_grouped(*ins, **static, out_layout="gchw")
    ghwc = dcnv3_sample_grouped(*ins, **static, out_layout="ghwc")
    assert torch.equal(gchw.transpose(2, 3), ghwc)
    assert (dcnv3_sample_grouped.launches,
            dcnv3_sample_grouped_backward.launches) == before


def test_every_tpu_kernel_of_the_family_has_a_counterpart():
    for name in (*FORWARD, BACKWARD):
        assert callable(getattr(dcnv3_kernel, name))
        assert name in JAX_COUNTERPARTS


def _bad_calls(feat, py, static):
    """(exception, call) pairs, each with one argument the functions do
    not take."""
    fwd = dcnv3_grouped.dcnv3_sample_grouped
    bwd = dcnv3_grouped.dcnv3_sample_grouped_backward
    dout = torch.zeros((1, 2, 4, 30))
    odd = torch.zeros(py.numel() + 1)[1:].view(py.shape)
    return [
        (ValueError, lambda: fwd(feat, py, py, py, **static,
                                 out_layout="hwc")),
        (ValueError, lambda: fwd(feat, py, py, py,
                                 **{**static, "group_channels": 3},
                                 out_layout="gchw")),
        (ValueError, lambda: fwd(feat, py, py, py,
                                 **{**static, "h_in": 4},
                                 out_layout="gchw")),
        (ValueError, lambda: fwd(feat, py, py[..., :29].contiguous(), py,
                                 **static, out_layout="gchw")),
        (ValueError, lambda: bwd(feat, py, py, py, dout[..., :29], **static)),
        (TypeError, lambda: fwd(feat.double(), py, py, py, **static,
                                out_layout="gchw")),
        (TypeError, lambda: bwd(feat, py, py, py, dout.half(), **static)),
        (ValueError, lambda: fwd(feat, py, py.transpose(2, 3).contiguous()
                                 .transpose(2, 3), py, **static,
                                 out_layout="gchw")),
        (ValueError, lambda: fwd(feat, py, py, odd, **static,
                                 out_layout="gchw")),
    ]


def test_rejects_what_the_kernels_do_not_take():
    """The plain path checks its arguments as the card path does, so a
    call that passes on the CPU passes on the card: shapes against the
    static arguments, f32, Cg in {1, 2, 4, 8, 16, 32}, contiguous and
    16-byte aligned tensors."""
    (feat, py, *_), static = _case("off_map")
    for exc, call in _bad_calls(torch.from_numpy(feat),
                                torch.from_numpy(py), static):
        with pytest.raises(exc):
            call()
