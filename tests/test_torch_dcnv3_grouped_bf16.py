"""The bf16 forms of the grouped-layout sampler family K3-K7 against the
JAX package.

Each TPU kernel of ``spike2former_tpu/ops/pallas/dcnv3_kernel.py`` that no
model path calls (``dcnv3_sample_pallas_t``, ``_pallas``, ``_pallas_t4``,
``_pallas_tg`` and ``_pallas_t_bwd``) runs on bf16 features (f32
coordinates and mask) in Pallas interpret mode, patched as
tests/test_dcnv3.py does, and its counterpart in
``spike2former_tpu_torch/ops/dcnv3_grouped.py`` takes the plain path on
the CPU on the same inputs (the features and dout rounded to bf16 on both
sides).

The port rounds where the JAX kernels round (the row weights, K3's and
K6's column weights, each map column's sum, then the output; K7's row
weights in dpx alone, its dfeat once at the end), so:

* the forwards and dfeat are held element by element to one bf16 ulp of
  JAX's (the ulp of max(|JAX's element|, 1e-2)): the two sides add the
  same f32 terms and may differ only in the order of the f32 sums.
  Measured on these cases: bit-equal.  Rounding the output once instead
  (the f32 sum cast at the end) or not rounding K3's column weights puts
  a quarter to a third of the elements of ``n2_g2`` beyond one ulp, up to
  72 ulps;
* dpy, dpx and dmask (f32) are held to ``GRAD_TOL`` of their largest
  magnitude: f32 sums of the same products in another order (measured
  2.3e-7).
"""
import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spike2former_tpu.ops.pallas import dcnv3_kernel
from spike2former_tpu_torch.ops.dcnv3_grouped import (
    JAX_COUNTERPARTS, dcnv3_sample_grouped, dcnv3_sample_grouped_backward)

from test_torch_dcnv3_grouped import BACKWARD, FORWARD, _case, _interpret

GRAD_TOL = 1e-5     # dpy, dpx, dmask: of the largest magnitude

# a subset of test_torch_dcnv3_grouped.CASES: taps off the map, exact
# integer coordinates, Cg = 1 and 8, two images and groups, the shape at
# which JAX tiles HoWo (K6 and K7 carry state from tile to tile), and 4
# and 25 points (the CUDA forward sorts up to 9 points' taps in registers
# and walks more point by point; on the card it is held to the plain
# version at those P)
CASES = ("off_map", "zero_offsets", "cg1", "cg8", "n2_g2", "tiled_cg8",
         "p4", "p25")


def _bf16(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bf16, as f32."""
    return torch.from_numpy(a).bfloat16().float().numpy()


def _inputs(case, seed):
    (feat, py, px, mask, dout), static = _case(case, seed)
    return (_bf16(feat), py, px, mask, _bf16(dout)), static


def _jax(name, arrays, static):
    """The JAX kernel ``name`` on bf16 features (and dout), f32 out."""
    feat, py, px, mask, *dout = arrays
    args = [jnp.asarray(feat, jnp.bfloat16), *(jnp.asarray(a) for a in
                                                (py, px, mask))]
    args += [jnp.asarray(d, jnp.bfloat16) for d in dout]
    with _interpret():
        out = getattr(dcnv3_kernel, name)(*args, **static)
    outs = out if isinstance(out, tuple) else (out,)
    return [np.asarray(o.astype(jnp.float32)) for o in outs], \
        [o.dtype for o in outs]


def _port(fn, arrays, static, **kw):
    feat, py, px, mask, *dout = arrays
    args = [torch.from_numpy(feat).bfloat16(),
            *(torch.from_numpy(a) for a in (py, px, mask))]
    args += [torch.from_numpy(d).bfloat16() for d in dout]
    out = fn(*args, **static, **kw)
    return out if isinstance(out, tuple) else (out,)


def _assert_within_one_ulp(got: np.ndarray, want: np.ndarray, what: str):
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-2))) - 7)
    err = np.abs(got - want)
    assert (err <= ulp).all(), (what, float((err / ulp).max()),
                                int((err > ulp).sum()))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("name", FORWARD)
def test_bf16_forward_matches_pallas_interpret(name, case):
    arrays, static = _inputs(case, 0)
    (want,), (dtype,) = _jax(name, arrays[:4], static)
    (got,) = _port(JAX_COUNTERPARTS[name], arrays[:4], static)
    assert dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    assert got.shape == want.shape
    assert np.abs(want).max() > 0.1
    _assert_within_one_ulp(got.float().numpy(), want, name)


@pytest.mark.parametrize("case", CASES)
def test_bf16_backward_matches_pallas_t_bwd_interpret(case):
    arrays, static = _inputs(case, 1)
    want, dtypes = _jax(BACKWARD, arrays, static)
    got = _port(JAX_COUNTERPARTS[BACKWARD], arrays, static)
    assert dtypes[0] == jnp.bfloat16 and got[0].dtype == torch.bfloat16
    for name, gv, wv in zip(("dfeat", "dpy", "dpx", "dmask"), got, want):
        assert gv.shape == wv.shape, name
        assert np.abs(wv).max() > 0.1, name
        gv = gv.float().numpy()
        if name == "dfeat":
            _assert_within_one_ulp(gv, wv, name)
        else:
            assert gv.dtype == np.float32, name
            err = np.abs(gv - wv).max()
            assert err <= GRAD_TOL * np.abs(wv).max(), (name, err)


def test_bf16_rounding_points_are_load_bearing():
    """The rounded forms are not the f32 sum rounded once: K3 (columns
    rounded) and K5 (not) differ from each other and from the f32 sum
    cast to bf16, and K7's bf16 dpx differs from the f32 formula's."""
    arrays, static = _inputs("n2_g2", 0)
    k3, k5 = (_port(JAX_COUNTERPARTS[name], arrays[:4], static)[0].float()
              for name in ("dcnv3_sample_pallas_t", "dcnv3_sample_pallas_t4"))
    f32 = dcnv3_sample_grouped(
        *(torch.from_numpy(a) for a in arrays[:4]), **static,
        out_layout="gchw").bfloat16().float()
    assert not torch.equal(k3, k5)
    assert not torch.equal(k3, f32) and not torch.equal(k5, f32)
    bf16 = _port(dcnv3_sample_grouped_backward, arrays, static)
    f32b = dcnv3_sample_grouped_backward(
        *(torch.from_numpy(a) for a in arrays), **static)
    assert torch.equal(bf16[0].float(), f32b[0].bfloat16().float())
    assert torch.allclose(bf16[1], f32b[1], rtol=1e-5, atol=1e-5)
    assert (bf16[2] - f32b[2]).abs().max() > 1e-4


def test_bf16_checks_dtypes_and_counts_no_cpu_launch():
    arrays, static = _inputs("off_map", 0)
    feat, py, px, mask, dout = (torch.from_numpy(a) for a in arrays)
    before = (dcnv3_sample_grouped.bf16_launches,
              dcnv3_sample_grouped_backward.bf16_launches)
    with pytest.raises(TypeError, match="py must be torch.float32"):
        dcnv3_sample_grouped(feat.bfloat16(), py.bfloat16(), px, mask,
                             **static, out_layout="gchw")
    with pytest.raises(TypeError, match="dout must be torch.bfloat16"):
        dcnv3_sample_grouped_backward(feat.bfloat16(), py, px, mask, dout,
                                      **static)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        dcnv3_sample_grouped(feat.half(), py, px, mask, **static,
                             out_layout="gchw")
    out = dcnv3_sample_grouped(feat.bfloat16(), py, px, mask, **static,
                               out_layout="ghwc")
    assert out.dtype == torch.bfloat16
    assert (dcnv3_sample_grouped.bf16_launches,
            dcnv3_sample_grouped_backward.bf16_launches) == before
