"""The port's pixel-loss zoo (``spike2former_tpu_torch/losses/pixel.py``)
against the JAX package's ``losses/pixel.py`` on the CPU: each loss's value
and its gradient to the logits, on seeded logits with ignore pixels, at
the label map's resolution and at half of it (the bilinear resize to the
labels), with tied errors for the Lovász sorts; ``edt_sq`` also against
``scipy.ndimage.distance_transform_edt``.

Tolerances: values within 1e-5 relative (1e-6 absolute), gradients within
1e-6 absolute plus 1e-4 relative (float32 sums in another order); the
accuracy, ``edt_sq`` and the sorted orders exactly.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from spike2former_tpu.losses import pixel as jp
from spike2former_tpu_torch.losses import pixel as pp

K = 5
VALUE_RTOL, VALUE_ATOL = 1e-5, 1e-6
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4


def _case(seed=0, b=2, hw=(12, 10), half=False, ties=False, k=K):
    """logits [B, h, w, k] (h, w halved with ``half``) and labels [B, H, W]
    with a block of ignore pixels; ``ties``: a band of pixels whose two
    top logits are equal (probability 1/2 each) and labelled with either,
    so the Lovász errors tie across foreground and background."""
    rng = np.random.default_rng(seed)
    h, w = hw
    lh, lw = (h // 2, w // 2) if half else (h, w)
    logits = rng.normal(0.0, 2.0, (b, lh, lw, k)).astype(np.float32)
    sem = rng.integers(0, k, (b, h, w)).astype(np.int32)
    sem[0, :2, :3] = 255
    sem[-1, -1, :] = 255
    if ties:
        logits[:, 3:6] = -20.0
        logits[:, 3:6, :, :2] = 0.0
        sem[:, 3:6] = rng.integers(0, 2, (b, 3, w))
    return logits, sem


def _both(jfn, pfn, logits, sem):
    """(value, d value / d logits) of JAX and the port."""
    wv, wg = jax.jit(jax.value_and_grad(jfn))(jnp.asarray(logits),
                                              jnp.asarray(sem))
    lt = torch.tensor(logits, requires_grad=True)
    gv = pfn(lt, torch.from_numpy(sem))
    gv.backward()
    return (float(wv), np.asarray(wg)), (float(gv.detach()),
                                         lt.grad.numpy())


def _check(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=VALUE_RTOL,
                               atol=VALUE_ATOL)
    np.testing.assert_allclose(got[1], want[1], atol=GRAD_ATOL,
                               rtol=GRAD_RTOL)
    assert np.abs(want[1]).max() > 0


LOSSES = {
    "ce": {},
    "lovasz": {},
    "lovasz_all": dict(classes="all"),
    "lovasz_per_image": dict(per_image=True),
    "lovasz_weighted": dict(class_weight=[1.0, 0.5, 2.0, 1.0, 0.3]),
    "tversky": {},
    "tversky_weighted": dict(alpha=0.5, beta=0.5, smooth=0.5,
                             class_weight=[1.0, 0.5, 2.0, 1.0, 0.3]),
    "ohem": dict(min_kept=40, thresh=0.7),
    "ohem_default": {},
    "ohem_weighted": dict(min_kept=10, thresh=0.3,
                          class_weight=[1.0, 0.5, 2.0, 1.0, 0.3]),
    "hausdorff": {},
    "hausdorff_weighted": dict(class_weight=[1.0, 0.5, 2.0, 1.0, 0.3]),
}


@pytest.mark.parametrize("half", [False, True])
@pytest.mark.parametrize("name", sorted(LOSSES))
def test_pixel_loss_and_gradient_match_jax(name, half):
    base = name.split("_")[0]
    kw = LOSSES[name]
    logits, sem = _case(sorted(LOSSES).index(name), half=half)
    want, got = _both(
        lambda lg, s: jp.PIXEL_LOSSES[base](lg, s, **kw),
        lambda lg, s: pp.PIXEL_LOSSES[base](lg, s, **kw), logits, sem)
    _check(got, want)


@pytest.mark.parametrize("kw", [{}, dict(classes="all"),
                                dict(per_image=True)],
                         ids=["present", "all", "per_image"])
def test_lovasz_softmax_with_tied_errors_matches_jax(kw):
    logits, sem = _case(5, ties=True)
    probs = jax.nn.softmax(jnp.asarray(logits[0, 3:6]), -1)
    assert float(probs[..., 0].min()) == float(probs[..., 0].max()) == 0.5
    want, got = _both(lambda lg, s: jp.lovasz_softmax_loss(lg, s, **kw),
                      lambda lg, s: pp.lovasz_softmax_loss(lg, s, **kw),
                      logits, sem)
    _check(got, want)


@pytest.mark.parametrize("per_image", [False, True])
def test_lovasz_hinge_matches_jax(per_image):
    rng = np.random.default_rng(7)
    logits = rng.normal(0.0, 1.5, (2, 9, 11)).astype(np.float32)
    logits[:, 2:4] = 0.25                     # tied errors
    labels = rng.integers(0, 2, (2, 9, 11)).astype(np.int32)
    labels[0, 0] = 255
    want, got = _both(
        lambda lg, s: jp.lovasz_hinge_loss(lg, s, per_image=per_image),
        lambda lg, s: pp.lovasz_hinge_loss(lg, s, per_image=per_image),
        logits, labels)
    _check(got, want)


def test_boundary_loss_matches_jax_also_at_zero_logits():
    rng = np.random.default_rng(8)
    logits = rng.normal(0.0, 2.0, (2, 8, 9, 1)).astype(np.float32)
    logits[0, 0] = 0.0                        # |x|'s slope at 0 is JAX's
    gt = (rng.random((2, 8, 9)) < 0.2).astype(np.float32)
    gt[1, 0, 0] = 0.5                         # neither class: weight 0
    want, got = _both(jp.boundary_loss, pp.boundary_loss, logits, gt)
    _check(got, want)


@pytest.mark.parametrize("half", [False, True])
def test_pixel_accuracy_matches_jax(half):
    logits, sem = _case(9, half=half)
    want = float(jp.pixel_accuracy(jnp.asarray(logits), jnp.asarray(sem)))
    got = float(pp.pixel_accuracy(torch.from_numpy(logits),
                                  torch.from_numpy(sem)))
    assert got == pytest.approx(want, abs=1e-7) and 0 < got < 1


def test_composite_spec_matches_jax_and_names_its_terms():
    spec = (("ce", 1.0), ("lovasz", 0.5),
            ("ohem", 0.4, {"thresh": 0.7, "min_kept": 64}),
            ("tversky", 0.3), ("hausdorff", 0.2, {}))
    logits, sem = _case(10, half=True)
    jfn, pfn = jp.build_pixel_loss(spec), pp.build_pixel_loss(spec)
    want, got = _both(lambda lg, s: jfn(lg, s)[0],
                      lambda lg, s: pfn(lg, s)[0], logits, sem)
    _check(got, want)
    _, wm = jfn(jnp.asarray(logits), jnp.asarray(sem))
    _, gm = pfn(torch.from_numpy(logits), torch.from_numpy(sem))
    assert list(gm) == list(wm) == [f"loss_{n[0]}" for n in spec]
    for k in wm:
        assert float(gm[k]) == pytest.approx(float(wm[k]), rel=VALUE_RTOL)
    with pytest.raises(KeyError, match="unknown pixel loss"):
        pp.build_pixel_loss((("boundary", 1.0),))


def _masks():
    rng = np.random.default_rng(11)
    m = (rng.random((3, 17, 23)) < 0.8).astype(np.int32)
    m[1, :, 5] = 1                 # a column with no background
    m[1, 4] = 1                    # a row with no background
    m[2] = 3                       # one background pixel, far away
    m[2, 0, 0] = 0
    return m


def test_edt_sq_equals_jax_and_scipy():
    m = _masks()
    want = np.asarray(jp.edt_sq(jnp.asarray(m), chunk=8))
    got = pp.edt_sq(torch.from_numpy(m), chunk=8).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, pp.edt_sq(torch.from_numpy(m), chunk=128).numpy())
    for img in m:
        ref = ndimage.distance_transform_edt(img != 0) ** 2
        np.testing.assert_allclose(pp.edt_sq(torch.from_numpy(img)).numpy(),
                                   ref, rtol=1e-6)
    m[0] = 1                                  # nothing in reach
    np.testing.assert_array_equal(
        pp.edt_sq(torch.from_numpy(m)).numpy(),
        np.asarray(jp.edt_sq(jnp.asarray(m))))
