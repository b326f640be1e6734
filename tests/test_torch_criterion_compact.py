"""The port's ``compact_gt`` fast path and the auction matcher inside
``maskformer_loss``, against the port at full width and against the JAX
package, on tests/test_losses.py's compact-GT inputs (2 images, 10 queries,
8 GT slots cut to 4, 16x16 mask logits, 32x32 GT) in both branches: valid
slots inside the compact prefix, and one past it (the full-width branch).

Tolerances: compact against full width, the losses within 1e-6 relative
(the same terms, summed over a shorter GT axis) and the gradients within
rtol 1e-5 / atol 1e-6; against JAX, tests/test_torch_losses.py's 1e-5
relative on the losses.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spike2former_tpu.losses import criterion as jcrit
from spike2former_tpu_torch.losses import criterion

B, NQ, G, GC, HW, NUM_CLASSES = 2, 10, 8, 4, 16, 6


def _inputs(branch):
    rng = np.random.default_rng(21)
    cls = rng.normal(size=(1, B, NQ, 7)).astype(np.float32)
    masks = rng.normal(size=(1, B, NQ, HW, HW)).astype(np.float32)
    labels = rng.integers(0, NUM_CLASSES, (B, G)).astype(np.int32)
    valid = np.zeros((B, G), bool)
    valid[:, :3] = True
    smap = rng.integers(0, 3, size=(B, 2 * HW, 2 * HW)).astype(np.int32)
    smap[:, :4] = G  # some pixels in no slot
    if branch == "overflow":
        valid[0, GC + 1] = True
        smap[0, 5:7] = GC + 1
    return cls, masks, labels, valid, smap


def _port_loss(cls, masks, labels, valid, smap, compact_gt, matcher="auction"):
    c = torch.from_numpy(cls).requires_grad_()
    m = torch.from_numpy(masks).requires_grad_()
    gt = criterion.GroundTruth(
        labels=torch.from_numpy(labels).long(),
        valid=torch.from_numpy(valid),
        dropped=torch.zeros(B, dtype=torch.long),
        slot_map=torch.from_numpy(smap).long())
    out = criterion.maskformer_loss(c, m, gt, num_classes=NUM_CLASSES,
                                    matcher=matcher, loss_at="gt",
                                    compact_gt=compact_gt)
    out["total"].backward()
    return ({k: float(v.detach()) for k, v in out.items()}, c.grad.numpy(),
            m.grad.numpy())


@pytest.mark.parametrize("branch", ["compact", "overflow"])
def test_compact_gt_equals_full_width(branch):
    full, gc_full, gm_full = _port_loss(*_inputs(branch), compact_gt=None)
    small, gc_small, gm_small = _port_loss(*_inputs(branch), compact_gt=GC)
    assert set(small) == set(full)
    for k in full:
        np.testing.assert_allclose(small[k], full[k], rtol=1e-6, atol=0,
                                   err_msg=k)
    assert full["total"] > 0
    np.testing.assert_allclose(gc_small, gc_full, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gm_small, gm_full, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("branch", ["compact", "overflow"])
def test_compact_gt_is_not_applied_to_the_host_matcher(branch, monkeypatch):
    """As in JAX, only the auction matcher cuts the GT axis: the host
    matcher always sees all G columns."""
    widths = []
    real = criterion.hungarian_host

    def spy(costs):
        widths.append(costs.shape[-1])
        return real(costs)

    monkeypatch.setattr(criterion, "hungarian_host", spy)
    _port_loss(*_inputs(branch), compact_gt=GC, matcher="host")
    assert widths == [G]


@pytest.mark.parametrize("branch", ["compact", "overflow"])
def test_auction_compact_loss_matches_jax(branch):
    cls, masks, labels, valid, smap = _inputs(branch)
    gt = jcrit.GroundTruth(jnp.asarray(labels), None, jnp.asarray(valid),
                           slot_map=jnp.asarray(smap))
    want = jcrit.maskformer_loss(jnp.asarray(cls), jnp.asarray(masks), gt,
                                 num_classes=NUM_CLASSES, matcher="auction",
                                 loss_at="gt", compact_gt=GC)
    got, _, _ = _port_loss(cls, masks, labels, valid, smap, compact_gt=GC)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
