"""Port losses, matcher, GT slots, nearest resize and optimizer against the
JAX package, on the same seeded numpy inputs.

Tolerances: integer outputs (slot maps, labels, assignments, nearest
resize) exact; loss values 1e-5 relative (f32 rounding: the same terms
summed in another order); loss gradients 1e-5 absolute; the learning-rate
schedule 1e-5 relative (JAX evaluates it in f32, where ``1 - frac`` cancels
near the end of the decay; the port in f64); parameters after three
AdamW updates at a rate of 0.1, 2e-6 absolute, against updates above 1e-3
(JAX takes the bias correction ``1 - b2**t`` in f32, where ``1 - 0.999``
keeps a relative error of 1.3e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spike2former_tpu.engine.optim import (
    make_optimizer, poly_warmup_schedule as jax_schedule)
from spike2former_tpu.losses import criterion as jcrit
from spike2former_tpu.losses import losses as jlosses
from spike2former_tpu.losses import matcher as jmatcher
from spike2former_tpu.ops.resize import (
    resize_nearest_torch as jax_resize_nearest)
from spike2former_tpu_torch.engine.optim import (
    AdamW, param_label, poly_warmup_schedule)
from spike2former_tpu_torch.losses import criterion, losses, matcher
from spike2former_tpu_torch.ops.resize import resize_nearest_torch

RTOL = 1e-5


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("src,dst", [((10, 14), (5, 7)), ((5, 7), (10, 14)),
                                     ((10, 14), (4, 6)), ((10, 14), (13, 17)),
                                     ((8, 8), (8, 8))])
def test_resize_nearest_torch_matches_jax(src, dst):
    x = np.random.default_rng(0).integers(0, 50, (2, *src, 3)).astype(
        np.int32)
    want = np.asarray(jax_resize_nearest(jnp.asarray(x), dst))
    got = resize_nearest_torch(_t(x), dst).numpy()
    assert got.shape == want.shape == (2, *dst, 3)
    np.testing.assert_array_equal(got, want)


def test_loss_functions_match_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(12, 6)).astype(np.float32)
    labels = rng.integers(0, 6, 12)
    cw = np.asarray([1, 1, 1, 1, 1, 0.1], np.float32)
    sw = rng.uniform(size=12).astype(np.float32)
    pred = (rng.normal(size=(3, 9, 7)) * 3).astype(np.float32)
    tgt = (rng.uniform(size=(3, 9, 7)) > 0.6).astype(np.float32)
    w = np.asarray([1.0, 0.0, 1.0], np.float32)
    pairs = [
        (jlosses.weighted_cross_entropy(jnp.asarray(logits),
                                        jnp.asarray(labels), jnp.asarray(cw),
                                        jnp.asarray(sw)),
         losses.weighted_cross_entropy(_t(logits), _t(labels), _t(cw),
                                       _t(sw))),
        (jlosses.focal_terms(jnp.asarray(pred), jnp.asarray(tgt)),
         losses.focal_terms(_t(pred), _t(tgt))),
        (jlosses.sigmoid_focal_loss(jnp.asarray(pred), jnp.asarray(tgt),
                                    weight=jnp.asarray(w)[:, None, None],
                                    avg_factor=5.0),
         losses.sigmoid_focal_loss(_t(pred), _t(tgt),
                                   weight=_t(w)[:, None, None],
                                   avg_factor=5.0)),
        (jlosses.sigmoid_focal_loss(jnp.asarray(pred), jnp.asarray(tgt)),
         losses.sigmoid_focal_loss(_t(pred), _t(tgt))),
        (jlosses.dice_loss(jnp.asarray(pred), jnp.asarray(tgt),
                           weight=jnp.asarray(w), avg_factor=2.0),
         losses.dice_loss(_t(pred), _t(tgt), weight=_t(w), avg_factor=2.0)),
        (jlosses.dice_loss(jnp.asarray(pred), jnp.asarray(tgt), naive=False),
         losses.dice_loss(_t(pred), _t(tgt), naive=False)),
    ]
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=1e-7)


def test_focal_and_dice_gradients_at_zero_logits_match_jax():
    """A query whose mask embedding spikes to all zeros has logits of
    exactly 0, where ``|x|`` and ``max(x, 0)`` are not differentiable: the
    port takes JAX's one-sided conventions there."""
    rng = np.random.default_rng(9)
    pred = (rng.normal(size=(2, 5, 6)) * 2).astype(np.float32)
    pred[0] = 0.0
    tgt = (rng.uniform(size=pred.shape) > 0.5).astype(np.float32)

    def jax_loss(x):
        return (jlosses.sigmoid_focal_loss(x, jnp.asarray(tgt),
                                           avg_factor=3.0)
                + jlosses.dice_loss(x, jnp.asarray(tgt), avg_factor=2.0))

    want = np.asarray(jax.grad(jax_loss)(jnp.asarray(pred)))
    x = _t(pred.copy()).requires_grad_()
    (losses.sigmoid_focal_loss(x, _t(tgt), avg_factor=3.0)
     + losses.dice_loss(x, _t(tgt), avg_factor=2.0)).backward()
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=RTOL, atol=1e-7)


def _sem_maps(seed=2, b=3, h=12, w=10, num_classes=20):
    rng = np.random.default_rng(seed)
    sem = rng.integers(0, num_classes, (b, h, w)).astype(np.int32)
    sem[0, :3] = 255                       # ignore pixels
    sem[1] = rng.integers(0, 3, (h, w))    # few classes
    sem[2, :, :5] = 255
    return sem


@pytest.mark.parametrize("max_gt", [4, 8, 64])
def test_semantic_to_instances_matches_jax_exactly(max_gt):
    sem = _sem_maps()
    want = jcrit.semantic_to_instances(jnp.asarray(sem), 20, max_gt)
    got = criterion.semantic_to_instances(_t(sem).long(), 20, max_gt)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.dropped.numpy(),
                                  np.asarray(want.dropped))
    np.testing.assert_array_equal(got.slot_map.numpy(),
                                  np.asarray(want.slot_map))
    np.testing.assert_array_equal(got.dense_masks().numpy(),
                                  np.asarray(want.dense_masks()))
    if max_gt == 4:
        assert got.dropped.numpy().max() > 0


def test_classification_targets_match_jax_exactly():
    matched = np.asarray([[2, -1, 0, -1], [-1, -1, -1, 1]], np.int32)
    labels = np.asarray([[3, 4, 1, 2], [0, 1, 2, 3]], np.int32)
    want = jcrit.classification_targets(jnp.asarray(matched),
                                        jnp.asarray(labels), 5, 7)
    got = criterion.classification_targets(_t(matched).long(),
                                           _t(labels).long(), 5, 7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _problem(seed=3, b=2, nq=7, k=6, g=5, hw=(6, 8)):
    rng = np.random.default_rng(seed)
    cls = rng.normal(size=(b, nq, k + 1)).astype(np.float32)
    masks = (rng.normal(size=(b, nq, *hw)) * 2).astype(np.float32)
    labels = rng.integers(0, k, (b, g)).astype(np.int32)
    gm = (rng.uniform(size=(b, g, *hw)) > 0.5).astype(np.float32)
    valid = rng.uniform(size=(b, g)) > 0.3
    valid[:, 0] = True
    return cls, masks, labels, gm, valid


def test_match_costs_and_assignment_match_jax():
    cls, masks, labels, gm, valid = _problem()
    b, nq = masks.shape[:2]
    want = np.asarray(jax.vmap(jmatcher.match_costs)(
        jnp.asarray(cls), jnp.asarray(masks), jnp.asarray(labels),
        jnp.asarray(gm), jnp.asarray(valid)))
    got = matcher.match_costs(_t(cls), _t(masks).reshape(b, nq, -1),
                              _t(labels).long(), _t(gm).reshape(*gm.shape[:2],
                                                                -1),
                              _t(valid)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5)
    assert (got[~np.broadcast_to(valid[:, None], got.shape)]
            == matcher.BIG_COST).all()
    np.testing.assert_array_equal(
        matcher.hungarian_host(torch.from_numpy(got)).numpy(),
        jmatcher._scipy_batch(want))
    # more GT columns than queries: the extra columns stay unmatched
    wide = np.random.default_rng(4).uniform(size=(2, 3, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        matcher.hungarian_host(torch.from_numpy(wide)).numpy(),
        jmatcher._scipy_batch(wide))


def _loss_inputs(seed=5, num_layers=3, b=2, t=1, nq=6, c=8, hw=(6, 5),
                 gt_hw=(12, 10), num_classes=5):
    rng = np.random.default_rng(seed)
    cls = rng.normal(size=(num_layers, b, nq, num_classes + 1)).astype(
        np.float32)
    embeds = rng.normal(size=(num_layers, t, b, nq, c)).astype(np.float32)
    feats = (rng.normal(size=(t, b, *hw, c)) * 0.5).astype(np.float32)
    # blocky semantic maps so the nearest-downsampled GT keeps each class
    blocks = rng.integers(0, num_classes, (b, gt_hw[0] // 2, gt_hw[1] // 2))
    sem = np.kron(blocks, np.ones((2, 2), np.int64)).astype(np.int32)
    sem[0, :2] = 255
    return cls, embeds, feats, sem


@pytest.mark.parametrize("lazy", [True, False])
@pytest.mark.parametrize("loss_at", ["gt", "pred"])
def test_maskformer_loss_matches_jax(loss_at, lazy):
    """Assignment, every loss value and the gradients to the class scores
    and mask embeddings, lazy and dense forms, at both loss resolutions."""
    cls, embeds, feats, sem = _loss_inputs()
    num_classes, max_gt = 5, 64

    def jax_fn(c, e):
        gt = jcrit.semantic_to_instances(jnp.asarray(sem), num_classes,
                                         max_gt)
        lm = jcrit.LazyMasks(e, jnp.asarray(feats))
        masks = lm if lazy else jax.vmap(lm.layer)(e)
        out = jcrit.maskformer_loss(c, masks, gt, num_classes=num_classes,
                                    matcher="host", loss_at=loss_at)
        return out["total"], out

    # jitted, as the JAX package runs its host matcher: dispatched op by
    # op, its scipy callback indexes a jax array from inside a running
    # computation while the main thread dispatches the next op, and the
    # two can deadlock
    (_, want), (gc_want, ge_want) = jax.jit(jax.value_and_grad(
        jax_fn, argnums=(0, 1), has_aux=True))(jnp.asarray(cls),
                                               jnp.asarray(embeds))

    c_t = _t(cls).requires_grad_()
    e_t = _t(embeds).requires_grad_()
    gt = criterion.semantic_to_instances(_t(sem).long(), num_classes, max_gt)
    lm = criterion.LazyMasks(e_t, _t(feats))
    masks = lm if lazy else torch.stack([lm.layer(e) for e in e_t])
    got = criterion.maskformer_loss(c_t, masks, gt, num_classes=num_classes,
                                    matcher="host", loss_at=loss_at)
    got["total"].backward()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), rtol=RTOL,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(c_t.grad.numpy(), np.asarray(gc_want),
                               atol=1e-5)
    np.testing.assert_allclose(e_t.grad.numpy(), np.asarray(ge_want),
                               atol=1e-5)


def test_match_all_layers_matches_jax_assignment():
    """The port's batched all-layer matching gives the JAX package's
    assignment exactly (costs through each side's own code)."""
    cls, embeds, feats, sem = _loss_inputs(seed=6, num_layers=4)
    num_classes, max_gt = 5, 8
    jgt = jcrit.semantic_to_instances(jnp.asarray(sem), num_classes, max_gt)
    lm = jcrit.LazyMasks(jnp.asarray(embeds), jnp.asarray(feats))
    h, w = lm.mask_hw
    g = jgt.labels.shape[1]
    slot_ds = jax_resize_nearest(jgt.slot_map[..., None], (h, w))[..., 0]
    gt_cost = (slot_ds[:, None] == jnp.arange(g)[None, :, None, None]
               ).astype(jnp.float32).reshape(*slot_ds.shape[:1], g, -1)
    costs = np.stack([np.asarray(jax.vmap(jmatcher.match_costs)(
        jnp.asarray(cls[i]), lm.layer_flat(jnp.asarray(embeds[i])),
        jgt.labels, gt_cost, jgt.valid)) for i in range(len(cls))])
    want = jmatcher._scipy_batch(costs.reshape(-1, *costs.shape[2:]))
    want = np.where(np.asarray(jgt.valid)[None],
                    want.reshape(costs.shape[0], costs.shape[1], -1), -1)

    gt = criterion.semantic_to_instances(_t(sem).long(), num_classes, max_gt)
    slot_ds_t = resize_nearest_torch(gt.slot_map[..., None], (h, w))[..., 0]
    got, repaired = criterion.match_all_layers(
        _t(cls), criterion.LazyMasks(_t(embeds), _t(feats)), gt, slot_ds_t)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got >= 0).sum() > 0 and int(repaired) == 0


def test_poly_warmup_schedule_matches_jax():
    want = jax_schedule(1e-3, warmup_iters=10, total_iters=100)
    got = poly_warmup_schedule(1e-3, warmup_iters=10, total_iters=100)
    for step in (0, 1, 5, 9, 10, 11, 55, 99, 100, 150):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-5,
                                   atol=1e-12)
    assert got(0) == pytest.approx(1e-9)


def test_param_groups():
    assert param_label("backbone.down1_1.Conv_0.weight") == "backbone"
    assert param_label("head.query_embed") == "embed"
    assert param_label("head.level_embed") == "embed"
    assert param_label("head.pixel_decoder.encoder_0.gamma1") == "default"


def test_adamw_matches_jax_flat_adamw():
    """Three updates of the grouped AdamW with clipping (one step under
    the clip norm, two over it) against the JAX package's optimizer."""
    rng = np.random.default_rng(7)
    shapes = {"backbone": {"w": (3, 4), "b": (4,)},
              "head": {"query_embed": (5, 2), "proj": {"kernel": (2, 3)}}}

    def tree(scale):
        return jax.tree_util.tree_map(
            lambda s: (rng.normal(size=s) * scale).astype(np.float32), shapes,
            is_leaf=lambda x: isinstance(x, tuple))

    params = tree(1.0)
    grads = [tree(1e-3), tree(1.0), tree(5.0)]
    # a large rate, so that each update is far above the parameters' ulp
    kw = dict(base_lr=0.1, weight_decay=0.05, backbone_lr_mult=0.1,
              clip_norm=0.01, warmup_iters=2, total_iters=10)
    tx = make_optimizer(jax.tree_util.tree_map(jnp.asarray, params), **kw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jp)
    names = ["backbone.b", "backbone.w", "head.proj.kernel",
             "head.query_embed"]
    leaves = jax.tree_util.tree_leaves(params)   # sorted key order
    tp = [torch.nn.Parameter(_t(x.copy())) for x in leaves]
    opt = AdamW(zip(names, tp), **kw)
    for g in grads:
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state,
                               jp)
        jp = jax.tree_util.tree_map(lambda a, b: a + b, jp, upd)
        for p, gl in zip(tp, jax.tree_util.tree_leaves(g)):
            p.grad = _t(gl)
        norm = opt.step()
        want_norm = np.sqrt(sum((x.astype(np.float64) ** 2).sum()
                                for x in jax.tree_util.tree_leaves(g)))
        np.testing.assert_allclose(float(norm), want_norm, rtol=1e-6)
    for p, want in zip(tp, jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want),
                                   rtol=0, atol=2e-6)
        assert np.abs(p.detach().numpy() - leaves.pop(0)).max() > 1e-3
    assert opt.count == 3
