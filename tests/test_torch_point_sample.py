"""The port's point-sampled losses (``losses/point_sample.py``, the point
branches of ``losses/criterion.py``, ``train.loss_points``) against the
JAX package's, mirroring tests/test_point_sample.py.

The two packages' RNGs cannot agree, so the port's samplers take the
uniforms JAX draws (``jax_draws``: the keys the JAX loss derives from its
``rng``, in the port's ``Draw`` order).  The point counts keep every JAX
sampler on its unchunked path (at most 128 points a call): on the CPU the
chunked ``lax.map`` path computes its selector contraction at a lower
precision (5e-6 off the exact f32 value, 3e-3 at bf16), where the
unchunked one is exact.

Tolerances: the samplers within 1e-6 (measured: bit-equal, f32 and the
bf16 rounding), shared-point slot sampling exact, the selected points
exact; ``maskformer_loss`` in point mode each term within 1e-5 relative
and its gradients within 1e-4 of the largest (the GT-resolution loss's
tolerances in tests/test_torch_criterion_compact.py and
test_torch_train.py); the train step with ``loss_points`` as
tests/test_torch_train.py holds the step.
"""
import copy
import importlib
import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spike2former_tpu.engine import train as jtrain
from spike2former_tpu.engine.config import TrainConfig as JaxTrainConfig
from spike2former_tpu.engine.optim import make_optimizer
from spike2former_tpu.losses import criterion as jcrit
from spike2former_tpu_torch.engine import train as ttrain
from spike2former_tpu_torch.engine.config import TrainConfig, get_config
from spike2former_tpu_torch.losses import criterion
from spike2former_tpu_torch.losses.point_sample import (
    get_uncertainty, point_sample, point_sample_shared, point_sample_slot,
    uncertain_point_coords)

from test_torch_train import (GRAD_ATOL_FRAC, GRAD_NORM_RTOL, GRAD_RTOL,
                              LOSS_RTOL, _batch, _check_grads,
                              _check_metrics, _recording)
from torch_port_helpers import TINY, make_pair

jps = importlib.import_module("spike2former_tpu.losses.point_sample")

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _t(x):
    return torch.from_numpy(np.array(x))


def _masks_coords(seed=0, lead=(2, 3), hw=(17, 23), p=100):
    rng = np.random.default_rng(seed)
    m = rng.normal(0, 2, (*lead, *hw)).astype(np.float32)
    # a margin past [0, 1]: taps off the map take grid_sample's zeros
    c = rng.uniform(-0.05, 1.05, (*lead, p, 2)).astype(np.float32)
    return m, c


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_point_sample_matches_jax(dtype):
    m, c = _masks_coords()
    jdt, tdt = DTYPES[dtype]
    want = np.asarray(jps.point_sample(jnp.asarray(m), jnp.asarray(c),
                                       dtype=jdt))
    got = point_sample(_t(m), _t(c), dtype=tdt).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_point_sample_equals_grid_sample():
    """mmcv's op itself: ``grid_sample(align_corners=False)`` with zero
    padding at ``2 * coords - 1``."""
    m, c = _masks_coords(seed=1, lead=(4,))
    want = torch.nn.functional.grid_sample(
        _t(m)[:, None], 2 * _t(c)[:, None] - 1, mode="bilinear",
        padding_mode="zeros", align_corners=False)[:, 0, 0]
    got = point_sample(_t(m), _t(c))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)


def test_point_sample_gradient_matches_jax():
    m, c = _masks_coords(seed=2)
    w = np.random.default_rng(3).normal(size=(2, 3, 100)).astype(np.float32)
    want = np.asarray(jax.grad(lambda x: jnp.sum(jps.point_sample(
        x, jnp.asarray(c)) * w))(jnp.asarray(m)))
    mt = _t(m).requires_grad_()
    (point_sample(mt, _t(c)) * _t(w)).sum().backward()
    np.testing.assert_allclose(mt.grad.numpy(), want, rtol=0, atol=1e-6)


def test_point_sample_shared_matches_jax():
    m, c = _masks_coords(seed=4)
    want = np.asarray(jps.point_sample_shared(jnp.asarray(m),
                                              jnp.asarray(c[:, 0])))
    got = point_sample_shared(_t(m), _t(c[:, 0])).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # and equal to point_sample with the coordinates broadcast
    bc = np.broadcast_to(c[:, :1], c.shape)
    np.testing.assert_allclose(got, point_sample(_t(m), _t(bc)).numpy(),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", ["shared", "pair-float32", "pair-bfloat16"])
def test_point_sample_slot_matches_jax(mode):
    rng = np.random.default_rng(5)
    g = 3
    smap = rng.integers(0, g + 1, (2, 17, 23)).astype(np.int32)  # g = none
    _, c = _masks_coords(seed=6, lead=(2, g))
    if mode == "shared":
        c = c[:, 0]
        want = np.asarray(jps.point_sample_slot(jnp.asarray(smap), g,
                                                jnp.asarray(c)))
        got = point_sample_slot(_t(smap), g, _t(c)).numpy()
        np.testing.assert_array_equal(got, want)   # exact
        return
    jdt, tdt = DTYPES[mode.split("-")[1]]
    want = np.asarray(jps.point_sample_slot(jnp.asarray(smap), g,
                                            jnp.asarray(c), dtype=jdt))
    got = point_sample_slot(_t(smap), g, _t(c), dtype=tdt).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # equal to point_sample of the dense {0, 1} masks
    dense = (smap[:, None] == np.arange(g)[None, :, None, None])
    np.testing.assert_allclose(
        got, point_sample(_t(dense.astype(np.float32)), _t(c),
                          dtype=tdt).numpy(), rtol=0, atol=1e-6)


def test_get_uncertainty():
    x = torch.tensor([-3.0, 0.0, 2.5])
    np.testing.assert_array_equal(get_uncertainty(x).numpy(),
                                  np.asarray(jps.get_uncertainty(
                                      jnp.asarray(x.numpy()))))


@pytest.mark.parametrize("n_points,importance", [(40, 0.75), (40, 1.0),
                                                 (30, 0.0)])
def test_uncertain_point_coords_picks_jax_points(n_points, importance):
    """With JAX's uniforms injected, the port keeps the same points in the
    same order (the bf16 ranking of tests/test_point_sample.py)."""
    m, _ = _masks_coords(seed=7)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jps.uncertain_point_coords(
        key, jnp.asarray(m), n_points, 3.0, importance, dtype=jnp.bfloat16))
    r1, r2 = jax.random.split(key)
    n_imp = int(importance * n_points)
    queue = [_t(jax.random.uniform(r1, (2, 3, 3 * n_points, 2)))]
    if n_points > n_imp:
        queue.append(_t(jax.random.uniform(r2, (2, 3, n_points - n_imp, 2))))
    got = uncertain_point_coords(_t(m), n_points, 3.0, importance,
                                 draw=lambda shape: queue.pop(0),
                                 dtype=torch.bfloat16).numpy()
    assert not queue
    np.testing.assert_array_equal(got, want)


def test_uncertain_point_coords_keeps_the_most_uncertain():
    """A generator draw: the importance part holds the points of the
    smallest |logit| among the oversampled ones, in rank order."""
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(1, 9, 13, generator=g) * 3
    seen = []

    def draw(shape):
        seen.append(torch.rand(shape, generator=g))
        return seen[-1]

    out = uncertain_point_coords(logits, 20, 3.0, 0.75, draw=draw)
    assert out.shape == (1, 20, 2)
    unc = point_sample(logits, seen[0]).abs()[0]
    want = seen[0][0, unc.argsort(stable=True)[:15]]
    np.testing.assert_array_equal(out[0, :15].numpy(), want.numpy())
    np.testing.assert_array_equal(out[0, 15:].numpy(), seen[1][0].numpy())


# --- the criterion ----------------------------------------------------------

B, NQ, G, GC, HW, NUM_CLASSES, L, T, C = 2, 6, 40, 32, 16, 5, 2, 1, 8
N_POINTS = 40   # 120 oversampled points: JAX's unchunked path


def jax_draws(rng, num_layers, b, g, n_points, osr=3.0, imp=0.75):
    """The uniforms the JAX loss draws from ``rng``, in the port's order:
    each layer's matching points, then each layer's oversampled and fresh
    per-pair points (criterion.py:600-602, point_sample.py:256-268)."""
    mk = jax.random.split(jax.random.fold_in(rng, 0), num_layers)
    lk = jax.random.split(jax.random.fold_in(rng, 1), num_layers)
    out = [jax.random.uniform(k, (b, n_points, 2)) for k in mk]
    n_imp = int(imp * n_points)
    for k in lk:
        r1, r2 = jax.random.split(k)
        out.append(jax.random.uniform(r1, (b, g, int(n_points * osr), 2)))
        if n_points > n_imp:
            out.append(jax.random.uniform(r2, (b, g, n_points - n_imp, 2)))
    return [_t(x) for x in out]


def queue_draw(draws):
    """A ``Draw`` that hands out ``draws`` in order, checking shapes."""
    queue = list(draws)

    def draw(shape):
        x = queue.pop(0)
        assert tuple(x.shape) == tuple(shape), (x.shape, shape)
        return x

    draw.queue = queue
    return draw


def _loss_inputs(seed=21):
    rng = np.random.default_rng(seed)
    cls = rng.normal(size=(L, B, NQ, NUM_CLASSES + 1)).astype(np.float32)
    embeds = rng.normal(0, 0.5, (L, T, B, NQ, C)).astype(np.float32)
    feats = rng.normal(0, 0.5, (T, B, HW, HW, C)).astype(np.float32)
    labels = rng.integers(0, NUM_CLASSES, (B, G)).astype(np.int32)
    valid = np.zeros((B, G), bool)
    valid[:, :3] = True
    smap = rng.integers(0, 3, size=(B, 2 * HW, 2 * HW)).astype(np.int32)
    smap[:, :4] = G  # pixels in no slot
    return cls, embeds, feats, labels, valid, smap


# two of the four cases (~10-25 s each, JAX's auction op by op) run with
# --runslow; the default tier holds lazy masks with the GT axis cut and
# dense masks at full width
@pytest.mark.parametrize("lazy,compact_gt", [
    (True, GC), (False, 0),
    pytest.param(True, 0, marks=pytest.mark.slow),
    pytest.param(False, GC, marks=pytest.mark.slow)])
def test_point_mode_loss_and_gradients_match_jax(lazy, compact_gt):
    """``num_points`` costs and losses, the auction matcher, with the
    masks dense or ``LazyMasks`` and the GT axis at full width (40 slots)
    or cut to 32 (``compact_gt``): each loss term within 1e-5, the
    gradients of the class scores and mask logits within 1e-4."""
    cls, embeds, feats, labels, valid, smap = _loss_inputs()
    rng = jax.random.PRNGKey(5)
    g_eff = GC if compact_gt else G
    gt_j = jcrit.GroundTruth(jnp.asarray(labels), None, jnp.asarray(valid),
                             slot_map=jnp.asarray(smap))

    def jax_total(c, e, f):
        masks = (jcrit.LazyMasks(e, f) if lazy
                 else jnp.einsum("ltbqc,tbhwc->lbqhw", e, f) / T)
        out = jcrit.maskformer_loss(
            c, masks, gt_j, num_classes=NUM_CLASSES, matcher="auction",
            loss_at="gt", compact_gt=compact_gt or None,
            num_points=N_POINTS, rng=rng)
        return out["total"], out

    (_, want), wgrads = jax.value_and_grad(jax_total, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(cls), jnp.asarray(embeds), jnp.asarray(feats))

    c, e, f = (_t(x).requires_grad_() for x in (cls, embeds, feats))
    masks = (criterion.LazyMasks(e, f) if lazy
             else torch.einsum("ltbqc,tbhwc->lbqhw", e, f) / T)
    gt = criterion.GroundTruth(
        labels=_t(labels).long(), valid=_t(valid),
        dropped=torch.zeros(B, dtype=torch.long), slot_map=_t(smap).long())
    draw = queue_draw(jax_draws(rng, L, B, g_eff, N_POINTS))
    got = criterion.maskformer_loss(
        c, masks, gt, num_classes=NUM_CLASSES, matcher="auction",
        loss_at="gt", compact_gt=compact_gt or None, num_points=N_POINTS,
        draw=draw)
    assert not draw.queue
    got["total"].backward()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]),
                                   rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert float(got["total"]) > 0
    for gp, wg in zip((c, e, f), wgrads):
        wg = np.asarray(wg)
        np.testing.assert_allclose(gp.grad.numpy(), wg, rtol=0,
                                   atol=1e-4 * np.abs(wg).max())


def test_point_mode_needs_draws():
    cls, embeds, feats, labels, valid, smap = _loss_inputs()
    gt = criterion.GroundTruth(_t(labels).long(), _t(valid),
                               torch.zeros(B, dtype=torch.long),
                               _t(smap).long())
    with pytest.raises(ValueError, match="draw"):
        criterion.maskformer_loss(_t(cls), criterion.LazyMasks(
            _t(embeds), _t(feats)), gt, num_classes=NUM_CLASSES,
            num_points=N_POINTS)


# --- config and train step ---------------------------------------------------

def test_loss_points_config_keys_have_the_jax_defaults():
    t, jt = TrainConfig(), JaxTrainConfig()
    for k in ("loss_points", "loss_points_oversample",
              "loss_points_importance", "loss_points_dtype"):
        assert getattr(t, k) == getattr(jt, k), k
    assert t.loss_points == 0   # the reference's active recipe
    cfg = get_config("SDTv2_maskformer_DCNpixelDecoder_ade20k",
                     ["train.loss_points=12544",
                      "train.loss_points_dtype='bfloat16'"])
    assert (cfg.train.loss_points, cfg.train.loss_points_dtype) == (
        12544, "bfloat16")


def _port_point_steps(pm, batches, seed, dtype=torch.float32):
    """Two port steps of a copy of ``pm`` in ``dtype`` on JAX's draws."""
    model = copy.deepcopy(pm).to(dtype)
    layers = TINY["num_decoder_layers"] + 1
    slots = min(64, NUM_CLASSES)

    def point_draw(step_i, mb):
        rng = jax.random.fold_in(jax.random.PRNGKey(seed), step_i)
        return queue_draw([x.to(dtype) for x in
                           jax_draws(rng, layers, 2, slots, N_POINTS)])

    state = ttrain.init_state(model, TrainConfig(warmup_iters=1))
    step = ttrain.make_train_step(NUM_CLASSES, matcher="auction",
                                  loss_at="gt", compact_gt=32,
                                  num_points=N_POINTS, seed=seed,
                                  point_draw=point_draw)
    prep = ttrain.preprocess
    ttrain.preprocess = lambda x: prep(x).to(dtype)
    metrics, grads = [], []
    try:
        for images, sem in batches:
            state, m = step(state, _t(images), _t(sem).long())
            metrics.append({k: float(v) for k, v in m.items()})
            grads.append({k: p.grad.float() for k, p in
                          model.named_parameters()})
    finally:
        ttrain.preprocess = prep
    return metrics, grads


def record_jax_point_step(monkeypatch):
    """Record, in call order and from inside a jitted JAX step, the costs
    and matching of each JAX ``auction_match`` call and the output of each
    ``uncertain_point_coords`` call."""
    rec = {"match": [], "coords": []}
    auction, coords_fn = jcrit.auction_match, jcrit.uncertain_point_coords

    def match(costs, *args, **kw):
        out = auction(costs, *args, **kw)
        jax.debug.callback(lambda c, m: rec["match"].append(
            (np.asarray(c), np.asarray(m))), costs, out[0])
        return out

    def coords(*args, **kw):
        out = coords_fn(*args, **kw)
        jax.debug.callback(lambda c: rec["coords"].append(np.asarray(c)),
                           out)
        return out

    monkeypatch.setattr(jcrit, "auction_match", match)
    monkeypatch.setattr(jcrit, "uncertain_point_coords", coords)
    return rec


def pin_jax_matching(monkeypatch, jax_matches):
    """Make the port's auction return JAX's matching, call by call, once it
    has checked that the port's costs are JAX's within 1e-5, that the
    port's auction on JAX's costs gives JAX's matching exactly, and that
    the port's own matching differs from it only between queries whose
    cost rows are bitwise equal (an exact tie that the costs' last bits
    break).  Returns a record of the port's ``uncertain_point_coords``
    outputs and of the tied queries it swapped (``swaps``)."""
    queue = list(jax_matches)
    rec = {"coords": [], "swaps": 0}
    auction = criterion.auction_match
    coords_fn = criterion.uncertain_point_coords

    def match(costs, *args, **kw):
        jc, jm = queue.pop(0)
        own, stats = auction(costs, *args, **kw)
        c, own = costs.detach().cpu().numpy(), own.cpu().numpy()
        np.testing.assert_allclose(c, jc, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(
            auction(torch.tensor(jc), *args, **kw)[0].numpy(), jm)
        for bl, gi in zip(*np.nonzero(own != jm)):
            q_own, q_jax = own[bl, gi], jm[bl, gi]
            assert q_own >= 0 and q_jax >= 0, (bl, gi, q_own, q_jax)
            np.testing.assert_array_equal(c[bl, q_own], c[bl, q_jax])
            rec["swaps"] += 1
        return torch.tensor(jm).long().to(costs.device), stats

    def coords(*args, **kw):
        out = coords_fn(*args, **kw)
        rec["coords"].append(out.detach().cpu().numpy())
        return out

    monkeypatch.setattr(criterion, "auction_match", match)
    monkeypatch.setattr(criterion, "uncertain_point_coords", coords)
    rec["queue"] = queue
    return rec


def jax_point_steps(jm, variables, batches, seed):
    """Two jitted JAX steps at the preset's defaults with ``loss_points``:
    the metrics and the gradients of each step."""
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])
    tx = _recording(make_optimizer(params, warmup_iters=1))
    state = jtrain.TrainState(jnp.zeros((), jnp.int32), params, stats,
                              tx.init(params))
    step = jax.jit(jtrain.make_train_step(
        jm, tx, num_classes=NUM_CLASSES, matcher="auction", loss_at="gt",
        compact_gt=32, num_points=N_POINTS, seed=seed))
    metrics, grads = [], []
    for images, sem in batches:
        state, m = step(state, jnp.asarray(images), jnp.asarray(sem))
        metrics.append({k: float(v) for k, v in m.items()})
        grads.append(jax.tree_util.tree_map(np.asarray, state.opt_state[1]))
    jax.effects_barrier()
    return metrics, grads


POINT_STEP_SEEDS = dict(weights=3, batches=(0, 1), points=7)


def point_step_inputs():
    """The model pair and batches of the point-loss step test."""
    jm, variables, pm = make_pair(cfg=dict(TINY, lazy_masks=True,
                                           norm_eval=True),
                                  seed=POINT_STEP_SEEDS["weights"])
    batches = [_batch(seed=s, num_classes=4)
               for s in POINT_STEP_SEEDS["batches"]]
    return jm, variables, pm, batches


# ~75 s (a JAX compile of the step): with --runslow; the loss and its
# gradients are held above in the default tier
@pytest.mark.slow
def test_train_step_with_loss_points_matches_jax(monkeypatch):
    """Two tiny-dims steps at the preset's defaults (the auction,
    ``compact_gt=32``) with ``loss_points=40``, on JAX's draws
    (``fold_in(PRNGKey(seed), step)``), at tests/test_torch_train.py's
    tolerances: both steps' losses, ``grad_norm`` and gradients against
    JAX's, and every ``uncertain_point_coords`` selection equal to JAX's.

    The auction runs on the port's own costs and must agree with JAX's up
    to exact ties: at the second step, layer 0 gives queries 0 and 2 of
    both images bitwise-equal cost rows (their spiking mask embeddings are
    equal), and the port's costs, within 1.9e-6 of JAX's, lead its auction
    to swap the two where JAX's does not.  The swap changes no loss but
    sends the pair's gradient to the other query (1.96e-3 of the largest
    gradient; ``tests/torch_point_step_precision.py``), so the port is
    handed JAX's matching once ``pin_jax_matching`` has checked that the
    two differ only there and that the port's auction on JAX's costs gives
    JAX's matching."""
    jm, variables, pm, batches = point_step_inputs()
    seed = POINT_STEP_SEEDS["points"]
    jrec = record_jax_point_step(monkeypatch)
    want, wgrads = jax_point_steps(jm, variables, batches, seed)
    assert len(jrec["match"]) == len(batches)
    prec = pin_jax_matching(monkeypatch, jrec["match"])
    got, ggrads = _port_point_steps(pm, batches, seed)
    assert not prec["queue"]
    _check_metrics(want, got)
    for w, g in zip(wgrads, ggrads):
        _check_grads(w, g)
    assert len(prec["coords"]) == len(jrec["coords"]) > 0
    for p, j in zip(prec["coords"], jrec["coords"]):
        np.testing.assert_array_equal(p, j)
