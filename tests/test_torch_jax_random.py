"""The port's copy of JAX's random streams (``utils/jax_random.py``)
against ``jax.random`` and flax, and the draws the port's train steps make
from them against JAX's, with nothing of JAX handed to the port.

* Keys (``key``, ``fold_in``, ``split``), ``bits``, ``uniform`` and
  ``bernoulli`` bitwise, over a grid of seeds and shapes, blocks of an
  axis equal to the slice of the whole draw, and threefry2x32's
  known-answer vectors.
* ``normal``, ``truncated_normal`` and ``erf_inv`` through XLA's float32
  polynomial and log1p with its FMAs: within ``NORMAL_ULP`` units in the
  last place (the largest gap found is printed by the test's message);
  the truncated normal of flax's initializers bitwise over a million
  draws.
* ``fold_in_static`` against flax's ``LazyRng``.
* The FPN step's dropout and the point-sampled loss (and, with
  ``--runslow``, the point-loss step), each started from the same seed on
  both sides (the port's ``init_weights_`` beside flax's ``model.init``;
  the step's keys), within the step tolerances of
  ``tests/test_torch_train.py``; the two-rank data-parallel dropout mask
  equal to the one-process mask.
* jax 0.9's default ``jax_threefry_partitionable = True``, which the
  port's counters follow: a change of JAX's default fails here first.
"""
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(__file__))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import scope as fscope

from spike2former_tpu.losses import criterion as jcrit
from spike2former_tpu_torch.engine import train as ttrain
from spike2former_tpu_torch.engine.config import TrainConfig
from spike2former_tpu_torch.engine.weights import init_weights_
from spike2former_tpu_torch.losses import criterion
from spike2former_tpu_torch.models.fpn import Dropout, dropout_key
from spike2former_tpu_torch.parallel import free_port
from spike2former_tpu_torch.utils import jax_random as jr

from test_torch_fpn import TINY_FPN
from test_torch_fpn_train import SPEC, _run_jax_fpn, _seg_batch
from test_torch_init_exact import flax_tree, preset_pair
from test_torch_point_sample import (B, G, L, N_POINTS, NUM_CLASSES, T,
                                     _loss_inputs, _t, jax_point_steps,
                                     pin_jax_matching,
                                     record_jax_point_step)
from test_torch_train import (_batch, _check_grads, _check_metrics,
                              _check_state)
from torch_port_helpers import TINY, make_pair

SEEDS = [0, 1, 42, 2 ** 31 - 1, -1]
SHAPES = [(), (1,), (7,), (3, 5, 2), (129, 33)]
NORMAL_ULP = 2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _kd(k) -> tuple[int, int]:
    return tuple(int(v) for v in np.asarray(k))


def _ulp_gap(got: np.ndarray, want: np.ndarray) -> float:
    both = np.isfinite(want)
    assert np.array_equal(got[~both], want[~both])
    gap = np.abs(got[both].astype(np.float64) - want[both]) / np.spacing(
        np.abs(want[both]).astype(np.float32))
    return float(gap.max(initial=0.0))


def test_threefry_partitionable_is_jax_default():
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("key,counter,want", [
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF,) * 2, (0xFFFFFFFF,) * 2, (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
     (0xC4923A9C, 0x483DF7A0))])
def test_threefry_known_answers(key, counter, want):
    """Random123's threefry2x32 (20 rounds) vectors: the host block and
    the plain tensor version."""
    assert jr.threefry2x32_block(key, *counter) == want
    x0, x1 = jr.threefry2x32(key, torch.tensor([counter[0]]),
                             torch.tensor([counter[1]]))
    assert (int(x0), int(x1)) == want


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_are_jax_keys(seed):
    k, jk = jr.key(seed), jax.random.PRNGKey(seed)
    assert k == _kd(jk)
    for data in (0, 1, 5, 2 ** 31, 2 ** 32 - 1):
        assert jr.fold_in(k, data) == _kd(jax.random.fold_in(jk, data))
    for num in (1, 2, 3, 7):
        assert jr.split(k, num) == [_kd(x) for x in
                                    jax.random.split(jk, num)]
    # a microbatch's fold of a uint32 index, as the JAX step's scan
    assert jr.fold_in(k, 3) == _kd(jax.random.fold_in(jk, jnp.uint32(3)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_uniform_bernoulli_are_jax_bitwise(seed, shape):
    k, jk = jr.key(seed), jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(
        jr.bits(k, shape).numpy(),
        np.asarray(jax.random.bits(jk, shape)).astype(np.int64))
    for lo, hi in ((0.0, 1.0), (-1.0, 1.0), (-0.3, 2.7), (0.25, 0.5)):
        got = jr.uniform(k, shape, lo, hi).numpy()
        want = np.asarray(jax.random.uniform(jk, shape, minval=lo,
                                             maxval=hi))
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
    for p in (0.9, 0.8, 0.5):
        np.testing.assert_array_equal(
            jr.bernoulli(k, p, shape).numpy(),
            np.asarray(jax.random.bernoulli(jk, p, shape)))


@pytest.mark.parametrize("shape,axis,start,stop", [
    ((4, 6, 3), 0, 1, 3), ((4, 6, 3), 1, 2, 6), ((4, 6, 3), 2, 0, 1),
    ((5, 8), -1, 3, 8), ((9,), 0, 4, 4)])
def test_a_block_is_the_slice_of_the_whole_draw(shape, axis, start, stop):
    k = jr.key(11)
    index = [slice(None)] * len(shape)
    index[axis] = slice(start, stop)
    block = dict(axis=axis, start=start, stop=stop)
    for whole, part in (
            (jr.bits(k, shape), jr.bits(k, shape, **block)),
            (jr.uniform(k, shape, -1.0, 1.0),
             jr.uniform(k, shape, -1.0, 1.0, **block)),
            (jr.bernoulli(k, 0.9, shape),
             jr.bernoulli(k, 0.9, shape, **block))):
        assert torch.equal(part, whole[tuple(index)])


def test_normal_samplers_are_jax_within_ulps():
    """``normal`` and ``erf_inv`` within ``NORMAL_ULP``; the truncated
    normal of flax's initializers (bounds -2, 2) bitwise."""
    shape = (1000, 1000)
    gaps = {}
    got = jr.normal(jr.key(7), shape).numpy()
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(7), shape))
    gaps["normal"] = _ulp_gap(got, want)
    x = np.asarray(jax.random.uniform(jax.random.PRNGKey(3), (400_000,),
                                      minval=-1.0, maxval=1.0))
    gaps["erf_inv"] = _ulp_gap(jr.erf_inv(torch.tensor(x)).numpy(),
                               np.asarray(jax.lax.erf_inv(x)))
    assert max(gaps.values()) <= NORMAL_ULP, gaps
    got = jr.truncated_normal(jr.key(5), -2.0, 2.0, shape).numpy()
    want = np.asarray(jax.random.truncated_normal(jax.random.PRNGKey(5),
                                                  -2.0, 2.0, shape))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_log1p_is_xlas():
    """XLA's CPU float32 ``log1p`` bitwise, on both branches (|x| below
    and above sqrt(2) - 1) and at -1 and past it."""
    x = np.concatenate([
        np.asarray(jax.random.uniform(jax.random.PRNGKey(9), (200_000,),
                                      minval=-1.0, maxval=3.0)),
        np.float32([-1.0, -1.5, 0.0, 0.41, 0.42, np.inf])])
    got = jr.log1p(torch.tensor(x)).numpy()
    want = np.asarray(jax.jit(jnp.log1p)(x))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_array_equal(got[ok], want[ok])


@pytest.mark.parametrize("data", [
    ("params",), ("backbone", "Conv_0", 1), ("head", "query_feat", 0),
    ("décodeur", 2 ** 40), ("a", "bc", 255, 256)])
def test_fold_in_static_is_flax(data):
    for seed in (0, 3):
        want = fscope.LazyRng.create(jax.random.PRNGKey(seed),
                                     *data).as_jax_rng()
        assert jr.fold_in_static(jr.key(seed), data) == _kd(want)
    assert jr.fold_in_static(jr.key(1), ()) == jr.key(1)


def test_point_loss_draws_jax_points():
    """``maskformer_loss`` keyed by ``rng`` (no draws handed in) against
    JAX's on the same key: every loss term within 1e-5 (the lazy masks,
    the GT axis cut to 32, the auction)."""
    cls, embeds, feats, labels, valid, smap = _loss_inputs()
    gt_j = jcrit.GroundTruth(jnp.asarray(labels), None, jnp.asarray(valid),
                             slot_map=jnp.asarray(smap))
    want = jcrit.maskformer_loss(
        jnp.asarray(cls), jcrit.LazyMasks(jnp.asarray(embeds),
                                          jnp.asarray(feats)),
        gt_j, num_classes=NUM_CLASSES, matcher="auction", loss_at="gt",
        compact_gt=32, num_points=N_POINTS, rng=jax.random.PRNGKey(5))
    gt = criterion.GroundTruth(
        labels=_t(labels).long(), valid=_t(valid),
        dropped=torch.zeros(B, dtype=torch.long), slot_map=_t(smap).long())
    got = criterion.maskformer_loss(
        _t(cls), criterion.LazyMasks(_t(embeds), _t(feats)), gt,
        num_classes=NUM_CLASSES, matcher="auction", loss_at="gt",
        compact_gt=32, num_points=N_POINTS, rng=jr.key(5))
    assert set(got) == set(want) and float(got["total"]) > 0
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


# ~90 s (a JAX compile of the point step): with --runslow; the keyed loss
# is held above in the default tier
@pytest.mark.slow
def test_point_step_from_the_same_seed(monkeypatch):
    """Two tiny steps at the preset's defaults (the auction,
    ``compact_gt=32``) with ``loss_points=40``, each side from seed 3's
    initial variables (flax's ``model.init`` beside the port's
    ``init_weights_``) and its own point keys (``fold_in(PRNGKey(7),
    step)``), nothing of JAX handed to the port but the matching of exact
    ties (``pin_jax_matching``, which checks that the port's costs are
    JAX's and its matching differs only between tied queries): every
    ``uncertain_point_coords`` selection of both steps equal to JAX's,
    both steps' losses and the first step's ``grad_norm`` and gradients
    at the step tolerances of ``tests/test_torch_train.py``.  The second
    step's gradients are not held: after the first step from flax's
    init (grad norm 4.76e4, clipped) its BNs see near-constant inputs,
    and its float32 grad norm reads 4022.8 in JAX and 3470.7 in the
    port, their losses equal to 1e-7 (the first step from flax's init
    already drifts from JAX's own f64 run, ``tests/
    test_torch_init_train.py``)."""
    jm, _, pm = make_pair(cfg=dict(TINY, lazy_masks=True, norm_eval=True))
    variables = flax_tree(jm, 3, jnp.zeros((1, 64, 64, 3), jnp.float32),
                          True)
    batches = [_batch(seed=s, num_classes=4) for s in (0, 1)]
    jrec = record_jax_point_step(monkeypatch)
    want, wgrads = jax_point_steps(jm, variables, batches, 7)
    prec = pin_jax_matching(monkeypatch, jrec["match"])
    init_weights_(pm, 3)
    state = ttrain.init_state(pm, TrainConfig(warmup_iters=1))
    step = ttrain.make_train_step(NUM_CLASSES, matcher="auction",
                                  loss_at="gt", compact_gt=32,
                                  num_points=N_POINTS, seed=7)
    got, ggrads = [], []
    for images, sem in batches:
        state, m = step(state, _t(images), _t(sem).long())
        got.append({k: float(v) for k, v in m.items()})
        ggrads.append({k: p.grad.clone() for k, p in pm.named_parameters()})
    assert not prec["queue"]
    _check_metrics(want[:1], got[:1])
    _check_grads(wgrads[0], ggrads[0])
    _check_metrics([{k: v for k, v in want[1].items() if k != "grad_norm"}],
                   [{k: v for k, v in got[1].items() if k != "grad_norm"}])
    assert len(prec["coords"]) == len(jrec["coords"]) > 0
    for p, j in zip(prec["coords"], jrec["coords"]):
        np.testing.assert_array_equal(p, j)


def test_fpn_step_dropout_from_the_same_seed():
    """The tiny MS-ResNet-18 FPN two steps from seed 4 on each side:
    flax's ``model.init`` variables (``flax_init``) and JAX's own dropout
    masks against the port's ``init_weights_`` and its keyed masks; the
    masks keep 0.88-0.92 of the head's features, and a port step keeping
    by another key's mask moves ``total``, so they matter."""
    name = "fpn_msresnet18_512x512_ade20k"
    jm, pm = preset_pair(name, TINY_FPN)
    batches = [_seg_batch(0), _seg_batch(1)]
    variables = flax_tree(jm, 4, jnp.zeros((1, 64, 64, 3), jnp.float32),
                          True)
    want, wgrads, wstate, masks = _run_jax_fpn(jm, variables, batches)
    assert 0.88 < masks[0].mean() < 0.92
    init_weights_(pm, 4)
    start = {k: v.clone() for k, v in pm.state_dict().items()}
    state = ttrain.init_state(pm, TrainConfig(warmup_iters=1))
    step = ttrain.make_train_step_fpn(SPEC)
    got, ggrads = [], []
    for imgs, sem in batches:
        state, m = step(state, torch.from_numpy(imgs),
                        torch.from_numpy(sem).long())
        got.append({k: float(v) for k, v in m.items()})
        ggrads.append({k: p.grad.clone() for k, p in pm.named_parameters()})
    _check_metrics(want, got)
    for w, g in zip(wgrads, ggrads):
        _check_grads(w, g)
    _check_state(wstate, {k: v.clone() for k, v in pm.state_dict().items()},
                 wgrads[-1])
    pm.load_state_dict(start)
    other = ttrain.make_train_step_fpn(SPEC, dropout_draw=lambda s: (
        lambda shape, dev: jr.uniform(jr.key(99), shape, device=dev)))
    moved = other(ttrain.init_state(pm, TrainConfig(warmup_iters=1)),
                  torch.from_numpy(batches[0][0]),
                  torch.from_numpy(batches[0][1]).long())[1]["total"]
    assert abs(float(moved) - got[0]["total"]) > 1e-6 * abs(got[0]["total"])


def _rank_mask(rank: int, world: int, port: int) -> None:
    """A data-parallel rank's Dropout mask: (its rows of the input,
    the mask's keep pattern) saved for the parent test."""
    import torch.distributed as dist

    from spike2former_tpu_torch.parallel import global_batch

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        d = Dropout(0.1).train()
        d.key = dropout_key(jr.fold_in(jr.key(0), 3), "head.Dropout_0")
        x = torch.ones(2, 2, 5, 4, 3)
        with global_batch():
            y = d(x)
        np.save(os.environ["MASK_OUT"] + f".{rank}.npy", (y != 0).numpy())
    finally:
        dist.destroy_process_group()


def test_two_ranks_draw_the_one_process_dropout_mask(tmp_path):
    """Two gloo ranks, two rows each of the batch axis (1) of ``[T, B, H,
    W, C]`` features: each rank's keep mask is its block of the mask one
    process draws for the whole batch."""
    port = free_port()
    env = dict(os.environ, MASK_OUT=str(tmp_path / "mask"),
               PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--rank", str(r), str(port)], env=env)
        for r in range(2)]
    assert [p.wait(timeout=120) for p in procs] == [0, 0]
    d = Dropout(0.1).train()
    d.key = dropout_key(jr.fold_in(jr.key(0), 3), "head.Dropout_0")
    whole = (d(torch.ones(2, 4, 5, 4, 3)) != 0).numpy()
    for r in range(2):
        np.testing.assert_array_equal(
            np.load(tmp_path / f"mask.{r}.npy"), whole[:, 2 * r:2 * r + 2])
    assert 0.8 < whole.mean() < 0.97


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        _rank_mask(int(sys.argv[2]), 2, int(sys.argv[3]))
