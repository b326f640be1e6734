"""The port's train data layer against the JAX package's: each ADE20K train
transform on the same sample and the same ``np.random.Generator`` state,
``TrainLoader``'s first batches on one tiny tree and seed, and the
dataset's ``cache``, ``with_ann`` and default split.  Everything is
compared exactly (``np.array_equal``), generator states included: the
port makes the same draws in the same order."""
import sys
import os

sys.path.insert(0, os.path.dirname(__file__))

import numpy as np
import pytest

from spike2former_tpu.data import TrainLoader as JaxTrainLoader
from spike2former_tpu.data import make_dataset as jax_make_dataset
from spike2former_tpu.data import transforms as jt
from spike2former_tpu_torch.data import transforms as tt
from spike2former_tpu_torch.data.dataset import make_dataset
from spike2former_tpu_torch.data.loader import TrainLoader

from torch_port_helpers import write_ade_tree

SEEDS = range(6)


def _sample(hw=(90, 120), seed=0, dominant=False):
    """A uint8 image and an int32 map with ignore pixels; ``dominant``
    gives one class 90% of the labelled pixels, so that ``random_crop``
    re-draws."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
    if dominant:
        seg = np.ones(hw, np.int32)
        seg[: hw[0] // 10] = 2
    else:
        seg = np.kron(rng.integers(0, 6, (hw[0] // 8 + 1, hw[1] // 8 + 1)),
                      np.ones((8, 8), np.int32))[:hw[0], :hw[1]]
    seg[:, :3] = 255
    return {"image": img, "sem_seg": seg.astype(np.int32),
            "meta": {"ori_shape": hw}}


def _same(got, want):
    assert set(got) == set(want)
    for k in ("image", "sem_seg"):
        if want.get(k) is None:
            assert got.get(k) is None
            continue
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k
    assert got.get("meta") == want.get("meta")


def _both(fn_name, sample, seed, *args, **kw):
    """Run the JAX and the port transform from the same generator state;
    the outputs and the generators' states afterwards must be equal."""
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    want = getattr(jt, fn_name)(sample, rj, *args, **kw)
    got = getattr(tt, fn_name)(sample, rt, *args, **kw)
    _same(got, want)
    assert rt.bit_generator.state == rj.bit_generator.state
    return got


@pytest.mark.parametrize("scale,max_size", [(320, 2560), (1280, 2560),
                                            (512, 600)])
def test_resize_shortest_edge_matches_jax(scale, max_size):
    s = _sample((90, 120))
    _same(tt.resize_shortest_edge(s, scale, max_size),
          jt.resize_shortest_edge(s, scale, max_size))


@pytest.mark.parametrize("seed", SEEDS)
def test_random_choice_resize_matches_jax(seed):
    got = _both("random_choice_resize", _sample((60, 80), seed), seed)
    assert min(got["image"].shape[:2]) in range(320, 1281)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("case", ["larger", "smaller", "dominant"])
def test_random_crop_matches_jax(case, seed):
    """A map larger than the crop, an image smaller than it (the crop is
    the whole image; ``train_pipeline`` pads it), and a map where one
    class dominates (the re-draw loop)."""
    hw = {"larger": (150, 170), "smaller": (40, 50), "dominant": (150, 170)}
    _both("random_crop", _sample(hw[case], seed, case == "dominant"), seed,
          (64, 64))


@pytest.mark.parametrize("seed", SEEDS)
def test_random_flip_and_photometric_distortion_match_jax(seed):
    s = _sample((48, 40), seed)
    _both("random_flip", s, seed)
    _both("photometric_distortion", s, seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_mosaic_matches_jax(seed):
    """Four samples, two larger and two smaller than the quadrant."""
    group = [_sample(hw, seed + i) for i, hw in enumerate(
        ((90, 120), (40, 30), (70, 64), (20, 100)))]
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    _same(tt.mosaic(group, rt, img_scale=(64, 64)),
          jt.mosaic(group, rj, img_scale=(64, 64)))
    assert rt.bit_generator.state == rj.bit_generator.state


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("hw", [(90, 120), (30, 40)])
def test_train_pipeline_matches_jax(hw, seed):
    got = _both("train_pipeline", _sample(hw, seed), seed, (64, 64))
    assert got["image"].shape == (64, 64, 3)
    assert got["sem_seg"].shape == (64, 64)


@pytest.mark.parametrize("seed", SEEDS)
def test_train_pipeline_mix_matches_jax(seed):
    """Mosaic at probability 0.5; the 3 extra samples are drawn with the
    sample's own generator, as ``TrainLoader`` draws them."""
    pool = [_sample(hw, 10 + i) for i, hw in enumerate(
        ((90, 120), (40, 30), (70, 64), (20, 100), (64, 64)))]
    out = []
    for mod in (jt, tt):
        rng = np.random.default_rng(seed)
        out.append((mod.train_pipeline_mix(
            pool[0], lambda: pool[int(rng.integers(len(pool)))], rng,
            (64, 64), 0.5), rng.bit_generator.state))
    _same(out[1][0], out[0][0])
    assert out[1][1] == out[0][1]


@pytest.fixture
def tree(tmp_path):
    """Five training images (two batches of 2 an epoch, so three batches
    cross an epoch) and four val images, 90-150 px, 4 classes."""
    return write_ade_tree(tmp_path / "ade", n=5, num_labels=5)


@pytest.fixture
def loaders(request):
    """Builds loaders and closes every one at teardown."""
    made = []

    def make(cls, *args, **kw):
        made.append(cls(*args, **kw))
        return made[-1]

    yield make
    for loader in made:
        loader.close()


def _batches(loader, n=3):
    it = iter(loader)
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("mosaic_prob", [0.0, 0.5])
def test_train_loader_matches_jax(tree, loaders, mosaic_prob):
    kw = dict(crop_size=(64, 64), seed=3, num_workers=2,
              mosaic_prob=mosaic_prob)
    want = _batches(loaders(JaxTrainLoader,
                            jax_make_dataset("ade20k", tree, "train"), 2,
                            **kw))
    got = _batches(loaders(TrainLoader, make_dataset("ade20k", tree, "train"),
                           2, **kw))
    for (gi, gs), (wi, ws) in zip(got, want):
        assert gi.dtype == np.float32 and gs.dtype == np.int32
        assert gi.shape == (2, 64, 64, 3) and gs.shape == (2, 64, 64)
        assert np.array_equal(gi, wi) and np.array_equal(gs, ws)


def test_train_loader_process_share_matches_jax(tree, loaders):
    """Two processes' loaders of batch 1: each process takes its strided
    share of the same permutation."""
    for pid in (0, 1):
        kw = dict(crop_size=(64, 64), seed=5, num_workers=1,
                  process_id=pid, process_count=2)
        want = _batches(loaders(JaxTrainLoader,
                                jax_make_dataset("ade20k", tree, "train"),
                                1, **kw))
        got = _batches(loaders(TrainLoader,
                               make_dataset("ade20k", tree, "train"), 1,
                               **kw))
        for g, w in zip(got, want):
            assert np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1])


def test_train_loader_close_stops_every_thread(tree):
    loader = TrainLoader(make_dataset("ade20k", tree, "train"), 2, (64, 64),
                         num_workers=3)
    _batches(loader, 1)
    threads = list(loader.pool._threads) + [loader._thread]
    loader.close()
    assert threads and not any(t.is_alive() for t in threads)


def test_train_loader_raises_what_the_producer_hit(tree, loaders):
    ds = make_dataset("ade20k", tree, "train")
    ds.samples[0] = (ds.samples[0][0] + ".missing", ds.samples[0][1])
    loader = loaders(TrainLoader, ds, 5, (64, 64), num_workers=1)
    with pytest.raises(RuntimeError, match="producer failed"):
        _batches(loader, 1)


def test_cache_gives_the_same_batches(tree, loaders):
    kw = dict(crop_size=(64, 64), seed=1, num_workers=2, mosaic_prob=0.5)
    plain = _batches(loaders(TrainLoader,
                             make_dataset("ade20k", tree, "train"), 2, **kw))
    ds = make_dataset("ade20k", tree, "train", cache=True)
    cached = _batches(loaders(TrainLoader, ds, 2, **kw), 4)
    assert len(ds._cache) == len(ds)
    for (pi, ps), (ci, cs) in zip(plain, cached):
        assert np.array_equal(pi, ci) and np.array_equal(ps, cs)
    for i in range(len(ds)):  # a cached load hands out a fresh meta
        a, b = ds.load(i), ds.load(i)
        assert a["meta"] == b["meta"] and a["meta"] is not b["meta"]


def test_dataset_default_split_cache_and_with_ann_match_jax(tree):
    """``make_dataset`` defaults to the train split, as JAX's does;
    ``with_ann=False`` lists no annotation and loads none."""
    for kw in ({}, {"with_ann": False}, {"cache": True}):
        want = jax_make_dataset("ade20k", tree, **kw)
        got = make_dataset("ade20k", tree, **kw)
        assert got.split == want.split == "train"
        assert got.samples == want.samples and len(got) == 5
        for i in range(len(got)):
            _same(got.load(i), want.load(i))
    assert all(a is None for _, a in make_dataset(
        "ade20k", tree, with_ann=False).samples)
