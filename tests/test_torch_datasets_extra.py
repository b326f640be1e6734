"""The six dataset entries the port added (Pascal-Context, Pascal-Context
59, Synapse, DRIVE, CHASE-DB1, DDD17), the event-frame loader and the
``pascal_context`` and ``events`` converters against the JAX package, on
the same seeded inputs; everything compared exactly.  Mirrors JAX's
tests/test_data.py::test_fixed_palettes_and_real_class_names and
tests/test_converters_events.py, and drives DDD17 through the port's eval
and train CLIs at tiny widths."""
import dataclasses
import importlib.util
import json
import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

import numpy as np
import pytest
from PIL import Image

from spike2former_tpu.data import TrainLoader as JaxTrainLoader
from spike2former_tpu.data import eval_batches as jax_eval_batches
from spike2former_tpu.data import make_dataset as jax_make_dataset
from spike2former_tpu.data import metainfo as jmeta
from spike2former_tpu.data import transforms as jt
from spike2former_tpu_torch.data import metainfo as tmeta
from spike2former_tpu_torch.data import transforms as tt
from spike2former_tpu_torch.data.dataset import make_dataset
from spike2former_tpu_torch.data.loader import TrainLoader, eval_batches
from spike2former_tpu_torch.data.synthetic import write_ddd17_tree
from spike2former_tpu_torch.tools import dataset_converters as tdc

from test_torch_presets import TINY_OPTS

_spec = importlib.util.spec_from_file_location(
    "jax_dataset_converters",
    os.path.join(os.path.dirname(__file__), "..", "tools",
                 "dataset_converters.py"))
jdc = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jdc)

NEW = ("pascal_context", "pascal_context59", "synapse", "drive",
       "chase_db1", "ddd17")


def _fields(meta) -> dict:
    return {f.name: getattr(meta, f.name) for f in dataclasses.fields(meta)}


def test_datasets_have_the_same_ten_entries_as_jax():
    assert list(tmeta.DATASETS) == list(jmeta.DATASETS)
    assert len(tmeta.DATASETS) == 10 and set(NEW) <= set(tmeta.DATASETS)
    for name, want in jmeta.DATASETS.items():
        got = tmeta.DATASETS[name]
        assert _fields(got) == _fields(want), name
        assert got.num_classes == want.num_classes, name


def test_fixed_palettes_and_real_class_names():
    """JAX's tests/test_data.py:73-81 on the port's entries."""
    d = tmeta.DATASETS
    assert d["pascal_context"].classes[:3] == ("background", "aeroplane",
                                               "bag")
    assert d["pascal_context"].num_classes == 60
    assert d["pascal_context59"].num_classes == 59
    assert d["synapse"].num_classes == 9
    assert d["ddd17"].num_classes == 6 and d["ddd17"].img_suffix == ".npy"
    assert d["coco_stuff164k"].classes[0] == "person"
    assert len(d["cityscapes"].palette) == 19


# (shape, dtype, values): 2-D, 1, 2, 3 and 4 channels, uint8 and not
FRAMES = {
    "hw": ((5, 7), np.uint8, (0, 256)),
    "c1": ((5, 7, 1), np.uint8, (0, 256)),
    "c2": ((5, 7, 2), np.uint8, (0, 256)),
    "c3": ((5, 7, 3), np.uint8, (0, 256)),
    "c4": ((5, 7, 4), np.uint8, (0, 256)),
    "c2_int16": ((5, 7, 2), np.int16, (-40, 400)),
    "c2_float": ((5, 7, 2), np.float32, (-3.5, 300.0)),
    "c1_int32": ((5, 7, 1), np.int32, (-1, 1000)),
}


@pytest.mark.parametrize("suffix", [".npy", ".npz"])
@pytest.mark.parametrize("kind", FRAMES)
def test_load_image_reads_event_frames_as_jax_does(tmp_path, kind, suffix):
    shape, dtype, (lo, hi) = FRAMES[kind]
    rng = np.random.default_rng(len(kind))
    arr = (rng.uniform(lo, hi, shape) if dtype == np.float32
           else rng.integers(lo, hi, shape)).astype(dtype)
    path = str(tmp_path / f"frame{suffix}")
    if suffix == ".npy":
        np.save(path, arr)
    else:
        np.savez(path, frame=arr)
    want, got = jt.load_image(path), tt.load_image(path)
    assert got.shape == shape[:2] + (3,) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    if kind == "c2":
        assert got[..., 2].max() == 0              # a zero third channel
        np.testing.assert_array_equal(got[..., :2], arr)
    if kind == "c1":
        assert (got == arr).all()                  # repeated


def test_load_image_reads_pictures_as_before(tmp_path):
    rng = np.random.default_rng(0)
    path = str(tmp_path / "img.png")
    Image.fromarray(rng.integers(0, 256, (6, 9, 3), np.uint8)).save(path)
    np.testing.assert_array_equal(tt.load_image(path), jt.load_image(path))


def _rle_encode_counts(mask: np.ndarray) -> list[int]:
    """Column-major run lengths, starting with a zero run (COCO RLE)."""
    flat = mask.T.ravel()
    counts, val, run = [], 0, 0
    for v in flat:
        if v == val:
            run += 1
        else:
            counts.append(run)
            val, run = v, 1
    counts.append(run)
    return counts


def _rle_to_string(counts: list[int]) -> str:
    """pycocotools' rleToString: delta-coded LEB128-like chars."""
    out = []
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_decode_rle_uncompressed_and_compressed(seed):
    rng = np.random.default_rng(seed)
    hw = tuple(int(v) for v in rng.integers(3, 40, 2))
    mask = (rng.random(hw) < 0.4).astype(np.uint8)
    counts = _rle_encode_counts(mask)
    for rle in ({"size": list(hw), "counts": counts},
                {"size": list(hw), "counts": _rle_to_string(counts)},
                {"size": list(hw),
                 "counts": _rle_to_string(counts).encode("ascii")}):
        got = tdc.decode_rle(rle)
        np.testing.assert_array_equal(got, mask)
        np.testing.assert_array_equal(got, jdc.decode_rle(rle))


def _detail_json(path, rng, n_images=3):
    """A Detail-format trainval_merged.json: per image, annotations of
    in-subset categories as uncompressed and compressed RLE, one of a
    category outside the 59 + background (left as background), train and
    val phases."""
    cats = [int(c) for c in jdc.PASCAL_CONTEXT_MAPPING[1:]]
    images, annos = [], []
    for i in range(n_images):
        h, w = int(rng.integers(6, 20)), int(rng.integers(6, 20))
        images.append({"image_id": i, "file_name": f"2008_{i:06d}.jpg",
                       "height": h, "width": w,
                       "phase": "train" if i % 2 == 0 else "val"})
        for k in range(4):
            mask = (rng.random((h, w)) < 0.3).astype(np.uint8)
            counts = _rle_encode_counts(mask)
            annos.append({"image_id": i,
                          "category_id": int(rng.choice(cats)) if k < 3
                          else 999,
                          "segmentation": {"size": [h, w], "counts":
                                           counts if k % 2
                                           else _rle_to_string(counts)}})
    path.write_text(json.dumps({"images": images,
                                "annos_segmentation": annos}))


def _files(root) -> dict:
    """Relative path -> contents (decoded pixels for .png, arrays for
    .npy, text otherwise) of every file under ``root``."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            rel = os.path.relpath(p, root)
            if f.endswith(".png"):
                with Image.open(p) as im:
                    out[rel] = (im.mode, np.asarray(im).tolist())
            elif f.endswith(".npy"):
                a = np.load(p)
                out[rel] = (a.dtype.str, a.shape, a.tolist())
            else:
                out[rel] = open(p).read()
    return out


def test_pascal_context_converter_writes_what_jax_writes(tmp_path):
    _detail_json(tmp_path / "merged.json", np.random.default_rng(4))
    for side, mod in (("jax", jdc), ("port", tdc)):
        voc = tmp_path / side
        voc.mkdir()
        assert mod.convert_pascal_context(str(tmp_path / "merged.json"),
                                          str(voc)) == 3
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert got == want
    assert "ImageSets/SegmentationContext/val.txt" in got
    # the CLI subcommand writes the same into its --out-dir
    cli = tmp_path / "cli"
    cli.mkdir()
    assert tdc.main(["pascal_context", str(tmp_path / "merged.json"),
                     str(cli), "-o", str(cli / "masks")]) == 0
    masks = _files(cli / "masks")
    assert masks == {k.split("/", 1)[1]: v for k, v in want.items()
                     if k.startswith("SegmentationClassContext/")}


def test_pascal_context_converter_as_in_jax_test(tmp_path):
    """JAX's tests/test_converters_events.py:107-141 on the port."""
    voc = tmp_path / "voc"
    voc.mkdir()
    h, w = 6, 9
    mask = np.zeros((h, w), np.uint8)
    mask[2:5, 3:7] = 1
    anno = {"image_id": 7, "category_id": 2,
            "segmentation": {"size": [h, w],
                             "counts": _rle_encode_counts(mask)}}
    bogus = {"image_id": 7, "category_id": 999,
             "segmentation": {"size": [h, w], "counts": _rle_encode_counts(
                 np.ones((h, w), np.uint8))}}
    data = {"images": [{"image_id": 7, "file_name": "2008_000099.jpg",
                        "height": h, "width": w, "phase": "train"}],
            "annos_segmentation": [bogus, anno]}
    jp = tmp_path / "trainval_merged.json"
    jp.write_text(json.dumps(data))
    assert tdc.convert_pascal_context(str(jp), str(voc)) == 1
    out = np.asarray(Image.open(
        voc / "SegmentationClassContext" / "2008_000099.png"))
    want = np.zeros((h, w), np.uint8)
    want[2:5, 3:7] = np.digitize(2, tdc.PASCAL_CONTEXT_MAPPING, right=True)
    np.testing.assert_array_equal(out, want)
    assert (voc / "ImageSets" / "SegmentationContext"
            / "train.txt").read_text().split() == ["2008_000099"]


def test_voxelize_events():
    """JAX's tests/test_converters_events.py:144-152, then random events
    against JAX's voxelization."""
    ev = np.array([[0.0, 1, 2, 1], [0.1, 1, 2, 1], [0.9, 3, 0, 0],
                   [1.0, 3, 0, 0]], np.float64)
    out = tdc.voxelize_events(ev, (4, 5), t_bins=2)
    assert out.shape == (2, 4, 5, 2) and out.dtype == np.uint8
    assert out[0, 2, 1, 1] == 2 and out[1, 0, 3, 0] == 2 and out.sum() == 4
    assert tdc.voxelize_events(ev[:0], (4, 5), 3).shape == (3, 4, 5, 2)
    rng = np.random.default_rng(7)
    ev = np.stack([rng.random(3000), rng.integers(-2, 14, 3000),
                   rng.integers(-2, 10, 3000), rng.integers(0, 2, 3000)], 1)
    np.testing.assert_array_equal(tdc.voxelize_events(ev, (8, 12), 4),
                                  jdc.voxelize_events(ev, (8, 12), 4))


def test_events_converter_writes_what_jax_writes(tmp_path):
    """The events converter on a tree of raw recordings (.npy and .npz,
    nested), through the function for JAX and the CLI subcommand for the
    port: the same frames."""
    rng = np.random.default_rng(3)
    src = tmp_path / "raw"
    for sub in ("training", "validation/day"):
        (src / sub).mkdir(parents=True)
        ev = np.stack([np.sort(rng.random(500)), rng.integers(0, 352, 500),
                       rng.integers(0, 200, 500), rng.integers(0, 2, 500)],
                      axis=1)
        np.save(src / sub / "drive0.npy", ev)
        np.savez(src / sub / "drive1.npz", events=ev[::2])
    assert jdc.convert_events_dir(str(src), str(tmp_path / "jax"),
                                  (200, 352), 4) == 4
    assert tdc.main(["events", str(src), str(tmp_path / "port")]) == 0
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert got == want and len(got) == 4
    frame = np.load(tmp_path / "port" / "training" / "drive0.npy")
    assert frame.shape == (200, 352, 2) and frame.dtype == np.uint8


@pytest.fixture(scope="module")
def ddd17_root(tmp_path_factory):
    """A seeded DDD17 tree at half the native resolution (the port's
    ``write_ddd17_tree``: raw events through the events converter)."""
    root = str(tmp_path_factory.mktemp("ddd17"))
    for i, split in enumerate(("training", "validation")):
        write_ddd17_tree(root, n=3, seed=i, split=split, hw=(100, 176),
                         events=60_000)
    return root


def test_ddd17_tree_loads_as_in_jax(ddd17_root):
    for split in ("train", "val"):
        want = jax_make_dataset("ddd17", ddd17_root, split)
        got = make_dataset("ddd17", ddd17_root, split)
        assert got.samples == want.samples and len(got) == 3
        for i in range(3):
            w, g = want.load(i), got.load(i)
            np.testing.assert_array_equal(g["image"], w["image"])
            np.testing.assert_array_equal(g["sem_seg"], w["sem_seg"])
            assert g["meta"] == w["meta"]
            assert g["image"].shape == (100, 176, 3)
            assert g["image"][..., 2].max() == 0 < g["image"][..., 0].max()


def test_ddd17_train_and_test_pipelines_match_jax(ddd17_root):
    """The train loader's batches (64x64 crops) and the eval batches at the
    non-square 176x100 scale, equal to JAX's."""
    kw = dict(crop_size=(64, 64), seed=2, num_workers=1)
    got, want = [], []
    for cls, mk, out in ((TrainLoader, make_dataset, got),
                         (JaxTrainLoader, jax_make_dataset, want)):
        loader = cls(mk("ddd17", ddd17_root, "train"), 2, **kw)
        it = iter(loader)
        out.extend(next(it) for _ in range(2))
        loader.close()
    for (gi, gs), (wi, ws) in zip(got, want):
        assert gi.shape == (2, 64, 64, 3) and gs.shape == (2, 64, 64)
        assert np.array_equal(gi, wi) and np.array_equal(gs, ws)
    ekw = dict(scale=(176, 100), size_divisor=32, bucket=0)
    want = list(jax_eval_batches(jax_make_dataset("ddd17", ddd17_root, "val"),
                                 **ekw))
    got = list(eval_batches(make_dataset("ddd17", ddd17_root, "val"), **ekw))
    assert len(got) == len(want) == 3
    for (gi, gs, gm), (wi, ws, wm) in zip(got, want):
        assert gi.shape[1] != gi.shape[2]          # non-square
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gs, ws)
        assert gm == wm


def test_ddd17_runs_through_the_eval_and_train_clis(ddd17_root, tmp_path,
                                                    capsys):
    """``data.dataset=ddd17`` with the flagship preset at tiny widths: the
    eval CLI scores the 3 val frames over 6 classes at the native aspect,
    the train CLI takes 2 steps and writes its checkpoint."""
    from spike2former_tpu_torch.tools import test as test_cli
    from spike2former_tpu_torch.tools import train as train_cli

    preset = "SDTv2_maskformer_DCNpixelDecoder_ade20k"
    opts = [*TINY_OPTS, "data.dataset='ddd17'", "model.num_classes=6"]
    assert test_cli.main([preset, "--device", "cpu", "--data-root",
                          ddd17_root, "--cfg-options", *opts,
                          "data.test_scale=(176,100)"]) == 0
    out = capsys.readouterr().out
    assert "images: 3" in out and "mIoU" in out
    wd = str(tmp_path / "wd")
    assert train_cli.main([
        preset, "--device", "cpu", "--data-root", ddd17_root, "--work-dir",
        wd, "--log-interval", "1", "--eval-images", "1", "--cfg-options",
        *opts, "data.crop_size=(64,64)", "data.batch_size=2",
        "data.num_workers=1", "train.total_iters=2",
        "train.checkpoint_interval=2", "train.val_interval=2",
        "train.warmup_iters=1", "train.matcher='host'"]) == 0
    assert os.path.exists(os.path.join(wd, "ckpt_2"))
