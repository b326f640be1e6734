"""The port's SDTv2 MaskFormer presets on Cityscapes, VOC 2012 and
COCO-Stuff: configs, ``DATASETS`` entries and label constants, the
converters of ``tools/dataset_converters.py`` and ``make_dataset`` on
seeded trees of those layouts, against the JAX package's (mirroring
tests/test_data.py), and the eval and train CLIs on a seeded Cityscapes
tree.  Everything compared here is integer or string data: equality."""
import dataclasses
import importlib.util
import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(__file__))

import numpy as np
import pytest
from PIL import Image

from spike2former_tpu.data import label_constants as jlabels
from spike2former_tpu.data.dataset import make_dataset as jax_make_dataset
from spike2former_tpu.data.metainfo import DATASETS as JAX_DATASETS
from spike2former_tpu.engine.config import get_config as jax_get_config
from spike2former_tpu_torch.data import label_constants
from spike2former_tpu_torch.data.dataset import make_dataset
from spike2former_tpu_torch.data.metainfo import DATASETS
from spike2former_tpu_torch.data.synthetic import (write_cityscapes_tree,
                                                   write_coco_stuff_tree)
from spike2former_tpu_torch.engine.config import PRESETS, get_config
from spike2former_tpu_torch.tools import dataset_converters

from torch_port_helpers import TINY

NEW_PRESETS = ("SDTv2_maskformer_DCNPixelDecoder_CityScapes",
               "SDTv2_Spike2former_voc_512x512",
               "SDTv2_maskformer_cocostuff10k_512x512",
               "SDTv2_maskformer_cocostuff164k_512x512")


def _jax_converters():
    spec = importlib.util.spec_from_file_location(
        "jax_dataset_converters", os.path.join(
            os.path.dirname(__file__), "..", "tools",
            "dataset_converters.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ("SDTv2_maskformer_DCNpixelDecoder_ade20k",)
                         + NEW_PRESETS
                         + ("SDTv2_maskformer_coco_panoptic",))
def test_preset_equals_jax_field_by_field(name):
    """Every field the port's config has, in every section, as JAX's
    preset of the same name sets it."""
    got, want = get_config(name), jax_get_config(name)
    assert (got.name, got.work_dir) == (want.name, want.work_dir)
    for section in ("model", "data", "train", "test"):
        g, w = getattr(got, section), getattr(want, section)
        for f in dataclasses.fields(g):
            assert getattr(g, f.name) == getattr(w, f.name), (
                section, f.name)


def test_the_port_has_every_sdtv2_maskformer_preset():
    assert set(NEW_PRESETS) < set(PRESETS)
    cs = get_config(NEW_PRESETS[0])
    assert (cs.model.num_classes, cs.data.crop_size, cs.data.test_scale,
            cs.data.batch_size) == (19, (512, 1024), (2048, 1024), 2)
    # both COCO-Stuff presets read the 164k layout, as JAX's do
    assert {get_config(n).data.dataset for n in NEW_PRESETS[2:]} == {
        "coco_stuff164k"}


def test_datasets_entries_equal_jax():
    assert set(DATASETS) == set(JAX_DATASETS)
    assert {"ade20k", "cityscapes", "voc2012", "coco_stuff164k"} < set(
        DATASETS)
    for name, meta in DATASETS.items():
        assert (dataclasses.asdict(meta)
                == dataclasses.asdict(JAX_DATASETS[name])), name
        assert meta.palette is None or meta.num_classes == len(meta.palette)


def test_label_constants_equal_jax():
    for name in ("ADE20K_PALETTE", "CITYSCAPES_PALETTE", "VOC_PALETTE",
                 "COCO_STUFF_CLASSES", "COCO_STUFF_PALETTE"):
        assert getattr(label_constants, name) == getattr(jlabels, name), name
    assert DATASETS["coco_stuff164k"].classes[0] == "person"
    assert len(DATASETS["cityscapes"].palette) == 19


def _pngs(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".png"):
                p = os.path.join(d, f)
                out[os.path.relpath(p, root)] = np.asarray(Image.open(p))
    return out


@pytest.mark.parametrize("kind", ["cityscapes", "coco_stuff"])
def test_converter_matches_jax(tmp_path, kind, capsys):
    """The same seeded tree converted by both: the same files, equal."""
    jconv = _jax_converters()
    src = str(tmp_path / "src")
    if kind == "cityscapes":
        write_cityscapes_tree(src, shapes=((64, 128), (48, 96)), seed=1)
        sub = "gtFine"
        jargs = ("_gtFine_labelIds.png", "_gtFine_labelTrainIds.png",
                 jconv.CITYSCAPES_LABEL2TRAIN)
    else:
        write_coco_stuff_tree(src, shapes=((48, 64), (64, 48)), seed=2)
        sub = "annotations"
        jargs = (".png", "_labelTrainIds.png", jconv._coco_lut())
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    shutil.copytree(src, a)
    shutil.copytree(src, b)
    assert jconv.convert_dir(os.path.join(a, sub), *jargs) == 2
    assert dataset_converters.main([kind, os.path.join(b, sub)]) == 0
    assert capsys.readouterr().out == "converted 2 files\n"
    want, got = _pngs(a), _pngs(b)
    assert set(got) == set(want)
    assert len(got) == {"cityscapes": 6, "coco_stuff": 4}[kind]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_voc_aug_converter_matches_jax(tmp_path, capsys):
    """SBD .mat class maps and VOC split lists: the same PNGs and
    trainaug list."""
    from scipy.io import savemat

    jconv = _jax_converters()
    for root in ("jax", "port"):
        cls_dir = tmp_path / root / "sbd" / "dataset" / "cls"
        sets = tmp_path / root / "voc" / "ImageSets" / "Segmentation"
        os.makedirs(cls_dir)
        os.makedirs(sets)
        for i, stem in enumerate(("2008_000001", "2008_000002",
                                  "2008_000003")):
            seg = np.random.default_rng(i).integers(
                0, 21, (12, 17)).astype(np.uint8)
            savemat(cls_dir / f"{stem}.mat",
                    {"GTcls": {"Segmentation": seg}})
        (sets / "train.txt").write_text("2007_000032\n2008_000001\n")
        (sets / "val.txt").write_text("2008_000002\n")
    n = jconv.convert_voc_aug(str(tmp_path / "jax" / "sbd"),
                              str(tmp_path / "jax" / "voc"))
    assert n == 3 and dataset_converters.main([
        "voc_aug", str(tmp_path / "port" / "sbd"),
        str(tmp_path / "port" / "voc")]) == 0
    assert capsys.readouterr().out == "converted 3 files\n"
    want, got = (_pngs(tmp_path / r / "voc") for r in ("jax", "port"))
    assert set(got) == set(want) and len(got) == 3
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    lists = [(tmp_path / r / "voc" / "ImageSets" / "Segmentation"
              / "trainaug.txt").read_text() for r in ("jax", "port")]
    assert lists[0] == lists[1] == "2007_000032\n2008_000001\n2008_000003\n"


@pytest.mark.parametrize("name", ["cityscapes", "coco_stuff164k", "voc2012"])
def test_make_dataset_on_the_new_layouts_matches_jax(tmp_path, name):
    """The converted trees (a VOC tree as written) list and load the same
    samples in both packages."""
    root = str(tmp_path / name)
    if name == "cityscapes":
        write_cityscapes_tree(root, shapes=((64, 128),) * 2, seed=3)
        dataset_converters.main(["cityscapes", os.path.join(root, "gtFine")])
    elif name == "coco_stuff164k":
        write_coco_stuff_tree(root, shapes=((48, 64),) * 2, seed=3)
        dataset_converters.main(["coco_stuff",
                                 os.path.join(root, "annotations")])
    else:
        rng = np.random.default_rng(3)
        for d in ("JPEGImages", "SegmentationClass"):
            os.makedirs(os.path.join(root, d))
        for i in range(2):
            Image.fromarray(rng.integers(0, 255, (40, 56, 3), np.uint8)).save(
                os.path.join(root, "JPEGImages", f"{i}.jpg"))
            Image.fromarray(rng.integers(0, 21, (40, 56), np.uint8)).save(
                os.path.join(root, "SegmentationClass", f"{i}.png"))
    ds, jds = make_dataset(name, root, "val"), jax_make_dataset(name, root,
                                                                "val")
    assert len(ds) == len(jds) == 2
    assert ds.samples == jds.samples
    for i in range(2):
        g, w = ds.load(i), jds.load(i)
        np.testing.assert_array_equal(g["image"], w["image"])
        np.testing.assert_array_equal(g["sem_seg"], w["sem_seg"])
        assert g["sem_seg"].max() < DATASETS[name].num_classes or (
            g["sem_seg"] == 255).any()


TINY_OPTS = [f"model.{k}={v!r}".replace(" ", "") for k, v in TINY.items()
             if k != "num_classes"]


def test_eval_and_train_clis_take_the_cityscapes_preset(tmp_path, capsys):
    """The port's CLIs on a seeded, converted Cityscapes tree with no new
    flag: the eval CLI scores 2 val images over 19 classes; the train CLI
    takes 2 steps on 64x128 crops and writes its checkpoint."""
    from spike2former_tpu_torch.tools import test as test_cli
    from spike2former_tpu_torch.tools import train as train_cli

    root = str(tmp_path / "cityscapes")
    for split in ("train", "val"):
        write_cityscapes_tree(root, shapes=((64, 128),) * 2, seed=5,
                              split=split, classes=(2, 4))
    dataset_converters.main(["cityscapes", os.path.join(root, "gtFine")])
    preset = NEW_PRESETS[0]
    assert test_cli.main([preset, "--device", "cpu", "--data-root", root,
                          "--cfg-options", *TINY_OPTS,
                          "data.test_scale=(128,64)"]) == 0
    out = capsys.readouterr().out
    assert "images: 2" in out and "mIoU" in out
    wd = str(tmp_path / "wd")
    assert train_cli.main([
        preset, "--device", "cpu", "--data-root", root, "--work-dir", wd,
        "--log-interval", "1", "--eval-images", "1", "--cfg-options",
        *TINY_OPTS, "data.crop_size=(64,128)", "data.batch_size=2",
        "data.num_workers=1", "train.total_iters=2",
        "train.checkpoint_interval=2", "train.val_interval=2",
        "train.warmup_iters=1", "train.matcher='host'"]) == 0
    assert os.path.exists(os.path.join(wd, "ckpt_2"))
