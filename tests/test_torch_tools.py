"""The port's tools (``tools/benchmark.py``, ``tools/export.py``,
``tools/confusion_matrix.py``, ``tools/print_config.py``,
``tools/publish_model.py``, ``tools/analyze_logs.py``,
``tools/browse_dataset.py``) and ``utils/flops.py``,
``utils/profiling.py`` on the CPU at tiny dims, against the JAX package's
tools where they compute the same thing.

Tolerances: FLOP counts exactly (integers); the exported program's logits
within 1e-6 of eager; the confusion matrix, the printed config, the log
summary and the rendered samples equal to JAX's.
"""
import contextlib
import importlib.util
import io
import json
import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from spike2former_tpu.data import eval_batches as jax_eval_batches
from spike2former_tpu.data import make_dataset as jax_make_dataset
from spike2former_tpu.engine import postprocess_pred as jax_postprocess
from spike2former_tpu.engine import whole_logits as jax_whole
from spike2former_tpu_torch import api
from spike2former_tpu_torch.api import InferenceModel
from spike2former_tpu_torch.data.dataset import make_dataset
from spike2former_tpu_torch.data.synthetic import synthetic_batch
from spike2former_tpu_torch.engine.checkpoint import save_state, wait_for_saves
from spike2former_tpu_torch.engine.config import PRESETS, get_config
from spike2former_tpu_torch.engine.logging import ScalarLogger
from spike2former_tpu_torch.models import layers as tl
from spike2former_tpu_torch.ops import dcnv3
from spike2former_tpu_torch.tools import (analyze_logs, benchmark,
                                          browse_dataset, confusion_matrix,
                                          export, print_config,
                                          publish_model)
from spike2former_tpu_torch.utils import flops, profiling

from torch_port_helpers import TINY, images, make_pair, write_ade_tree

PRESET = "SDTv2_maskformer_DCNpixelDecoder_ade20k"
OPTS = [f"model.{k}={v!r}".replace(" ", "") for k, v in TINY.items()]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name: str, argv: list[str]) -> str:
    """Run the JAX package's ``tools/{name}.py`` in this process; returns
    what it printed."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    saved, buf = sys.argv, io.StringIO()
    sys.argv = [name] + argv
    try:
        with contextlib.redirect_stdout(buf):
            mod.main()
    finally:
        sys.argv = saved
    return buf.getvalue()


def _port_tool(mod, argv: list[str]) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert mod.main(argv) == 0
    return buf.getvalue()


# --- utils/flops.py ----------------------------------------------------------

def test_dcn_sampling_flops_against_a_hand_count():
    """Batch 2 of 64x48 at stride 16 (a 4x3 map), G=4, Cg=2, P=9, one
    layer: 2 * 12 * 4 * 9 = 864 sampling sites; the forward does 16 per
    site and 8 per channel (864 * 32 = 27 648), the backward 44 and 16
    (864 * 76 = 65 664)."""
    kw = dict(num_layers=1, group=4, group_channels=2, points=9, stride=16)
    assert flops.dcn_sampling_flops(2, (64, 48), **kw) == 27648
    assert flops.dcn_sampling_flops(2, (64, 48), train=True, **kw) == (
        27648 + 65664)
    # six layers, and a map that rounds up (65x49 -> 5x4)
    assert flops.dcn_sampling_flops(2, (64, 48), **dict(kw, num_layers=6)
                                    ) == 6 * 27648
    assert flops.dcn_sampling_flops(1, (65, 49), **kw) == 20 * 4 * 9 * 32


def test_flop_counter_on_a_conv_and_a_linear():
    conv = tl.conv2d(6, 10, 3, stride=2, pad=1, groups=2)
    x = torch.randn(3, 16, 12, 6)                  # NHWC
    with FlopCounterMode(display=False) as fc:
        y = tl.conv_nhwc(conv, x)
    ho, wo = y.shape[1:3]
    assert (ho, wo) == (8, 6)
    assert fc.get_total_flops() == 2 * 3 * 10 * ho * wo * (6 // 2) * 3 * 3
    lin = tl.Linear(7, 5)
    assert flops.model_flops(lin, torch.randn(4, 11, 7)) == 2 * 4 * 11 * 7 * 5
    assert flops.count_params(lin) == 7 * 5 + 5


def test_the_sampler_is_not_counted_twice():
    """FlopCounterMode gives the plain sampler nothing (gathers and
    elementwise products), so adding ``dcn_sampling_flops`` counts the
    sampler once: a model's count is the same with the sampler swapped
    for zeros."""
    gen = torch.Generator().manual_seed(0)
    value = torch.randn(1, 8, 8, 16, generator=gen)
    py = torch.rand(1, 64, 4, 9, generator=gen) * 8
    with FlopCounterMode(display=False) as fc:
        dcnv3.dcnv3_sample(value, py, py.flip(-1), torch.rand_like(py))
    assert fc.get_total_flops() == 0
    pm = api.init_model(PRESET, overrides=OPTS, device="cpu").model
    x = torch.from_numpy(images((64, 64)))
    with_sampler = flops.model_flops(pm.predict_logits, x)
    real = dcnv3.dcnv3_sample
    dcnv3.dcnv3_sample = lambda v, py, px, m: v.new_zeros(
        (v.shape[0], py.shape[1], v.shape[3]))
    try:
        without = flops.model_flops(pm.predict_logits, x)
    finally:
        dcnv3.dcnv3_sample = real
    assert with_sampler == without > 0


def test_peak_comes_from_the_card_name():
    assert flops.peak_tflops("NVIDIA H100 80GB HBM3", "bfloat16") == 989.4
    assert flops.peak_tflops("NVIDIA H100 80GB HBM3", "float32") == 66.9
    with pytest.raises(KeyError, match="--peak-tflops"):
        flops.peak_tflops("NVIDIA A100-SXM4-80GB", "bfloat16")
    for path in ("tools/benchmark.py", "utils/flops.py"):
        with open(os.path.join(ROOT, "spike2former_tpu_torch", path)) as f:
            assert "197" not in f.read()


# --- utils/profiling.py ------------------------------------------------------

def test_profiling_helpers(tmp_path):
    logs = []
    with profiling.profile_time("block", log=logs.append):
        torch.ones(4).sum()
    assert len(logs) == 1 and logs[0].startswith("block: ")
    with profiling.trace(str(tmp_path)):
        with torch.profiler.record_function("marked"):
            torch.ones(8) @ torch.ones(8)
    events = json.load(open(tmp_path / "trace.json"))["traceEvents"]
    assert any(e.get("name") == "marked" for e in events)
    timer = profiling.IterTimer(window=2)
    for _ in range(3):
        assert timer.tick() >= 0
    assert len(timer.times) == 2 and timer.avg >= 0


# --- tools/benchmark.py ------------------------------------------------------

BENCH = ["--device", "cpu", "--num-iters", "2", "--warmup", "1",
         "--dtype", "float32", "--image-size", "64", "64", "--mfu",
         "--peak-tflops", "1.0", "--cfg-options", *OPTS]


@pytest.mark.parametrize("train", [False, True])
def test_benchmark_cli_on_the_cpu(train):
    argv = BENCH + (["--train", "--batch-size", "2"] if train else [])
    r = benchmark.run(benchmark._parser().parse_args(argv))
    assert r["ms"] > 0 and r["img_s"] > 0
    assert r["counted_flops"] > 0 and r["flops"] == (r["counted_flops"]
                                                     + r["dcn_flops"])
    kw = dict(num_layers=1, group=4, group_channels=4)
    assert r["dcn_flops"] == flops.dcn_sampling_flops(
        2 if train else 1, (64, 64), train=train, **kw)
    assert 0 < r["mfu"] < 1 and r["peak_tflops"] == 1.0
    line = benchmark.format_line(r)
    assert ("TRAIN" if train else "INFER") in line and "MFU" in line
    out = _port_tool(benchmark, argv)
    assert "ms/iter" in out and "TFLOP/" in out


def test_benchmark_train_flops_count_the_backward():
    """A step's counted FLOPs exceed twice a forward's (the backward)."""
    fwd = benchmark.run(benchmark._parser().parse_args(BENCH))
    step = benchmark.run(benchmark._parser().parse_args(
        BENCH + ["--train", "--batch-size", "1"]))
    assert step["counted_flops"] > 2 * fwd["counted_flops"]


def test_benchmark_mfu_on_the_cpu_needs_a_peak():
    argv = [a for a in BENCH if a not in ("--peak-tflops", "1.0")]
    with pytest.raises(SystemExit, match="peak-tflops"):
        benchmark.run(benchmark._parser().parse_args(argv))


# --- tools/export.py ---------------------------------------------------------

def test_export_round_trip_on_the_cpu(tmp_path):
    out = str(tmp_path / "tiny.pt2")
    text = _port_tool(export, [PRESET, "--device", "cpu", "--out", out,
                               "--batch-size", "2", "--cfg-options", *OPTS,
                               "data.crop_size=(64,96)"])
    assert "0 calls of spike2former::dcnv3_sample" in text
    assert os.path.getsize(out + ".txt") > 0
    program = torch.export.load(out)
    assert export.sampler_calls(program) == 0      # the plain path on the CPU
    im = api.init_model(PRESET, overrides=OPTS, device="cpu")
    x = torch.from_numpy(images((64, 96), b=2, seed=4))
    with torch.no_grad():
        want = im.model.predict_logits(x)
        got = program.module()(x)
    assert got.shape == (2, 64, 96, TINY["num_classes"])
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)


# --- tools/confusion_matrix.py -----------------------------------------------

def test_confusion_matrix_equals_jax(tmp_path):
    root = write_ade_tree(tmp_path / "ade", n=3, seed=2)
    opts = OPTS + ["data.test_scale=(128,96)"]
    jm, variables, pm = make_pair(TINY, seed=2)
    im = InferenceModel(get_config(PRESET, opts), pm, torch.device("cpu"))
    ds = make_dataset("ade20k", root, "val")
    got, n = confusion_matrix.confusion_matrix(im, ds, max_images=50)
    # JAX's tools/confusion_matrix.py loop on the same weights
    k = TINY["num_classes"]
    want = np.zeros((k, k), np.int64)
    for images_, sem, metas in jax_eval_batches(
            jax_make_dataset("ade20k", root, "val"), scale=(128, 96),
            size_divisor=32):
        logits = jax_whole(jm, variables, jnp.asarray(images_))
        pred = np.asarray(jax_postprocess(
            logits, metas[0].get("pad_shape"), metas[0]["ori_shape"]))
        gt = np.asarray(sem)
        valid = gt != 255
        idx = gt[valid] * k + pred[valid]
        want += np.bincount(idx.reshape(-1), minlength=k * k).reshape(k, k)
    assert n == 3 and want.sum() > 0
    np.testing.assert_array_equal(got, want)
    out = str(tmp_path / "cm.csv")
    text = _port_tool(confusion_matrix, [
        PRESET, "--device", "cpu", "--data-root", root, "--out", out,
        "--cfg-options", *opts])
    assert text.startswith("3 images; pixel accuracy")
    assert np.loadtxt(out, delimiter=",", dtype=np.int64).shape == (k, k)


# --- tools/print_config.py ---------------------------------------------------

@pytest.mark.parametrize("name", sorted(PRESETS))
def test_print_config_json_equals_jax(name):
    """Every key the port's config has is JAX's, with JAX's value; the
    keys the port lacks are those of parts not ported (``kind``,
    ``masked_attention``, ...)."""
    got = json.loads(_port_tool(print_config, [name, "--json"]))
    want = json.loads(_jax_tool("print_config", [name, "--json"]))
    for section, values in got.items():
        if isinstance(values, dict):
            for k, v in values.items():
                assert want[section][k] == v, (section, k)
        else:
            assert want[section] == values, section
    listing = _port_tool(print_config, []).split()
    assert listing == sorted(PRESETS)


# --- tools/publish_model.py --------------------------------------------------

def test_published_checkpoint_loads_through_init_model(tmp_path):
    tr = api.init_trainer(PRESET, OPTS + ["train.warmup_iters=1"],
                          device="cpu", seed=2)
    api.train_steps(tr, [synthetic_batch(np.random.default_rng(0), 2,
                                         (64, 64), num_classes=4)])
    save_state(str(tmp_path), tr.state, 1)
    wait_for_saves()
    ckpt = str(tmp_path / "ckpt_1")
    text = _port_tool(publish_model, [PRESET, ckpt,
                                      str(tmp_path / "pub" / "tiny.pth"),
                                      "--cfg-options", *OPTS])
    path = text.split()[1]
    assert os.path.basename(path).startswith("tiny-") and path.endswith(
        ".pth")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    assert set(sd) == set(tr.state.model.state_dict())
    assert os.path.basename(path)[5:13] == publish_model.content_hash(sd)[:8]
    im = api.init_model(PRESET, path, OPTS, device="cpu")
    x = torch.from_numpy(images((64, 64)))
    with torch.no_grad():
        want = tr.state.model.eval().predict_logits(x)
        got = im.model.predict_logits(x)
    assert torch.equal(got, want)


# --- tools/analyze_logs.py ---------------------------------------------------

def test_analyze_logs_equals_jax(tmp_path):
    log = ScalarLogger(str(tmp_path))
    rng = np.random.default_rng(0)
    for step in range(1, 8):
        log.log(step, total=float(rng.uniform(1, 5)),
                loss_cls=float(rng.uniform(0, 2)), grad_norm=1.0)
    log.close()
    path = str(tmp_path / "scalars.jsonl")
    argv = [path, "--keys", "total", "loss_cls", "missing", "--window", "3"]
    got = _port_tool(analyze_logs, argv)
    assert got == _jax_tool("analyze_logs", argv)
    assert "avg(last 3)" in got and "avg sec/step" in got


# --- tools/browse_dataset.py -------------------------------------------------

def test_browse_dataset_renders_jax_samples(tmp_path):
    root = write_ade_tree(tmp_path / "ade", n=3, seed=3)
    argv = ["--data-root", root, "--num", "3", "--seed", "4",
            "--cfg-options", "data.crop_size=(64,64)"]
    got_dir, want_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    text = _port_tool(browse_dataset, [PRESET, "--out-dir", got_dir] + argv)
    assert text == _jax_tool("browse_dataset",
                             [PRESET, "--out-dir", want_dir] + argv)
    names = sorted(os.listdir(want_dir))
    assert names == sorted(os.listdir(got_dir)) and len(names) == 6
    from PIL import Image

    for n in names:
        np.testing.assert_array_equal(
            np.asarray(Image.open(os.path.join(got_dir, n))),
            np.asarray(Image.open(os.path.join(want_dir, n))))
