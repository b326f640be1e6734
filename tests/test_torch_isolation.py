"""The port stands alone: it imports no JAX, flax, optax or
``spike2former_tpu``, and never runs on the CPU unless asked to."""
import importlib
import os
import pkgutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import spike2former_tpu_torch
from spike2former_tpu_torch import api
from spike2former_tpu_torch.device import f32_precision, resolve_device
from spike2former_tpu_torch.ops import dcnv3

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESET = "SDTv2_maskformer_DCNpixelDecoder_ade20k"


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        spike2former_tpu_torch.__path__, "spike2former_tpu_torch."))


def test_port_and_chip_smoke_import_without_jax():
    """A subprocess whose import system refuses jax, flax, optax,
    spike2former_tpu and h5py (which only ``lava_exchange.export_hdf5``
    imports, when it is called) still imports every port module and
    chip_smoke, and runs chip_smoke's reference-format state dict (which
    reads ``tests/torch_golden.py``)."""
    modules = _port_modules() + ["chip_smoke"]
    for name in ("ops.dcnv3", "ops.spike_op", "losses.losses",
                 "losses.matcher", "losses.criterion", "engine.train",
                 "engine.optim", "data.loader", "data.transforms",
                 "engine.checkpoint",
                 "engine.logging", "evaluation.visualize", "tools.train",
                 "tools.test", "utils.firing", "tools.cal_firing_num",
                 "evaluation.tta", "losses.point_sample",
                 "evaluation.cityscapes_metric", "tools.dataset_converters",
                 "data.label_constants", "serving", "tools.benchmark",
                 "tools.export", "tools.confusion_matrix",
                 "tools.analyze_logs", "tools.print_config",
                 "tools.publish_model", "tools.browse_dataset",
                 "utils.flops", "utils.profiling", "data.panoptic",
                 "evaluation.panoptic", "models.dab_detr", "ops.neuron",
                 "models.fpn", "models.msresnet", "models.cascade",
                 "models.tebn", "losses.pixel", "ops.msda",
                 "models.deformable", "ops.dcnv3_grouped",
                 "data.synthetic", "parallel", "parallel.mesh",
                 "parallel.tp", "parallel.spatial",
                 "models.spikeformer_lib", "models.cyclemlp", "ops.rnn",
                 "ops.encoding", "ann2snn", "lava_exchange",
                 "data.biomedical", "runtime", "tools.burnin",
                 "tools.learning_run", "tools.make_learning_report",
                 "tools.make_synth_dataset"):
        assert f"spike2former_tpu_torch.{name}" in modules
    code = textwrap.dedent(f"""
        import importlib, importlib.abc, sys

        BLOCKED = ("jax", "jaxlib", "flax", "optax", "spike2former_tpu",
                   "h5py")

        class Refuse(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"blocked import of {{name}}")
                return None

        sys.meta_path.insert(0, Refuse())
        for name in {modules!r}:
            importlib.import_module(name)
        sd = importlib.import_module("chip_smoke").golden_state_dict()
        assert sd and all(hasattr(v, "shape") for v in sd.values())
        leaked = sorted(m for m in sys.modules
                        if m.split(".")[0] in BLOCKED)
        assert not leaked, leaked
        print("imported", len({modules!r}))
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert f"imported {len(modules)}" in proc.stdout


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.init_model(PRESET, overrides=["model.num_encoder_layers=1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.init_trainer(PRESET, overrides=["model.num_encoder_layers=1"])
    assert resolve_device("cpu") == torch.device("cpu")


def test_inferencer_and_firing_cli_raise_without_cuda(monkeypatch, tmp_path):
    """The batch Inferencer and the firing CLI run on the card unless the
    CPU is asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.Inferencer(PRESET, overrides=["model.num_encoder_layers=1"])
    from spike2former_tpu_torch.tools import cal_firing_num

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cal_firing_num.main([PRESET, "--data-root", str(tmp_path),
                             "--out", str(tmp_path / "rates"),
                             "--cfg-options", "model.num_encoder_layers=1"])


def test_serving_and_tools_raise_without_cuda(monkeypatch, tmp_path):
    """The ServingEngine, the benchmark, export and confusion-matrix CLIs
    run on the card unless the CPU is asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from spike2former_tpu_torch.serving import ServingEngine
    from spike2former_tpu_torch.tools import (benchmark, confusion_matrix,
                                              export)

    opts = ["--cfg-options", "model.num_encoder_layers=1"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(PRESET, overrides=["model.num_encoder_layers=1"])
    for main, argv in (
            (benchmark.main, [PRESET, "--num-iters", "1"]),
            (export.main, [PRESET, "--out", str(tmp_path / "m.pt2")]),
            (confusion_matrix.main, [PRESET, "--data-root",
                                     str(tmp_path)])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(argv + opts)


def test_training_tools_raise_without_cuda(monkeypatch, tmp_path):
    """The burn-in and the learning run run on the card unless the CPU is
    asked for; neither writes anything first."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from spike2former_tpu_torch.tools import burnin, learning_run

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        burnin.main(["--tiny", "--steps", "1",
                     "--work-dir", str(tmp_path / "b")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        learning_run.main(["--iters", "1", "--data-root",
                           str(tmp_path / "data"), "--work-dir",
                           str(tmp_path / "wd")])
    assert not os.listdir(tmp_path)


def test_chip_smoke_fails_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sys.path.insert(0, REPO)
    try:
        chip_smoke = importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(REPO)
    assert chip_smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out


def test_trainer_rejects_unported_matcher():
    """The preset trains as the JAX preset does (the on-device auction
    matcher with ``compact_gt=32``); a matcher name that neither package
    has is still rejected."""
    tr = api.init_trainer(PRESET, overrides=["model.num_encoder_layers=1"],
                          device="cpu")
    assert (tr.cfg.train.matcher, tr.cfg.train.compact_gt) == ("auction", 32)
    with pytest.raises(ValueError, match="matcher must be"):
        api.init_trainer(PRESET, overrides=["train.matcher='sinkhorn'"],
                         device="cpu")


def test_trainer_draws_weights_from_train_seed():
    """``train.seed`` picks the weights; the ``seed`` argument, when
    passed, overrides it."""
    opts = ["model.num_classes=5", "model.embed_dim=(8,16,24,32)",
            "model.backbone_heads=4", "model.feat_channels=16",
            "model.num_queries=4", "model.num_decoder_layers=1",
            "model.num_encoder_layers=1", "model.depths_stage3=1",
            "model.depths_stage4=1", "model.dcn_group=4"]

    def weights(overrides, **kw):
        tr = api.init_trainer(PRESET, opts + overrides, device="cpu", **kw)
        return tr.state.model.state_dict()

    default, five = weights([]), weights(["train.seed=5"])
    assert any(not torch.equal(default[k], five[k]) for k in default)
    for k, v in weights([], seed=5).items():
        assert torch.equal(v, five[k]), k
    for k, v in weights(["train.seed=5"], seed=0).items():
        assert torch.equal(v, default[k]), k


def test_cpu_tensor_takes_plain_sampler_without_counting():
    rng = np.random.default_rng(0)
    value = torch.from_numpy(rng.normal(size=(1, 4, 5, 8)).astype(np.float32))
    py, px, mask = (torch.from_numpy(rng.uniform(-1, 5, (1, 20, 2, 9))
                                     .astype(np.float32)) for _ in range(3))
    before = dcnv3.dcnv3_sample.launches
    out = dcnv3.dcnv3_sample(value, py, px, mask)
    assert dcnv3.dcnv3_sample.launches == before
    torch.testing.assert_close(
        out, dcnv3.dcnv3_sample_reference(value, py, px, mask))


@pytest.mark.parametrize("flags", [(False, True), (True, True),
                                   (False, False)])
def test_f32_precision_turns_tf32_off_and_restores_the_callers_flags(flags):
    """The entry points' precision policy: inside, TF32 is off for
    matmuls and cuDNN; on the way out, even through an exception, the
    caller's flags are back, torch's default (cuDNN on) among them."""
    def read():
        return (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)

    saved = read()
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 \
        = flags
    try:
        with pytest.raises(KeyError):
            with f32_precision():
                assert read() == (False, False)
                raise KeyError
        assert read() == flags
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = saved
