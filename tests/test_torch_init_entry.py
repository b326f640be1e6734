"""Every entry point of the port that starts without weights draws them by
flax's laws (``engine/weights.py``), with its JAX counterpart's seed:
``api.init_model`` (seed 0, JAX's ``PRNGKey(0)``), ``api.init_trainer``
and the train CLI (``train.seed``), the burn-in tool (seed 0) and, from
``fast_init_``, the benchmark tool (``fast_variables``' seed 0).  The
laws' constants show in each: the DCN offset and mask kernels 0, the
layer-scale gammas 1e-6, BN statistics 0 and 1.  Port only, tiny widths.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

import pytest
import torch

from spike2former_tpu_torch import api
from spike2former_tpu_torch.engine.config import build_model, get_config
from spike2former_tpu_torch.engine.weights import fast_init_, init_weights_
from spike2former_tpu_torch.models.layers import BatchNorm, BNAndPad
from spike2former_tpu_torch.tools import benchmark, burnin
from spike2former_tpu_torch.tools import train as train_cli

from torch_port_helpers import TINY

PRESET = "SDTv2_maskformer_DCNpixelDecoder_ade20k"
OPTS = [f"model.{k}={v!r}".replace(" ", "") for k, v in TINY.items()]
DCN = "head.pixel_decoder.encoder_0.dcn."


def assert_flax_constants(model: torch.nn.Module):
    """The laws' constants in ``model`` (a flagship-layout model)."""
    sd = model.state_dict()
    for name in ("offset_conv.weight", "mask_conv.weight",
                 "offset_conv.bias", "mask_conv.bias"):
        assert not sd[DCN + name].any(), name
    for i in (1, 2, 3):
        g = sd[f"head.pixel_decoder.encoder_0.gamma{i}"]
        assert torch.equal(g, torch.full_like(g, 1e-6))
    bns = [m for m in model.modules() if isinstance(m, (BatchNorm, BNAndPad))]
    assert bns
    for m in bns:
        assert not m.mean.any() and torch.equal(m.var, torch.ones_like(m.var))
        assert torch.equal(m.scale, torch.ones_like(m.scale))
    # a random leaf of flax's normal(1.0)
    assert 0.7 < float(sd["head.query_feat"].std()) < 1.3


def test_init_model_draws_flax_laws_from_seed_0():
    im = api.init_model(PRESET, overrides=OPTS, device="cpu")
    assert_flax_constants(im.model)
    want = init_weights_(build_model(get_config(PRESET, OPTS).model), 0)
    for k, v in want.state_dict().items():
        assert torch.equal(im.model.state_dict()[k], v), k


def test_init_trainer_draws_flax_laws_from_train_seed():
    cfg = get_config(PRESET, OPTS + ["train.seed=7"])
    tr = api.init_trainer(cfg, device="cpu")
    assert_flax_constants(tr.state.model)
    want = init_weights_(build_model(cfg.model), 7).state_dict()
    got = tr.state.model.state_dict()
    assert all(torch.equal(got[k], v) for k, v in want.items())
    other = api.init_trainer(cfg, device="cpu", seed=8).state.model
    assert not torch.equal(other.state_dict()["head.query_feat"],
                           got["head.query_feat"])


class _Stop(Exception):
    pass


def test_the_train_cli_starts_from_flax_laws(tmp_path, monkeypatch):
    """The CLI's state as ``init_trainer`` hands it over, before any
    step (the spy stops the CLI there)."""
    seen = {}
    real = train_cli.init_trainer

    def spy(cfg, **kw):
        seen["model"] = real(cfg, **kw).state.model
        raise _Stop
    monkeypatch.setattr(train_cli, "init_trainer", spy)
    cfg = get_config(PRESET, OPTS + ["train.seed=3"])
    with pytest.raises(_Stop):
        train_cli.train(cfg, str(tmp_path), device="cpu")
    assert_flax_constants(seen["model"])
    want = init_weights_(build_model(cfg.model), 3).state_dict()
    got = seen["model"].state_dict()
    assert all(torch.equal(got[k], v) for k, v in want.items())


def test_burnin_starts_from_flax_laws_at_seed_0():
    args = burnin.parser().parse_args(["--tiny", "--device", "cpu",
                                       "--dtype", "float32"])
    state = burnin.new_state(args, torch.device("cpu"), 0)
    assert_flax_constants(state.model)
    want = init_weights_(burnin.build_model(args), 0).state_dict()
    got = state.model.state_dict()
    assert all(torch.equal(got[k], v) for k, v in want.items())


@pytest.mark.parametrize("train", [False, True])
def test_benchmark_takes_fast_init(monkeypatch, train):
    """The benchmark's weights are ``fast_init_``'s (seed 0): every BN
    variance 1, every other floating entry with an axis from N(0, 0.05)."""
    seen = {}
    for name in ("init_model", "init_trainer"):
        real = getattr(benchmark, name)

        def spy(cfg, real=real, **kw):
            seen["sd"] = kw["state_dict"]
            return real(cfg, **kw)
        monkeypatch.setattr(benchmark, name, spy)
    argv = ["--device", "cpu", "--dtype", "float32", "--image-size", "64",
            "64", "--num-iters", "1", "--warmup", "0", "--batch-size", "2",
            "--cfg-options", *OPTS]
    benchmark.run(benchmark._parser().parse_args(
        argv + (["--train"] if train else [])))
    cfg = get_config(PRESET, OPTS)
    want = fast_init_(build_model(cfg.model), 0).state_dict()
    assert set(seen["sd"]) == set(want)
    assert all(torch.equal(seen["sd"][k], v) for k, v in want.items())
    var = [v for k, v in want.items() if k.endswith(".var")]
    assert var and all(torch.equal(v, torch.ones_like(v)) for v in var)
    q = want["head.query_feat"]
    assert abs(float(q.std()) - 0.05) < 0.01


def test_the_profilers_keep_the_test_draw():
    """``profile_request`` and ``profile_train`` (card only) draw
    ``randomize_`` explicitly, so their numbers stay comparable with the
    earlier ones: their sources are read."""
    import inspect

    from spike2former_tpu_torch import profile_request, profile_train
    for mod in (profile_request, profile_train):
        assert "randomize_(" in inspect.getsource(mod.main)
