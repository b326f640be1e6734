"""The port's train state on the CPU: checkpoints (save, restore, resume,
retention, the eval CLI's ``--checkpoint``), the optimizer's
``load_state_dict`` and layer-wise decay, and ``auto_scale_lr``.

Against the JAX package: the layer-decay scale of every parameter,
through ``engine/convert.py``'s name map, exactly; three AdamW updates
with ``layer_decay_rate=0.9`` at a rate of 0.1, 2e-6 absolute
(``tests/test_torch_losses.py``'s optimizer tolerance); the retention and
latest-checkpoint choices on the same listings, exactly.  Save, restore
and resume are exact (``torch.equal``)."""
import sys
import os

sys.path.insert(0, os.path.dirname(__file__))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spike2former_tpu.engine import checkpoint as jckpt
from spike2former_tpu.engine.optim import (layerwise_decay_scales,
                                           make_optimizer)
from spike2former_tpu.models import Spike2Former as JaxSpike2Former
from spike2former_tpu_torch import api
from spike2former_tpu_torch.data.dataset import make_dataset
from spike2former_tpu_torch.data.synthetic import synthetic_batch
from spike2former_tpu_torch.engine import checkpoint as ckpt
from spike2former_tpu_torch.engine.config import get_config
from spike2former_tpu_torch.engine.convert import from_jax_variables
from spike2former_tpu_torch.engine.optim import AdamW, layerwise_decay_scale
from spike2former_tpu_torch.engine.train import scaled_base_lr
from spike2former_tpu_torch.models.segmentor import Spike2Former
from spike2former_tpu_torch.tools import test as eval_cli

from torch_port_helpers import TINY, write_ade_tree

PRESET = "SDTv2_maskformer_DCNpixelDecoder_ade20k"
OPTS = [f"model.{k}={v!r}".replace(" ", "") for k, v in TINY.items()]


def _trainer(extra=()):
    return api.init_trainer(PRESET, OPTS + ["train.warmup_iters=1",
                                            *extra], device="cpu", seed=2)


def _batches(n, seed=0):
    """Maps of at most 4 classes for TINY's 4 queries (the auction
    assumes no more valid slots than queries)."""
    rng = np.random.default_rng(seed)
    return [synthetic_batch(rng, 2, (64, 64), num_classes=4, classes=(2, 4))
            for _ in range(n)]


def _state_tensors(state):
    return {"model": dict(state.model.state_dict()),
            **{k: dict(v) for k, v in state.optimizer.state_dict().items()
               if k != "count"},
            "count": state.optimizer.count, "step": state.step}


def _assert_equal_state(got, want):
    assert got["count"] == want["count"] and got["step"] == want["step"]
    for part in ("model", "mu", "nu"):
        assert got[part].keys() == want[part].keys()
        for k in want[part]:
            assert torch.equal(got[part][k], want[part][k]), (part, k)


def test_save_and_restore_round_trip_exactly(tmp_path):
    tr = _trainer()
    api.train_steps(tr, _batches(2))
    want = {k: ({n: t.clone() for n, t in v.items()}
                if isinstance(v, dict) else v)
            for k, v in _state_tensors(tr.state).items()}
    path = ckpt.save_state(str(tmp_path), tr.state, tr.state.step, wait=True)
    assert path == str(tmp_path / "ckpt_2") and os.path.isfile(path)
    # what was saved is the state at its step, not what later steps made
    api.train_steps(tr, _batches(1, seed=5))
    fresh = _trainer(["train.seed=9"])
    ckpt.restore_state(path, fresh.state)
    _assert_equal_state(_state_tensors(fresh.state), want)
    assert len(want["model"]) > len(list(fresh.state.model.parameters()))
    assert any(not torch.equal(tr.state.model.state_dict()[k], v)
               for k, v in want["model"].items())
    # the format is plain tensors, ints and dicts
    raw = torch.load(path, weights_only=True)
    assert set(raw) == {"step", "model", "optimizer"} and raw["step"] == 2


def test_resume_is_bitwise_equal_to_an_uninterrupted_run(tmp_path):
    """2 steps, save, restore into a fresh trainer, 1 step == 3 steps."""
    batches = _batches(3)
    straight = _trainer()
    api.train_steps(straight, batches)
    first = _trainer()
    api.train_steps(first, batches[:2])
    path = ckpt.save_state(str(tmp_path), first.state, 2, wait=True)
    resumed = _trainer(["train.seed=7"])
    ckpt.restore_state(path, resumed.state)
    assert resumed.state.step == 2
    m = api.train_steps(resumed, batches[2:])
    assert np.isfinite(m[0]["total"])
    _assert_equal_state(_state_tensors(resumed.state),
                        _state_tensors(straight.state))


def test_async_save_keeps_the_newest_and_skips_one_in_flight(tmp_path):
    tr = _trainer()
    wd = str(tmp_path)
    for step in (1, 2, 3):
        ckpt.save_state(wd, tr.state, step, keep=2)
    ckpt.wait_for_saves()
    assert sorted(os.listdir(wd)) == ["ckpt_2", "ckpt_3"]
    open(os.path.join(wd, "ckpt_9.tmp"), "w").close()   # a save in flight
    assert ckpt.latest_checkpoint(wd) == os.path.join(wd, "ckpt_3")
    ckpt.save_state(wd, tr.state, 4, wait=True, keep=1)
    assert sorted(os.listdir(wd)) == ["ckpt_4", "ckpt_9.tmp"]


LISTINGS = [["ckpt_1", "ckpt_10", "ckpt_2", "other", "ckpt_3.tmp"],
            ["ckpt_5"], [], ["ckpt_20", "ckpt_7", "ckpt_100", "ckpt_x"]]


@pytest.mark.parametrize("names", LISTINGS)
@pytest.mark.parametrize("keep", [-1, 0, 1, 2, 5])
def test_prune_and_latest_match_jax_on_the_same_listing(tmp_path, names,
                                                         keep):
    """The JAX functions read only names: JAX's directory holds them as
    directories, the port's as files."""
    wj, wt = tmp_path / "jax", tmp_path / "port"
    for d in (wj, wt):
        d.mkdir()
    for n in names:
        (wj / n).mkdir()
        (wt / n).touch()
    assert ckpt.latest_checkpoint(str(wt)) == (
        None if jckpt.latest_checkpoint(str(wj)) is None
        else os.path.join(str(wt), os.path.basename(
            jckpt.latest_checkpoint(str(wj)))))
    protect = {os.path.abspath(str(wt / "ckpt_2"))}
    got = ckpt.prune_checkpoints(str(wt), keep, protect=protect)
    want = jckpt.prune_checkpoints(
        str(wj), keep, protect={os.path.abspath(str(wj / "ckpt_2"))})
    assert [os.path.basename(p) for p in got] == [
        os.path.basename(p) for p in want]
    assert sorted(os.listdir(wt)) == sorted(os.listdir(wj))


def test_eval_cli_and_init_model_load_a_train_checkpoint(tmp_path, capsys):
    """``--checkpoint`` and ``init_model(checkpoint=...)`` take a train
    checkpoint and a bare state dict alike; ``--show-dir`` writes one
    overlay an image."""
    tr = _trainer()
    api.train_steps(tr, _batches(1))
    path = ckpt.save_state(str(tmp_path / "wd"), tr.state, 1, wait=True)
    bare = str(tmp_path / "bare.pt")
    torch.save(tr.state.model.state_dict(), bare)
    root = write_ade_tree(tmp_path / "ade", n=2, num_labels=5)
    opts = OPTS + ["data.test_scale=(128,96)", "test.bucket=64"]
    cfg = get_config(PRESET, list(opts))
    want = eval_cli.evaluate(
        api.init_model(cfg, state_dict=tr.state.model.state_dict(),
                       device="cpu"), make_dataset("ade20k", root, "val"))
    line = (f"mIoU {want['mIoU']:.2f}  mAcc {want['mAcc']:.2f}  "
            f"aAcc {want['aAcc']:.2f}")
    for source in (path, bare):
        im = api.init_model(cfg, source, device="cpu")
        for k, v in tr.state.model.state_dict().items():
            assert torch.equal(im.model.state_dict()[k], v), k
        show = tmp_path / f"show_{os.path.basename(source)}"
        assert eval_cli.main([PRESET, "--data-root", root, "--checkpoint",
                              source, "--show-dir", str(show), "--device",
                              "cpu", "--cfg-options", *opts]) == 0
        assert capsys.readouterr().out.splitlines()[-2:] == ["images: 2",
                                                             line]
        assert sorted(os.listdir(show)) == ["pred_00000.png",
                                            "pred_00001.png"]
    with pytest.raises(ValueError, match="not both"):
        api.init_model(cfg, path, device="cpu",
                       state_dict=tr.state.model.state_dict())


def test_optimizer_load_state_dict_checks_names():
    tr = _trainer()
    sd = tr.state.optimizer.state_dict()
    sd = dict(sd, mu={k + "x": v for k, v in sd["mu"].items()})
    with pytest.raises(KeyError, match="names differ"):
        tr.state.optimizer.load_state_dict(sd)


DEEP = dict(TINY, depths_stage3=6, depths_stage4=2, num_encoder_layers=2,
            num_decoder_layers=2)


@pytest.fixture(scope="module")
def deep_shapes():
    """The JAX parameter tree (shapes) at the flagship's depths (6 and 2
    blocks in stages 3 and 4) and tiny widths."""
    jm = JaxSpike2Former(T=1, **DEEP)
    return jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 64, 64, 3), jnp.float32))["params"]


def test_layer_decay_scales_match_jax_per_parameter(deep_shapes):
    """Every parameter of the port gets the scale that JAX gives the flax
    path it is converted from."""
    shapes = deep_shapes
    scales = layerwise_decay_scales(shapes, 0.9)
    want = from_jax_variables({"params": jax.tree_util.tree_map(
        lambda s, x: np.full(x.shape, s, np.float32), scales, shapes)})
    names = [n for n, _ in Spike2Former(T=1, **DEEP).named_parameters()]
    assert sorted(names) == sorted(want)
    got = {n: np.float32(layerwise_decay_scale(n, 0.9)) for n in names}
    for n in names:
        assert np.all(want[n].numpy() == got[n]), (n, got[n])
    assert len(set(got.values())) == 11
    assert all(got[n] == 1 for n in names if not n.startswith("backbone"))


def test_adamw_with_layer_decay_matches_jax(deep_shapes):
    """Three updates (one under the clip norm, two over it) of every
    parameter of the deep tiny model, with layer decay 0.9 after the
    backbone's x0.1; the decay moves exactly the parameters it scales."""
    rng = np.random.default_rng(4)
    shapes = deep_shapes

    def tree(scale):
        return jax.tree_util.tree_map(
            lambda x: (rng.normal(size=x.shape) * scale).astype(np.float32),
            shapes)

    params, grads = tree(1.0), [tree(1e-4), tree(1.0), tree(5.0)]
    kw = dict(base_lr=0.1, weight_decay=0.05, backbone_lr_mult=0.1,
              clip_norm=0.01, warmup_iters=2, total_iters=10,
              layer_decay_rate=0.9)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tx = make_optimizer(jp, **kw)
    state = tx.init(jp)

    @jax.jit
    def update(g, state, p):
        upd, state = tx.update(g, state, p)
        return jax.tree_util.tree_map(lambda a, b: a + b, p, upd), state

    tp = {k: torch.nn.Parameter(v)
          for k, v in from_jax_variables({"params": params}).items()}
    opt = AdamW(tp.items(), **kw)
    plain = {k: torch.nn.Parameter(v.detach().clone())
             for k, v in tp.items()}
    opt_plain = AdamW(plain.items(), **dict(kw, layer_decay_rate=None))
    for g in grads:
        jp, state = update(jax.tree_util.tree_map(jnp.asarray, g), state,
                           jp)
        tg = from_jax_variables({"params": g})
        for ps, o in ((tp, opt), (plain, opt_plain)):
            for k, p in ps.items():
                p.grad = tg[k]
            o.step()
    want = from_jax_variables({"params": jax.tree_util.tree_map(
        np.asarray, jp)})
    start = from_jax_variables({"params": params})
    decayed = 0
    for k, p in tp.items():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                   rtol=0, atol=2e-6, err_msg=k)
        assert (p.detach() - start[k]).abs().max() > 1e-5, k
        decayed += bool((p - plain[k]).abs().max() > 1e-5)
    assert decayed == sum(layerwise_decay_scale(k, 0.9) < 1 for k in tp)
    assert opt.count == 3


@pytest.mark.parametrize("opts,want", [
    ([], 1e-3),
    (["train.auto_scale_lr=True"], 1e-3 * 6 / 48),
    (["train.auto_scale_lr=True", "data.batch_size=16",
      "train.accum_steps=3"], 1e-3),
    (["train.auto_scale_lr=True", "train.auto_scale_lr_base_batch=12",
      "train.base_lr=2e-4"], 2e-4 / 2)])
def test_auto_scale_lr(opts, want):
    """The linear scaling rule: base_lr x batch x accum / base batch, the
    JAX CLI's arithmetic; the trainer's schedule runs at it."""
    cfg = get_config(PRESET, OPTS + opts)
    assert scaled_base_lr(cfg) == pytest.approx(want, rel=1e-15)
    t = cfg.train
    if not t.auto_scale_lr:
        assert scaled_base_lr(cfg) == t.base_lr
    tr = api.init_trainer(cfg, device="cpu")
    assert tr.state.optimizer.schedule(t.warmup_iters) == pytest.approx(
        want, rel=1e-12)


def test_new_config_keys_have_the_jax_defaults():
    from spike2former_tpu.engine.config import get_config as jax_get_config

    want, got = jax_get_config(PRESET), get_config(PRESET)
    for part, keys in (("data", ("num_workers", "mosaic_prob", "cache")),
                       ("train", ("auto_scale_lr", "auto_scale_lr_base_batch",
                                  "val_interval", "checkpoint_interval",
                                  "max_keep_ckpts", "layer_decay_rate"))):
        for k in keys:
            assert getattr(getattr(got, part), k) == getattr(
                getattr(want, part), k), (part, k)
    assert got.work_dir == want.work_dir
    with pytest.raises(AttributeError, match="unknown config key"):
        get_config(PRESET, ["model.kind='fpn'"])
    # the backbone variants are ported; an unknown one is refused
    assert get_config(PRESET, ["model.variant='sdtv3'"]).model.variant == \
        "sdtv3"
    with pytest.raises(ValueError, match="unknown backbone variant"):
        Spike2Former(variant="msresnet18", **TINY)
