"""The port's FPN-family train step (``engine/train.py:
make_train_step_fpn``) and its eval and train CLIs against the JAX
package's on the CPU, at the tiny widths of ``test_torch_fpn.py``.

The step takes the (ce, lovasz, ohem) decode-loss spec of
``tests/test_train_and_eval.py``.  flax's Dropout draws its keep mask
from ``fold_in(PRNGKey(0), step)``; the port draws the same bits
(``tests/test_torch_jax_random.py`` holds a step started on both sides
from one seed), and these tests read JAX's masks
(``_jax_dropout_masks``: the model applied under the step's key, each
Dropout sowing the mask it draws with its own key) and hand them to the
port (``dropout_draw``), so that the step is held on its own.  The rate
stays 0.1, so the dropout branch runs on both sides.

Tolerances: the steps at ``test_torch_train.py``'s (losses 1e-4
relative, ``grad_norm`` 5e-4, gradients 1e-3 of the largest plus 1e-4
relative, the state after two steps as there); the eval CLI's class maps
equal to JAX's pipeline's on >= 0.999 of the pixels and its printed
mIoU/mAcc/aAcc within 0.01 (the printed rounding); the train CLI's
logged ``total`` within 1e-4 relative of JAX's loop run in float64 (its
float32 loop drifts by 2.4e-4 at the fourth step).
"""
import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from spike2former_tpu.data import TrainLoader as JaxTrainLoader
from spike2former_tpu.data import eval_batches as jax_eval_batches
from spike2former_tpu.data import make_dataset as jax_make_dataset
from spike2former_tpu.engine import inference as jinf
from spike2former_tpu.engine import train as jtrain
from spike2former_tpu.engine.config import build_model as jax_build_model
from spike2former_tpu.engine.config import get_config as jax_get_config
from spike2former_tpu.engine.optim import make_optimizer
from spike2former_tpu.evaluation import compute_iou, init_iou, update_iou_np
from spike2former_tpu.models.segmentor import preprocess as jpreprocess
from spike2former_tpu_torch import api
from spike2former_tpu_torch.data.dataset import make_dataset
from spike2former_tpu_torch.engine import train as ttrain
from spike2former_tpu_torch.engine.config import (TrainConfig, build_model,
                                                  get_config)
from spike2former_tpu_torch.engine.convert import from_jax_variables
from spike2former_tpu_torch.engine.weights import randomize_
from spike2former_tpu_torch.tools import test as eval_cli
from spike2former_tpu_torch.tools import train as train_cli

from test_torch_fpn import TINY_FPN, _pair
from test_torch_train import (LOSS_RTOL, _check_grads, _check_metrics,
                              _check_state, _recording)
from torch_port_helpers import write_ade_tree


# --- the train step ------------------------------------------------------------

SPEC = (("ce", 1.0), ("lovasz", 0.5),
        ("ohem", 0.4, {"thresh": 0.7, "min_kept": 64}))


def _seg_batch(seed, b=2, hw=(64, 64), k=5):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (b, *hw, 3), dtype=np.uint8)
    blocks = rng.integers(0, k, (b, hw[0] // 8, hw[1] // 8))
    sem = np.kron(blocks, np.ones((8, 8), np.int64)).astype(np.int32)
    sem[0, :4] = 255
    return imgs, sem


def _is_train_dropout(context) -> bool:
    mod = context.module
    return (isinstance(mod, fnn.Dropout) and context.method_name == "__call__"
            and not mod.deterministic)


def _jax_dropout_masks(jm, variables, imgs, steps: int) -> list:
    """The keep masks of flax's Dropout in JAX's FPN step at steps 0 ..
    ``steps - 1``: the model applied in training mode under the step's
    key ``fold_in(PRNGKey(0), step)``, each Dropout sowing the mask it
    draws with its own key."""

    def sow_keep(next_fun, args, kwargs, context):
        if not _is_train_dropout(context):
            return next_fun(*args, **kwargs)
        mod = context.module
        rng = mod.make_rng(mod.rng_collection)
        mod.sow("intermediates", "keep", jax.random.bernoulli(
            rng, 1.0 - mod.rate, args[0].shape))
        return next_fun(*args, rng=rng, **kwargs)

    def keep(v, x, rng):
        _, upd = jm.apply(v, jpreprocess(x), True,
                          mutable=["batch_stats", "intermediates"],
                          rngs={"dropout": rng})
        return jax.tree_util.tree_leaves(upd["intermediates"])

    with fnn.intercept_methods(sow_keep):
        fn = jax.jit(keep)
        out = [fn(variables, jnp.asarray(imgs),
                  jax.random.fold_in(jax.random.PRNGKey(0), i))
               for i in range(steps)]
    assert all(len(m) == 1 for m in out)
    return [np.asarray(m[0]) for m in out]


def _given_dropout(keep):
    """flax's Dropout in training mode keeping where ``keep`` does."""

    def interceptor(next_fun, args, kwargs, context):
        if not _is_train_dropout(context):
            return next_fun(*args, **kwargs)
        x = args[0]
        return jax.lax.select(jnp.asarray(keep),
                              x / (1.0 - context.module.rate),
                              jnp.zeros_like(x))

    return fnn.intercept_methods(interceptor)


def _jax_fpn_step(jm, tx, spec, given: bool):
    """JAX's jitted FPN step; with ``given`` it takes a fourth argument,
    the keep mask its Dropout drops by (flax's own mask otherwise)."""
    step = jtrain.make_train_step_fpn(jm, tx, loss_decode=spec)
    if not given:
        return jax.jit(step)

    def with_mask(state, imgs, sem, keep):
        with _given_dropout(keep):
            return step(state, imgs, sem)

    return jax.jit(with_mask)


def _run_jax_fpn(jm, variables, batches, given=None):
    """JAX's jitted FPN step over ``batches``: (metrics, each step's
    gradients, the final variables, the dropout masks).  With ``given``
    the steps drop by those masks, else by flax's own, which
    ``_jax_dropout_masks`` reads."""
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])
    tx = _recording(make_optimizer(params, warmup_iters=1))
    state = jtrain.TrainState(jnp.zeros((), jnp.int32), params, stats,
                              tx.init(params))
    masks = given or _jax_dropout_masks(jm, variables, batches[0][0],
                                        len(batches))
    step = _jax_fpn_step(jm, tx, SPEC, given is not None)
    metrics, grads = [], []
    for i, (imgs, sem) in enumerate(batches):
        args = (state, jnp.asarray(imgs), jnp.asarray(sem))
        state, m = step(*args, *([] if given is None else [given[i]]))
        metrics.append({k: float(v) for k, v in m.items()})
        grads.append(jax.tree_util.tree_map(np.asarray, state.opt_state[1]))
    final = jax.tree_util.tree_map(
        np.asarray, {"params": state.params, "batch_stats": state.batch_stats})
    return metrics, grads, final, masks


def jax_masks_draw(masks):
    """The port's ``dropout_draw`` that keeps where JAX's masks kept."""
    def draw(step):
        u = torch.from_numpy(np.where(masks[step], 0.0, 1.0).astype(
            np.float32))
        return lambda shape, device: u.reshape(shape).to(device)
    return draw


def _run_port_fpn(pm, batches, masks):
    state = ttrain.init_state(pm, TrainConfig(warmup_iters=1))
    step = ttrain.make_train_step_fpn(SPEC, dropout_draw=jax_masks_draw(masks))
    metrics, grads = [], []
    for imgs, sem in batches:
        state, m = step(state, torch.from_numpy(imgs),
                        torch.from_numpy(sem).long())
        metrics.append({k: float(v) for k, v in m.items()})
        grads.append({k: p.grad.clone() for k, p in pm.named_parameters()})
    return metrics, grads, {k: v.clone() for k, v in pm.state_dict().items()}


TRAIN_CASES = {
    "fpn_sdtv3": ("fpn_sdtv3_512x512_10M_ade20k", ["model.T=2"]),
    "fpn_msresnet18": ("fpn_msresnet18_512x512_ade20k", []),
    "cascade": ("cascade_fpn_sdtv2_512x512_ade20k",
                ["model.num_stages=3", "model.T=2"]),
}


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_train_step_matches_jax(case):
    """Two steps of the FPN step with the (ce, lovasz, ohem) spec of
    ``tests/test_train_and_eval.py``, the port handed JAX's dropout keep
    masks: losses, ``grad_norm``, each step's gradients and the state
    after both."""
    name, opts = TRAIN_CASES[case]
    jm, variables, pm = _pair(name, opts, seed=17)
    batches = [_seg_batch(0), _seg_batch(1)]
    want, wgrads, wstate, masks = _run_jax_fpn(jm, variables, batches)
    assert len(masks) == 2 and 0.8 < masks[0].mean() < 1.0
    got, ggrads, gstate = _run_port_fpn(pm, batches, masks)
    _check_metrics(want, got)
    for w, g in zip(wgrads, ggrads):
        _check_grads(w, g)
    _check_state(wstate, gstate, wgrads[-1])
    stages = ([f"decode_{i}." for i in range(3)] if case == "cascade"
              else [""])
    assert set(got[0]) == {f"{s}loss_{n[0]}" for s in stages for n in SPEC
                           } | {"acc_seg", "total", "grad_norm"}
    head = "stage2.cls.weight" if case == "cascade" else "head.Conv_0.weight"
    for key in ("neck.lateral_0.Conv_0.weight", head):
        assert ggrads[0][key].abs().max() > 0


def test_default_dropout_draw_is_seeded_by_seed_and_step():
    """The step's own dropout is JAX's: keyed by the step alone, as JAX's
    FPN step keys it by ``fold_in(PRNGKey(0), step)`` whatever the seed
    (``tests/test_torch_jax_random.py`` holds the masks to JAX's): the
    same step draws the same mask, another step another."""
    pm = randomize_(build_model(get_config(
        "fpn_msresnet18_512x512_ade20k", TINY_FPN).model), 0)
    sd = {k: v.clone() for k, v in pm.state_dict().items()}
    batch = [torch.from_numpy(a) for a in _seg_batch(3)]

    def first_total(step):
        pm.load_state_dict(sd)
        state = ttrain.init_state(pm, TrainConfig(warmup_iters=1))
        state.step = step
        return float(ttrain.make_train_step_fpn()(state, *batch)[1]["total"])

    assert first_total(0) == first_total(0) != first_total(1)


# --- the API -------------------------------------------------------------------

def test_api_serves_and_trains_the_fpn_presets():
    name = "fpn_sdtv3_512x512_19M_ade20k"
    im = api.init_model(name, overrides=TINY_FPN, device="cpu")
    img = np.random.default_rng(0).integers(0, 256, (70, 90, 3), np.uint8)
    pred = api.inference_model(im, img)
    assert pred.shape == (70, 90) and 0 <= pred.min() and pred.max() < 5
    tr = api.init_trainer("cascade_fpn_sdtv2_512x512_ade20k",
                          TINY_FPN + ["model.T=2"], device="cpu")
    m = api.train_steps(tr, [_seg_batch(4), _seg_batch(5)])
    assert len(m) == 2 and tr.state.step == 2
    assert {"decode_0.loss_ce", "decode_1.loss_ce", "acc_seg", "total",
            "grad_norm"} == set(m[0])
    assert all(np.isfinite(v) for v in m[1].values())
    with pytest.raises(ValueError, match="no accum_steps"):
        api.init_trainer(name, TINY_FPN + ["train.accum_steps=2"],
                         device="cpu")


# --- the eval CLI ----------------------------------------------------------------

EVAL_PRESET = "fpn_msresnet18_512x512_ade20k"
EVAL_OPTS = TINY_FPN + ["data.test_scale=(128,96)", "test.bucket=64"]
SLIDE_OPTS = ["test.mode='slide'", "test.crop_size=(64,64)",
              "test.stride=(48,48)"]


def _jax_eval(jm, variables, cfg, root):
    """JAX's ``tools/test.py`` pipeline on the val split: (its
    compute_iou, each image's class map)."""
    slide = cfg.test.mode == "slide"
    k = cfg.model.num_classes
    iou, preds = init_iou(k), []
    for images, sem, metas in jax_eval_batches(
            jax_make_dataset("ade20k", root, "val"),
            scale=cfg.data.test_scale, size_divisor=cfg.data.size_divisor,
            bucket=0 if slide else cfg.test.bucket):
        if slide:
            logits = jinf.slide_logits(jm, variables, jnp.asarray(images),
                                       cfg.test.crop_size, cfg.test.stride,
                                       k)
        else:
            logits = jinf.whole_logits(
                jm, variables, jnp.asarray(images),
                valid_hw=[metas[0]["img_shape"]] if cfg.test.bucket else None)
        pred = np.asarray(jinf.postprocess_pred(
            logits, metas[0].get("pad_shape"), metas[0]["ori_shape"]))
        iou = update_iou_np(iou, pred, sem, k)
        preds.append(pred[0])
    return compute_iou(iou), preds


@pytest.mark.parametrize("mode", ["whole", "slide"])
def test_eval_cli_matches_the_jax_pipeline(mode, tmp_path, capsys):
    opts = EVAL_OPTS + (SLIDE_OPTS if mode == "slide" else [])
    jm, variables, _ = _pair(EVAL_PRESET, opts, seed=21)
    root = write_ade_tree(tmp_path / "ade", n=3, seed=4, num_labels=5)
    ckpt = str(tmp_path / "port.pt")
    torch.save(from_jax_variables(variables), ckpt)
    want, want_preds = _jax_eval(jm, variables,
                                 jax_get_config(EVAL_PRESET, opts), root)
    assert eval_cli.main([EVAL_PRESET, "--data-root", root, "--checkpoint",
                          ckpt, "--device", "cpu", "--cfg-options",
                          *opts]) == 0
    out = capsys.readouterr().out.split()
    assert out[out.index("images:") + 1] == "3"
    for key in ("mIoU", "mAcc", "aAcc"):
        assert float(out[out.index(key) + 1]) == pytest.approx(
            want[key], abs=0.01), key
    im = api.init_model(get_config(EVAL_PRESET, opts), ckpt, device="cpu")
    got = eval_cli.evaluate(im, make_dataset("ade20k", root, "val"))
    for g, w in zip(got["preds"], want_preds):
        assert g.shape == w.shape and (g == w).mean() >= 0.999


def test_eval_cli_refuses_a_reference_checkpoint_for_the_fpn_family():
    with pytest.raises(SystemExit):
        eval_cli.main([EVAL_PRESET, "--torch-checkpoint", "ref.pth",
                       "--device", "cpu"])


# --- the train CLI ----------------------------------------------------------------

TRAIN_PRESET = "fpn_sdtv3_512x512_19M_ade20k"
STEPS, LOG = 4, 2
SPEC_OPT = ("train.loss_decode=(('ce',1.0),('lovasz',0.5),"
            "('ohem',0.4,{'thresh':0.7,'min_kept':64}))")
CLI_OPTS = TINY_FPN + [
    "model.T=2", SPEC_OPT, "data.crop_size=(64,64)",
    "data.test_scale=(128,96)", "test.bucket=64", "data.batch_size=2",
    "data.num_workers=2", "train.warmup_iters=2",
    "train.checkpoint_interval=2", "train.val_interval=2"]


def _jax_cli_loop(cfg, jm, variables, root, steps, masks):
    """``tools/train.py``'s FPN loop without checkpoints and val, its
    Dropout keeping by ``masks``: the ``total`` at each logged step."""
    t = cfg.train
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    tx = make_optimizer(params, base_lr=t.base_lr,
                        weight_decay=t.weight_decay,
                        backbone_lr_mult=t.backbone_lr_mult,
                        clip_norm=t.clip_norm, warmup_iters=t.warmup_iters,
                        total_iters=t.total_iters)
    state = jtrain.TrainState(
        jnp.zeros((), jnp.int32), params,
        jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
        tx.init(params))
    step = _jax_fpn_step(jm, tx, t.loss_decode, given=True)
    loader = JaxTrainLoader(jax_make_dataset("ade20k", root, "train"),
                            cfg.data.batch_size, cfg.data.crop_size,
                            seed=t.seed, num_workers=cfg.data.num_workers)
    try:
        batches, totals = iter(loader), {}
        for i in range(steps):
            images, sem = next(batches)
            state, m = step(state, jnp.asarray(images), jnp.asarray(sem),
                            masks[i])
            if (i + 1) % LOG == 0:
                totals[i + 1] = float(m["total"])
    finally:
        loader.close()
    return totals


def test_train_cli_matches_the_jax_loop_and_resumes(tmp_path, monkeypatch,
                                                    capsys):
    """The CLI's logged ``total`` against JAX's loop over JAX's
    ``TrainLoader`` on the same tree, with JAX's dropout masks; its
    checkpoints, val and ``best/``; then ``--resume`` to 6 steps."""
    opts = CLI_OPTS + [f"train.total_iters={STEPS}"]
    jm, variables, _ = _pair(TRAIN_PRESET, opts, seed=23)
    masks = _jax_dropout_masks(jm, variables,
                               np.zeros((2, 64, 64, 3), np.uint8), STEPS + 2)
    make_step = ttrain.make_train_step_fpn
    monkeypatch.setattr(
        ttrain, "make_train_step_fpn",
        lambda spec: make_step(spec, dropout_draw=jax_masks_draw(masks)))
    root = write_ade_tree(tmp_path / "ade", n=4, seed=6, num_labels=5)
    cfg = get_config(TRAIN_PRESET, opts)
    assert cfg.train.loss_decode == SPEC
    cfg.data.data_root = root
    wd = str(tmp_path / "wd")
    res = train_cli.train(cfg, wd, log_interval=LOG, eval_images=2,
                          device="cpu",
                          state_dict=from_jax_variables(variables))
    # JAX's f32 loop drifts from its own f64 run: at step 4 its total is
    # 3.140888 against 3.141646 in f64 (2.4e-4), where the port's reads
    # 3.141647; so the port is held to JAX in float64
    with jax.enable_x64(True):
        jcfg = jax_get_config(TRAIN_PRESET, opts + ["model.dtype='float64'"])
        want = _jax_cli_loop(
            jcfg, jax_build_model(jcfg.model), jax.tree_util.tree_map(
                lambda a: np.asarray(a, np.float64), variables), root,
            STEPS, masks)
    got = {r["step"]: r["total"] for r in res["logs"]}
    assert set(got) == set(want) == {2, 4}
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=LOSS_RTOL), k
    assert {"loss_ce", "loss_lovasz", "loss_ohem", "acc_seg"} <= set(
        res["logs"][0])
    assert [s for s, _ in res["vals"]] == [2, 4]
    assert sorted(os.listdir(wd)) == ["best", "ckpt_2", "ckpt_4",
                                      "scalars.jsonl"]
    capsys.readouterr()
    assert train_cli.main([TRAIN_PRESET, "--data-root", root, "--work-dir",
                           wd, "--resume", "--device", "cpu",
                           "--log-interval", "2", "--eval-images", "0",
                           "--cfg-options", *CLI_OPTS,
                           "train.total_iters=6"]) == 0
    out = capsys.readouterr().out
    assert "resumed from" in out and "at step 4" in out
    assert "iter 6/6 loss" in out
    assert os.path.exists(os.path.join(wd, "ckpt_6"))


# --- firing rates, serving, TTA, the benchmark ------------------------------------

@pytest.mark.parametrize("name", ["fpn_sdtv3_512x512_10M_ade20k",
                                  "fpn_msresnet18_512x512_ade20k"])
def test_firing_sites_and_rates_match_jax(name):
    """Every JAX ``Spike`` site (the multispike neurons under flax's
    ``.../Spike_0``, the backbones' sites) is one port ``Spike`` of the
    same name with the same rates (1e-6); the binary LIF neurons are no
    site, as in JAX."""
    from test_torch_firing import jax_rates

    from spike2former_tpu_torch.utils.firing import firing_rates

    jm, variables, pm = _pair(name, ["model.T=2"], seed=25)
    x = np.random.default_rng(26).normal(0, 1, (1, 64, 64, 3)).astype(
        np.float32)
    want = jax_rates(jm, variables, jnp.asarray(x))
    got = firing_rates(pm, torch.from_numpy(x))
    assert set(got) == set(want) and len(got) > 0
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=1e-6), k
    if "sdtv3" in name:
        assert "neck/lateral_neuron_0/Spike_0/rate" in got


def test_serving_tta_and_inferencer_take_an_fpn_preset(tmp_path):
    from spike2former_tpu_torch.evaluation.tta import tta_logits
    from spike2former_tpu_torch.serving import ServingEngine

    name = "fpn_msresnet18_512x512_ade20k"
    opts = TINY_FPN + ["data.test_scale=(128,96)"]
    im = api.init_model(name, overrides=opts, device="cpu")
    rng = np.random.default_rng(27)
    imgs = [rng.integers(0, 256, hw + (3,), np.uint8)
            for hw in ((70, 90), (90, 70))]
    with ServingEngine(name, model=im, device="cpu", max_batch=2,
                       bucket=64) as eng:
        preds = [f.result() for f in [eng.submit(i) for i in imgs]]
    for p, img in zip(preds, imgs):
        assert p.shape == img.shape[:2]
    x = torch.from_numpy(rng.normal(0, 1, (1, 64, 64, 3)).astype(np.float32))
    with torch.no_grad():
        logits = tta_logits(im.model.predict_logits, x, (0.75, 1.0), True)
    assert logits.shape == (1, 64, 64, 5) and torch.isfinite(logits).all()
    out = api.Inferencer(name, overrides=opts, device="cpu")(
        imgs, out_dir=str(tmp_path))
    assert len(out["predictions"]) == 2 and len(out["visualization"]) == 2


def test_benchmark_counts_no_sampler_flops_for_the_fpn_family():
    from spike2former_tpu_torch.tools import benchmark

    args = benchmark._parser().parse_args(
        ["fpn_msresnet18_512x512_ade20k", "--device", "cpu",
         "--image-size", "64", "64", "--num-iters", "1", "--warmup", "1",
         "--batch-size", "2", "--dtype", "float32", "--train", "--mfu",
         "--peak-tflops", "1",
         "--cfg-options", *TINY_FPN])
    r = benchmark.run(args)
    assert r["dcn_flops"] == 0 and r["flops"] == r["counted_flops"] > 0
