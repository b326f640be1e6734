"""The port's training tools against the repository's JAX-driving ones:
``tools/make_synth_dataset.py`` (byte-identical files, read by the port's
data layer), ``tools/burnin.py`` (the burn-in's per-step totals and
gradient norms against a JAX loop built as that tool builds it, at
``accum_steps`` 1 and 2; the mid-run resume bitwise the uninterrupted
run; its CLI's JSON line), and ``tools/make_learning_report.py`` (the
same val table from the same ``scalars.jsonl`` of a tiny port
``learning_run``, and a report without matplotlib).

The burn-in runs at ``--tiny`` widths, 64x64 and batch 2, in float32, with
``--num-classes 4``: the tiny model has 4 queries, and the auction on a
4x4 grid of 150 classes runs to its iteration cap, where the result turns
on the costs' last bits.  Tolerances are ``test_torch_train.py``'s: 1e-4
relative on ``total``, 5e-4 on ``grad_norm``.
"""
import functools
import importlib.util
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(__file__))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spike2former_tpu.engine import train as jtrain
from spike2former_tpu.engine.optim import make_optimizer
from spike2former_tpu.models import Spike2Former as JaxSpike2Former
from spike2former_tpu_torch.data.dataset import make_dataset
from spike2former_tpu_torch.engine.convert import from_jax_variables
from spike2former_tpu_torch.losses.criterion import LazyMasks
from spike2former_tpu_torch.tools import (burnin, learning_run,
                                          make_learning_report,
                                          make_synth_dataset)

from torch_port_helpers import randomize_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL, GRAD_NORM_RTOL = 1e-4, 5e-4   # tests/test_torch_train.py
# tools/burnin.py's --tiny widths and the keys of its JSON line
JAX_TINY_KW = dict(embed_dim=(8, 16, 24, 32), backbone_heads=4,
                   feat_channels=16, num_queries=4, num_decoder_layers=1,
                   num_encoder_layers=1, depths_stage3=1, depths_stage4=1,
                   dcn_group=4)
SUMMARY_KEYS = {"steps", "wall_min", "img_per_sec", "loss_first10%",
                "loss_last10%", "grad_norm_max", "resumed_mid_run",
                "all_finite"}
SMALL = ["--tiny", "--device", "cpu", "--num-classes", "4",
         "--image-size", "64", "--batch-size", "2", "--dtype", "float32"]


def _root_tool(name):
    """A script of the repository's ``tools/`` as a module (its top level
    imports only the standard library)."""
    spec = importlib.util.spec_from_file_location(
        f"root_tools_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _files(root):
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


def test_synth_dataset_is_byte_identical_and_readable(tmp_path):
    """One seed, 3 train and 2 val images at 64x64: the root tool's files
    and the port's CLI's are the same bytes, and the port's ADE20K reader
    takes the tree (ids 1..K stored, 0..K-1 read)."""
    flags = ["--train", "3", "--val", "2", "--size", "64", "--classes", "30",
             "--seed", "5"]
    subprocess.run([sys.executable, os.path.join(REPO, "tools",
                                                 "make_synth_dataset.py"),
                    "--root", str(tmp_path / "jax"), *flags], check=True,
                   capture_output=True, timeout=120)
    assert make_synth_dataset.main(["--root", str(tmp_path / "port"),
                                    *flags]) == 0
    want, got = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert len(want) == 10
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == want[k], k

    for split, n in (("train", 3), ("val", 2)):
        ds = make_dataset("ade20k", str(tmp_path / "port"), split)
        assert len(ds) == n
        for i in range(n):
            s = ds.load(i)
            stem = os.path.basename(ds.samples[i][0])[:-4]
            folder = "training" if split == "train" else "validation"
            _, ann = make_synth_dataset.render(
                5, dict(make_synth_dataset.SPLITS)[folder] + i, 64, 30)
            assert stem == f"synth_{i:06d}"
            assert s["image"].shape == (64, 64, 3)
            np.testing.assert_array_equal(s["sem_seg"], ann.astype(int) - 1)


def _jax_burnin_loop(variables, steps, accum_steps, matcher="auction",
                     dtype=jnp.float32, num_classes=4, hw=64, b=2):
    """tools/burnin.py's loop without its checkpoints and val: the
    module-default ``Spike2Former`` at the tiny widths in ``dtype``,
    ``make_optimizer`` at its defaults with ``warmup_iters=min(500,
    steps // 10)``, ``make_train_step(max_gt=64)`` at its defaults but
    ``matcher``, the pool of 16 ``synth_batch``es from ``default_rng(0)``;
    returns the model and each step's (total, grad_norm)."""
    tool = _root_tool("burnin")
    model = JaxSpike2Former(num_classes=num_classes, T=1, dtype=dtype,
                            **JAX_TINY_KW)
    params, stats = (jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, dtype), variables[k])
        for k in ("params", "batch_stats"))
    tx = make_optimizer(params, warmup_iters=min(500, steps // 10),
                        total_iters=steps)
    state = jtrain.TrainState(jnp.zeros((), jnp.int32), params, stats,
                              tx.init(params))
    step_fn = jax.jit(jtrain.make_train_step(
        model, tx, num_classes=num_classes, max_gt=64, matcher=matcher,
        accum_steps=accum_steps))
    rng = np.random.default_rng(0)
    pool = [tool.synth_batch(rng, b, hw, num_classes) for _ in range(16)]
    out = []
    for i in range(steps):
        images, sem = pool[i % len(pool)]
        state, m = step_fn(state, jnp.asarray(images, dtype),
                           jnp.asarray(sem))
        out.append((float(m["total"]), float(m["grad_norm"])))
    return model, out


def _records(work_dir):
    with open(os.path.join(work_dir, "burnin.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("accum_steps,reference", [
    (1, "f64-host"), (2, "f64-host"), (2, "f32-auction")])
def test_burnin_matches_the_jax_tool_loop(tmp_path, monkeypatch,
                                          accum_steps, reference):
    """Three steps of the port's burn-in, on weights carried over from the
    JAX variables, against the JAX loop: the same model (the module's
    defaults: ``lazy_masks=False``, not the presets' True), the same
    optimizer and step, the same batches.

    ``f32-auction`` is the JAX tool's loop as it runs (float32, the
    auction): the totals within ``LOSS_RTOL``.  Its gradient norms are
    not held: flax's one-pass float32 BN variance puts JAX's first
    ``grad_norm`` 1.1e-3 off its own float64 run (100.619 against
    100.0813 under the host matcher's float64 loop, where the port's
    float32 step reads 100.0815).  ``f64-host`` is that loop in float64,
    which JAX's auction does not run (its loop carries int32 indices),
    so with the host matcher on both sides: totals within ``LOSS_RTOL``
    and gradient norms within ``GRAD_NORM_RTOL``.  Each case compiles
    one JAX step, so ``f32-auction`` runs at ``accum_steps`` 2 only."""
    steps = 3
    model = JaxSpike2Former(num_classes=4, T=1, **JAX_TINY_KW)
    shapes = jax.eval_shape(
        lambda x: model.init(jax.random.PRNGKey(0), x, True),
        jnp.zeros((2, 64, 64, 3)))
    variables = randomize_variables(shapes, seed=4)
    if reference == "f64-host":
        with jax.enable_x64(True):
            jm, want = _jax_burnin_loop(variables, steps, accum_steps,
                                        "host", jnp.float64)
        monkeypatch.setattr(burnin, "make_train_step", functools.partial(
            burnin.make_train_step, matcher="host"))
    else:
        jm, want = _jax_burnin_loop(variables, steps, accum_steps)

    args = burnin.parser().parse_args(SMALL + [
        "--steps", str(steps), "--log-every", "1", "--val-every", "0",
        "--accum-steps", str(accum_steps), "--work-dir", str(tmp_path)])
    assert burnin.TINY_KW == JAX_TINY_KW
    pm = burnin.build_model(args)
    for name in ("lazy_masks", "eval_last_only", "masked_attention"):
        assert getattr(pm.head, name) == getattr(jm, name), name
    for name in ("norm_eval", "collapse_t", "T", "remat"):
        assert getattr(pm.backbone, name) == getattr(jm, name), name
    _, masks = pm.train()(torch.zeros((1, 64, 64, 3)))
    assert not isinstance(masks, LazyMasks)

    out = burnin.run(args, state_dict=from_jax_variables(variables))
    assert out["state"].step == steps and out["resumed_from"] is None
    recs = _records(tmp_path)
    assert [r["step"] for r in recs] == [1, 2, 3]
    for (tw, gw), r in zip(want, recs):
        np.testing.assert_allclose(r["loss"], tw, rtol=LOSS_RTOL)
        if reference == "f64-host":
            np.testing.assert_allclose(r["grad_norm"], gw,
                                       rtol=GRAD_NORM_RTOL)


def _state_dicts(state):
    opt = state.optimizer.state_dict()
    return dict(state.model.state_dict(), count=torch.tensor(opt["count"]),
                **{f"mu.{k}": v for k, v in opt["mu"].items()},
                **{f"nu.{k}": v for k, v in opt["nu"].items()})


def test_burnin_resume_is_bitwise_the_uninterrupted_run(tmp_path):
    """8 steps straight against a checkpoint every 4 and a crash at 6:
    the resumed run restores ckpt_4 into a state drawn from another seed,
    replays steps 5 and 6, and its losses from there on and its final
    state (parameters, BN statistics, AdamW moments and count) are the
    uninterrupted run's, bit for bit."""
    common = SMALL + ["--steps", "8", "--log-every", "1", "--val-every",
                      "4", "--ckpt-every", "4"]
    straight = burnin.run(burnin.parser().parse_args(
        common + ["--work-dir", str(tmp_path / "a")]))
    resumed = burnin.run(burnin.parser().parse_args(
        common + ["--resume-at", "6", "--work-dir", str(tmp_path / "b")]))
    assert resumed["resumed_from"] == str(tmp_path / "b" / "ckpt_4")
    assert resumed["summary"]["resumed_mid_run"]
    want = [r for r in _records(tmp_path / "a") if "loss" in r]
    got = [r for r in _records(tmp_path / "b") if "loss" in r]
    assert [r["step"] for r in got] == [1, 2, 3, 4, 5, 6, 5, 6, 7, 8]
    for w, g in zip(want[4:], got[6:]):
        assert (g["step"], g["loss"], g["grad_norm"]) == \
            (w["step"], w["loss"], w["grad_norm"])
    vals = [r for r in _records(tmp_path / "b") if "val_acc" in r]
    assert [r["step"] for r in vals] == [4, 8]
    a, b = _state_dicts(straight["state"]), _state_dicts(resumed["state"])
    assert resumed["state"].step == straight["state"].step == 8
    assert a.keys() == b.keys()
    bad = [k for k in a if not torch.equal(a[k], b[k])]
    assert not bad, bad[:5]
    assert sorted(f for f in os.listdir(tmp_path / "b")
                  if f.startswith("ckpt_")) == ["ckpt_4", "ckpt_8"]


def test_burnin_cli_prints_the_jax_tools_json_line(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "spike2former_tpu_torch.tools.burnin", *SMALL,
         "--steps", "8", "--ckpt-every", "4", "--resume-at", "6",
         "--work-dir", str(tmp_path)], cwd=REPO, capture_output=True,
        text=True, timeout=300, env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert any("simulated failure: resumed from" in line for line in lines)
    summary = json.loads(lines[-1])
    assert set(summary) == SUMMARY_KEYS
    assert summary["resumed_mid_run"] is True
    assert summary["all_finite"] is True
    assert summary["steps"] == 8


def _table(md, heading):
    """The rows of the markdown table under ``heading``."""
    lines = md.split(heading, 1)[1].splitlines()
    start = next(i for i, line in enumerate(lines) if line.startswith("|"))
    end = next((i for i in range(start, len(lines))
                if not lines[i].startswith("|")), len(lines))
    return lines[start:end]


TINY_OPTS = ["model.embed_dim=(8,16,24,32)", "model.backbone_heads=4",
             "model.feat_channels=16", "model.num_queries=4",
             "model.num_decoder_layers=1", "model.num_encoder_layers=1",
             "model.depths_stage3=1", "model.depths_stage4=1",
             "model.dcn_group=4", "model.dtype=float32",
             "data.crop_size=(64,64)", "data.test_scale=(64,64)",
             "data.batch_size=2", "data.num_workers=1",
             "train.val_interval=3", "train.checkpoint_interval=3",
             "train.warmup_iters=2"]


def test_learning_run_and_report_match_the_jax_report(tmp_path,
                                                      monkeypatch):
    """The learning run at tiny overrides for 6 iterations on a generated
    4-image tree of 4 classes: scalars, checkpoints and the report; the
    JAX tool's report of the same ``scalars.jsonl`` has the same val table
    and loss line; with matplotlib hidden the port's report is written,
    without a PNG."""
    wd, out = tmp_path / "wd", tmp_path / "LEARNING_TORCH.md"
    rc = learning_run.main([
        "--device", "cpu", "--iters", "6", "--data-root",
        str(tmp_path / "data"), "--work-dir", str(wd), "--train", "4",
        "--val", "2", "--size", "64", "--classes", "4", "--log-interval",
        "2", "--out", str(out), "--png", str(tmp_path / "curve.png"),
        "--cfg-options", *TINY_OPTS])
    assert rc == 0
    assert len(os.listdir(tmp_path / "data" / "images" / "training")) == 4
    assert {"scalars.jsonl", "ckpt_3", "ckpt_6", "run_info.json"} <= set(
        os.listdir(wd))
    info = json.loads((wd / "run_info.json").read_text())
    assert info["card"] == "the CPU (no card)"
    assert info["options"][-len(TINY_OPTS):] == TINY_OPTS
    assert "model.num_classes=4" in info["options"]
    port_md = out.read_text()
    assert (tmp_path / "curve.png").exists()

    jax_md = tmp_path / "LEARNING.md"
    monkeypatch.setattr(sys, "argv", [
        "make_learning_report.py", "--work-dir", str(wd), "--out",
        str(jax_md), "--png", str(tmp_path / "jax.png")])
    _root_tool("make_learning_report").main()
    jax_md = jax_md.read_text()
    rows = _table(jax_md, "## Val mIoU trace")
    assert rows == _table(port_md, "## Val mIoU trace")
    assert [r.split("|")[1].strip() for r in rows[2:]] == ["3", "6"]
    for line in ("train loss", "best val mIoU"):
        want = next(r for r in jax_md.splitlines() if r.startswith(
            f"| {line}"))
        got = next(r for r in port_md.splitlines() if r.startswith(
            f"| {line}"))
        assert want.split("|")[2] == got.split("|")[2], (want, got)
    name, digest = make_learning_report.ckpt_hash(str(wd))
    assert name == "ckpt_6" and f"`ckpt_6` sha256 `{digest}`" in port_md

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    bare = tmp_path / "bare.md"
    assert make_learning_report.main([
        "--work-dir", str(wd), "--out", str(bare), "--png",
        str(tmp_path / "bare.png")]) == 0
    assert not (tmp_path / "bare.png").exists()
    assert "matplotlib is not installed" in bare.read_text()
    assert _table(bare.read_text(), "## Val mIoU trace") == rows
