"""Why the port's learning run segments the synthetic set where the JAX
package's run did not: a cross-check on the CPU, at tiny widths.

The two full-width runs share the set, the recipe and the val protocol;
their initial weights differ.  The port's first card runs drew them with
``engine/weights.py:randomize_`` (the tests' draw: layer-scale gammas
and BN scales around O(1), BN statistics drawn), the JAX CLI with flax's
initializers (gammas 1e-6, BN statistics 0 and 1); the port's train CLI
now draws them by flax's laws (``engine/weights.py:init_weights_``).  This script separates the two
explanations, a difference in the evaluation or in the initial weights,
on a generated set of ``--train`` and ``--val`` images at 64x64 with
``--classes`` classes, at the tiny widths of
``torch_port_helpers.TINY`` (16 queries), in float32, the recipe's
learning rate, and the JAX loader's batches (the port's ``TrainLoader``
is bit-identical to it):

* ``port_own``: the port's train CLI from the tests' draw
  (``randomize_`` at ``train.seed``, as the first card runs);
* ``port_init``: the port's train CLI from its own draw by flax's laws
  (no weights given: ``init_weights_`` at ``train.seed``);
* ``port_flax``: the port's train CLI from the JAX model's flax
  initial variables (converted by ``engine/convert.py``);
* ``jax_flax``: the JAX package's train CLI (``tools/train.py``) from the
  same flax variables (its own ``init_state`` at ``train.seed``);
* for both port runs, the final weights converted back onto the JAX
  variable tree and scored by the JAX CLI's own periodic val
  (``tools/train.py:evaluate``) on the same val images: ``jax_eval``
  beside the port's ``val``.

Run: ``JAX_PLATFORMS=cpu python tests/torch_learning_crosscheck.py
[--iters 400] [--arms port_own port_init port_flax jax_flax]``; it
prints each run's losses and val mIoU (percent) and ends with one JSON
line.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import types

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from spike2former_tpu.engine.config import build_model as jax_build_model  # noqa: E402
from spike2former_tpu.engine.config import get_config as jax_get_config  # noqa: E402
from spike2former_tpu_torch.engine.config import build_model, get_config  # noqa: E402
from spike2former_tpu_torch.engine.convert import _leaves, from_jax_variables  # noqa: E402
from spike2former_tpu_torch.engine.weights import randomize_  # noqa: E402
from spike2former_tpu_torch.tools import make_synth_dataset  # noqa: E402
from spike2former_tpu_torch.tools import train as train_cli  # noqa: E402

from torch_port_helpers import TINY  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESET = "SDTv2_maskformer_DCNpixelDecoder_ade20k"

ARMS = ["port_own", "port_init", "port_flax", "jax_flax"]


def _root_train_cli():
    spec = importlib.util.spec_from_file_location(
        "root_tools_train", os.path.join(REPO, "tools", "train.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _nest(path, leaf):
    out = leaf
    for k in reversed(path):
        out = {k: out}
    return out


def to_jax_variables(sd, template):
    """The port's state_dict ``sd`` back onto the JAX variable tree
    ``template``: each leaf's element order found by converting a leaf of
    its flat indices with ``from_jax_variables``."""
    out = {}
    for col in ("params", "batch_stats"):
        for path, leaf in _leaves(template.get(col, {})):
            shape = np.shape(leaf)
            ids = np.arange(int(np.prod(shape)), dtype=np.float32)
            (key, order), = from_jax_variables(
                {col: _nest(path, ids.reshape(shape))}).items()
            flat = np.empty(ids.size, np.float32)
            flat[order.numpy().ravel().astype(np.int64)] = \
                sd[key].detach().float().numpy().ravel()
            node = out.setdefault(col, {})
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = jnp.asarray(flat.reshape(shape))
    return out


def options(args):
    tiny = dict(TINY, num_classes=args.classes, num_queries=16)
    return [f"model.{k}={v!r}".replace(" ", "") for k, v in tiny.items()] + [
        "model.dtype=float32", "data.crop_size=(64,64)",
        "data.test_scale=(64,64)", f"data.batch_size={args.batch}",
        "data.num_workers=2", "data.cache=True", "train.base_lr=0.0006",
        f"train.warmup_iters={args.iters // 10}",
        f"train.total_iters={args.iters}",
        f"train.val_interval={args.iters // 2}",
        f"train.checkpoint_interval={args.iters}", "train.max_keep_ckpts=1"]


def port_run(cfg, work_dir, args, state_dict, jcfg, jmodel, template):
    t = time.time()
    with contextlib.redirect_stdout(io.StringIO()):
        res = train_cli.train(cfg, work_dir, log_interval=args.iters // 4,
                              eval_images=args.val, device="cpu",
                              state_dict=state_dict)
    variables = to_jax_variables(res["state"].model.state_dict(), template)
    state = types.SimpleNamespace(params=variables["params"],
                                  batch_stats=variables["batch_stats"])
    jax_eval = _root_train_cli().evaluate(jcfg, jmodel, state, args.val)
    return dict(loss=[round(r["total"], 4) for r in res["logs"]],
                val=[round(m, 2) for _, m in res["vals"]],
                jax_eval=round(float(jax_eval), 2),
                sec=round(time.time() - t, 1))


def jax_run(root, work_dir, args):
    t = time.time()
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "train.py"), PRESET,
         "--device", "cpu", "--data-root", root, "--work-dir", work_dir,
         "--log-interval", str(args.iters // 4), "--eval-images",
         str(args.val), "--cfg-options", *options(args)],
        capture_output=True, text=True, cwd=REPO, timeout=3600,
        env=dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO))
    if proc.returncode:
        raise RuntimeError(proc.stderr[-4000:])
    loss = [float(m) for m in re.findall(r"^iter \d+/\d+ loss ([\d.]+)",
                                         proc.stdout, re.M)]
    val = [float(m) for m in re.findall(r"val mIoU ([\d.]+)", proc.stdout)]
    return dict(loss=loss, val=val, sec=round(time.time() - t, 1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--train", type=int, default=64)
    ap.add_argument("--val", type=int, default=16)
    ap.add_argument("--classes", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arms", nargs="+", default=ARMS, choices=ARMS)
    args = ap.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")

    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "synth")
        for split, n in (("training", args.train), ("validation", args.val)):
            make_synth_dataset.write_split(root, split, n, 64, args.classes,
                                           args.seed)
        opts = options(args)
        cfg, jcfg = get_config(PRESET, list(opts)), jax_get_config(PRESET,
                                                                   list(opts))
        cfg.data.data_root = jcfg.data.data_root = root
        jmodel = jax_build_model(jcfg.model)
        rng = jax.random.PRNGKey(cfg.train.seed)
        flax = jmodel.init({"params": rng, "dropout": rng}, jnp.zeros(
            (args.batch, 64, 64, 3), jnp.float32), True)
        weights = {
            "port_own": lambda: randomize_(build_model(cfg.model),
                                           cfg.train.seed).state_dict(),
            "port_init": lambda: None,
            "port_flax": lambda: from_jax_variables(flax)}
        out = dict(args=vars(args))
        for arm in args.arms:
            if arm == "jax_flax":
                out[arm] = jax_run(root, os.path.join(tmp, arm), args)
            else:
                out[arm] = port_run(cfg, os.path.join(tmp, arm), args,
                                    weights[arm](), jcfg, jmodel, flax)
            print(arm, out[arm], flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
