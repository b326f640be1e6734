"""Shared set-up for the ``test_torch_*`` parity tests: a JAX model and its
port counterpart holding the same seeded random weights.

Weights are drawn in numpy on the JAX variable tree, with layer-scale gammas
and BN statistics at O(1) as ``torch_golden.randomize_torch`` does (at init
the 1e-6 gammas silence the DCN branch), then carried to the port by
``engine.convert.from_jax_variables`` and loaded strictly.
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch
from PIL import Image

from spike2former_tpu.models import Spike2Former as JaxSpike2Former
from spike2former_tpu_torch.engine.convert import from_jax_variables
from spike2former_tpu_torch.models.segmentor import Spike2Former

# Under pytest-xdist every worker imports this module while it collects,
# and each worker's torch would start a thread for every core: six workers
# of eight threads each, beside XLA's own pools, spent much of the suite's
# time waiting on each other.  Each worker keeps its share of the cores,
# rounded up.
_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
torch.set_num_threads(-(-len(os.sched_getaffinity(0)) // _WORKERS))

# tiny dims of .claude/skills/verify/SKILL.md
TINY = dict(num_classes=5, embed_dim=(8, 16, 24, 32), backbone_heads=4,
            feat_channels=16, num_queries=4, num_decoder_layers=1,
            num_encoder_layers=1, depths_stage3=1, depths_stage4=1,
            dcn_group=4)
# the flagship preset at its published widths
FLAGSHIP = dict(num_classes=150, embed_dim=(64, 128, 256, 360),
                backbone_heads=8, feat_channels=256, num_queries=100,
                num_decoder_layers=6, num_encoder_layers=6, depths_stage3=6,
                depths_stage4=2, dcn_group=32)


def randomize_variables(variables, seed: int = 0, fan_in_scaled=False):
    """Numpy flax variable tree with every leaf drawn from ``seed``;
    ``variables`` may hold arrays or shape structs (``jax.eval_shape``).

    Kernels are drawn at std 0.5, as ``randomize_torch`` does, or with
    ``fan_in_scaled`` at ``2/sqrt(fan_in)`` (the port's
    ``engine/weights.py``): at full width the fixed 0.5 grows activations
    into the hundreds, where f32 rounding noise flips q8 levels and the
    net, like the reference itself (test_full_model_parity.py:152-175),
    stops reproducing itself."""
    rng = np.random.default_rng(seed)

    def draw(path, x):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = tuple(x.shape)
        bn = any("BatchNorm" in str(getattr(k, "key", k))
                 or "BNAndPad" in str(getattr(k, "key", k))
                 or str(getattr(k, "key", k)).endswith("_bn") for k in path)
        if name == "mean":
            v = rng.normal(0.0, 0.3, shape)
        elif name == "var":
            v = rng.uniform(0.5, 2.0, shape)
        elif bn and name == "scale":
            v = rng.normal(1.0, 0.2, shape)
        elif bn and name == "bias":
            v = rng.normal(0.0, 0.2, shape)
        elif name == "kernel" and fan_in_scaled:
            v = rng.normal(0.0, 2.0 / np.sqrt(np.prod(shape[:-1])), shape)
        elif name in ("kernel", "bias"):
            v = rng.normal(0.0, 0.5, shape)
        else:  # gammas, w, queries, embeddings, shortcut kernel
            v = rng.normal(0.5, 0.2, shape)
        return v.astype(np.float32)

    tree = {k: variables[k] for k in ("params", "batch_stats")
            if k in variables}
    return jax.tree_util.tree_map_with_path(draw, tree)


def make_pair(cfg=TINY, compat=False, T=1, collapse_t=True, seed=0,
              init_hw=(64, 64), fan_in_scaled=False, dtype="float32"):
    """(jax_model, variables, port_model) with identical weights, both
    computing in ``dtype`` ('float32' or 'bfloat16'); the port model is on
    the CPU in eval mode."""
    jm = JaxSpike2Former(T=T, compat=compat, collapse_t=collapse_t,
                         dtype=getattr(jnp, dtype), **cfg)
    variables = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                               jnp.zeros((1, *init_hw, 3), jnp.float32))
    variables = randomize_variables(variables, seed, fan_in_scaled)
    pm = Spike2Former(T=T, compat=compat, collapse_t=collapse_t,
                      dtype=getattr(torch, dtype), **cfg)
    pm.load_state_dict(from_jax_variables(variables), strict=True)
    return jm, variables, pm.eval()


def images(hw, b=1, seed=0):
    """Seeded normalized NHWC images as numpy."""
    return np.random.default_rng(seed).normal(
        0, 1, (b, *hw, 3)).astype(np.float32)


def to_torch(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _jnp(args):
    return jax.tree_util.tree_map(jnp.asarray, args)


def load_port(jax_module, port_module, *args, seed=0):
    """Init ``jax_module`` on ``args`` (numpy), redraw its variables from
    ``seed``, and load them strictly into ``port_module``.  Returns the
    variables."""
    variables = jax.eval_shape(jax_module.init, jax.random.PRNGKey(0),
                               *_jnp(args))
    variables = randomize_variables(variables, seed)
    port_module.load_state_dict(from_jax_variables(variables), strict=True)
    port_module.eval()
    return variables


# XLA may keep the intermediates of fused bf16 ops in f32
# (``xla_allow_excess_precision``, on by default), which op-by-op JAX does
# not: in a quantized net the skipped roundings flip q8 spike levels, so a
# jitted bf16 reference would drift from JAX's own op-by-op semantics.
# The bf16 parity tests compile their JAX references without that licence:
# each op rounds to bf16, as op-by-op JAX and the port do.
EXACT_BF16 = {"xla_allow_excess_precision": False}


def jit_exact(fn, *args):
    """``jax.jit(fn)(*args)`` compiled under ``EXACT_BF16``."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options=EXACT_BF16)(*args)


def run_both(jax_module, port_module, *args, seed=0):
    """(jax output, port output) as numpy for the same weights and args."""
    variables = load_port(jax_module, port_module, *args, seed=seed)
    # one jitted program: op-by-op dispatch compiles every primitive apart
    want = jax.tree_util.tree_map(
        np.asarray, jax.jit(jax_module.apply)(variables, *_jnp(args)))
    with torch.no_grad():
        got = port_module(*jax.tree_util.tree_map(to_torch, args))
    got = jax.tree_util.tree_map(lambda t: t.numpy(), got)
    return want, got


def assert_tree_close(got, want, atol, rtol=0.0):
    flat_g = jax.tree_util.tree_leaves(got)
    flat_w = jax.tree_util.tree_leaves(want)
    assert len(flat_g) == len(flat_w)
    for g, w in zip(flat_g, flat_w):
        assert g.shape == w.shape, (g.shape, w.shape)
        np.testing.assert_allclose(g, w, atol=atol, rtol=rtol)


def spikes(shape, seed=0):
    """Seeded activations in the q8 spike range (multiples of 1/8)."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 9, shape) / 8.0).astype(np.float32)


def write_ade_tree(root, n=4, seed=0, shapes=None, num_labels=6):
    """Seeded ADE20K-layout tree: ``n`` images and label maps (values
    0..num_labels-1, 0 = unlabeled) in each of training and validation."""
    rng = np.random.default_rng(seed)
    for split in ("training", "validation"):
        os.makedirs(f"{root}/images/{split}", exist_ok=True)
        os.makedirs(f"{root}/annotations/{split}", exist_ok=True)
        for i in range(n):
            h, w = (shapes[i] if shapes else
                    (int(rng.integers(90, 150)), int(rng.integers(90, 150))))
            Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(
                f"{root}/images/{split}/img_{i}.jpg")
            Image.fromarray(rng.integers(0, num_labels, (h, w), np.uint8)
                            ).save(f"{root}/annotations/{split}/img_{i}.png")
    return str(root)
