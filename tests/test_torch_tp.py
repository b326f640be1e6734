"""Tensor parallelism of the port (``spike2former_tpu_torch/parallel/tp.py``)
against the JAX package: its ``tp_pspec`` rules, and the unsharded
functions that JAX's own tests hold its sharded runs to
(``tests/test_tp.py``: forward within 2e-4, a train step's ``total``
within 1e-4 relative and its parameters within 5e-3).

Gloo CPU ranks of ``tests/torch_parallel_worker.py``: two ranks split
the tiny model's FFNs and mask-embed MLP (model axis 2) for
``predict_logits``; four ranks take a DP2 x TP2 MaskFormer step (data
axis 2, model axis 2) on global batches of 4, held to JAX's step and to
the port's one-process step (every gradient, an upstream one included:
a missing backward all-reduce of a column-parallel input shows there),
and save a TP checkpoint that a one-process model loads.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from spike2former_tpu.parallel.tp import tp_pspec as jax_tp_pspec
from spike2former_tpu_torch import parallel
from spike2former_tpu_torch.engine.convert import from_jax_variables
from spike2former_tpu_torch.models.segmentor import Spike2Former

from test_torch_spatial import _jax_logits, collect, launch
from test_torch_train import _batch, _run_jax
from test_tp import _tiny_model
from torch_parallel_worker import run_case
from torch_port_helpers import TINY, images, make_pair

FORWARD_TOL = 2e-4
TOTAL_RTOL, PARAM_ATOL = 1e-4, 5e-3        # JAX's test_tp bounds
SINGLE_TOL = 2e-4                          # against one process
FLAGSHIP = "SDTv2_maskformer_DCNpixelDecoder_ade20k"
TINY_OPTS = [f"model.{k}={v!r}".replace(" ", "") for k, v in TINY.items()
             ] + ["train.warmup_iters=1", "train.matcher='host'"]
UPSTREAM = "backbone.down1_1.Conv_0.weight"


def _port_axis(leaf: str, ndim: int, jax_axis: int) -> int:
    """The port's axis of a JAX leaf's axis: kernels turn ``(out, in)``
    (``engine/convert.py``)."""
    if leaf != "kernel":
        return jax_axis
    out_axis = ndim - 1
    return 0 if jax_axis == out_axis else 1


@pytest.mark.parametrize("size", [2, 3, 4])
def test_tp_pspec_shards_the_leaves_jax_shards(size):
    """On ``test_tp.py``'s tiny tree, every leaf JAX's rules split is
    split by the port's rules on the same axis, and no other; at 3 the
    widths are indivisible and everything stays replicated, as JAX
    falls back."""
    model = _tiny_model()
    variables = jax.eval_shape(lambda key, x: model.init(key, x, True),
                               jax.random.PRNGKey(0),
                               jnp.zeros((2, 32, 32, 3)))
    leaves, want = [], {}

    def spec_of(path, leaf):
        i = len(leaves)
        leaves.append(np.full(leaf.shape, i, np.float32))
        spec = tuple(jax_tp_pspec(path, leaf, size))
        axes = [a for a, s in enumerate(spec) if s == "model"]
        name = str(getattr(path[-1], "key", path[-1]))
        want[i] = (_port_axis(name, len(leaf.shape), axes[0])
                   if axes else None)
        return i

    ids = jax.tree_util.tree_map_with_path(
        spec_of, {k: variables[k] for k in ("params", "batch_stats")})
    tree = jax.tree_util.tree_map(lambda i: leaves[i], ids)
    sd = from_jax_variables(tree)
    got_split = 0
    for key, t in sd.items():
        i = int(t.reshape(-1)[0])
        assert parallel.tp_pspec(key, t.shape, size) == want[i], key
        got_split += want[i] is not None
    if size == 3:
        assert got_split == 0
    else:
        names = [k for k in sd if parallel.tp_pspec(k, sd[k].shape, size)
                 is not None]
        assert any(k.endswith("ffn.Conv_0.weight") for k in names)
        assert any(k.endswith("ffn.Conv_1.weight") for k in names)
        assert any(".ffn.BatchNorm_0." in k for k in names)
        assert any(k.endswith("mask_embed.Dense_1.weight") for k in names)
        assert not any("Conv_1.bias" in k or "BatchNorm_1" in k
                       for k in names)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two-rank TP forward and the four-rank DP2 x TP2 step with
    their JAX references and the one-process step."""
    jm, variables, pm = make_pair(cfg=TINY, seed=5)
    x = images((64, 64), b=2, seed=7)
    fwd_tmp = tmp_path_factory.mktemp("tp_forward")
    fwd = launch([dict(kind="tp_forward", model=dict(TINY),
                       state_dict=pm.state_dict(), images=x)], 2, fwd_tmp)

    sjm, svars, spm = make_pair(cfg=dict(TINY, lazy_masks=True,
                                         norm_eval=True), seed=3)
    batches = [_batch(b=4, seed=0), _batch(b=4, seed=1)]
    step_tmp = tmp_path_factory.mktemp("tp_step")
    step_case = dict(kind="tp_step", preset=FLAGSHIP, overrides=TINY_OPTS,
                     state_dict={k: v.clone()
                                 for k, v in spm.state_dict().items()},
                     batches=batches, model_axis=2)
    step = launch([dict(step_case, ckpt_dir=str(step_tmp / "ckpt"))], 4,
                  step_tmp)
    want_logits = _jax_logits(jm, variables, x)
    jax_run = _run_jax(sjm, svars, batches, 1, "host", 32)
    single = run_case(step_case)
    return dict(want_logits=want_logits, fwd=collect(fwd, fwd_tmp),
                jax_run=jax_run, single=single,
                step=collect(step, step_tmp), ckpt=step_tmp / "ckpt",
                model=dict(TINY, lazy_masks=True, norm_eval=True))


def test_tp_forward_matches_jax(runs):
    for rank in runs["fwd"]:
        np.testing.assert_allclose(rank[0]["logits"].numpy(),
                                   runs["want_logits"], atol=FORWARD_TOL,
                                   rtol=FORWARD_TOL)


def test_dp_tp_step_matches_jax(runs):
    want, _, wstate = runs["jax_run"]
    got = runs["step"][0][0]
    for w, g in zip(want, got["metrics"]):
        np.testing.assert_allclose(g["total"], w["total"], rtol=TOTAL_RTOL)
    wsd = from_jax_variables(wstate)
    assert set(wsd) == set(got["state"])
    worst = max(float((got["state"][k] - w).abs().max())
                for k, w in wsd.items())
    assert worst < PARAM_ATOL, worst


def test_dp_tp_step_matches_one_process(runs):
    single, ranks = runs["single"], [r[0] for r in runs["step"]]
    got = ranks[0]
    # the FFNs were split: each rank held half the hidden rows
    assert got["shard_shapes"]["head.decoder_0.ffn.Conv_0.weight"][0] * 2 \
        == single["shard_shapes"]["head.decoder_0.ffn.Conv_0.weight"][0]
    for w, g in zip(single["metrics"], got["metrics"]):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=SINGLE_TOL,
                                       atol=1e-7, err_msg=k)
    assert set(got["grads"]) == set(single["grads"])
    top = max(float(v.abs().max()) for v in single["grads"].values())
    for k, w in single["grads"].items():
        g = got["grads"][k]
        assert g.shape == w.shape, k
        assert float((g - w).abs().max()) <= SINGLE_TOL * top, k
    up_w, up_g = single["grads"][UPSTREAM], got["grads"][UPSTREAM]
    assert float(up_w.abs().max()) > 0
    assert float((up_g - up_w).abs().max()) <= SINGLE_TOL * float(
        up_w.abs().max())
    for other in ranks[1:]:     # every rank logs the same step
        assert other["metrics"] == got["metrics"]
        for k, v in got["state"].items():   # and holds the same model
            assert torch.equal(other["state"][k], v), k


def test_tp_checkpoint_loads_into_a_one_process_model(runs):
    ckpt = torch.load(runs["ckpt"] / "ckpt_2", weights_only=True)
    state = runs["step"][0][0]["state"]
    model = Spike2Former(**runs["model"])
    model.load_state_dict(ckpt["model"], strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(v, state[k]), k
    params = dict(model.named_parameters())
    for key in ("mu", "nu"):
        assert set(ckpt["optimizer"][key]) == set(params)
        for k, v in ckpt["optimizer"][key].items():
            assert v.shape == params[k].shape, k
    assert ckpt["step"] == 2 and ckpt["optimizer"]["count"] == 2
