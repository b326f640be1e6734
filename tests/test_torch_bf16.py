"""The port at ``model.dtype='bfloat16'`` against the JAX package's bf16
model, on the CPU: the plain bf16 sampler (K1's and K2's function) against
the TPU kernels in Pallas interpret mode and against JAX's XLA path, the
building blocks, and the config and CLIs (the tiny model and the train
step: ``test_torch_bf16_model.py``).

Tolerances are bf16-sized, set from what the JAX package itself does at
bf16 on these inputs:

* sampler out and dx: 2^-7 of the largest |out| (|dx|), one bf16 ulp at
  the top of the range; the bf16 Pallas K1 and JAX's bf16 XLA path are
  0.0156 apart at |out| <= 3.56 (n=2, 6x5, G=2, Cg=4), one ulp.  The TPU
  kernels and the XLA path round their bilinear weights to bf16, the port
  does not;
* doffset and dmask: 1e-2 of the largest |doffset| (|dmask|);
* blocks, of the largest |output|: one bf16 ulp (2^-7) for the bf16
  outputs (ConvBN, MSBlock, DetrDecoderLayer, the head's class and mask
  logits: the port and XLA round the same f32 sums, taken in other
  orders), 1e-5 for the DCN encoder layer's f32 residual stream; the
  elements beyond it, where a q8 spike level flipped, are counted and
  held under 1%.  Measured: every bf16 output bit-equal, the DCN layer
  within 6.7e-8 of its largest |output|; Spike bit-equal;

The JAX references are compiled without XLA's excess precision
(``torch_port_helpers.EXACT_BF16``): each op rounds to bf16, as op-by-op
JAX does.
"""
import os
import sys
import unittest.mock as mock

sys.path.insert(0, os.path.dirname(__file__))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spike2former_tpu.models import layers as jl
from spike2former_tpu.models import maskformer_head as jh
from spike2former_tpu.models import pixel_decoder as jp
from spike2former_tpu.models import sdtv2 as js
from spike2former_tpu.models import transformer_decoder as jd
from spike2former_tpu.ops import dcnv3_core as jax_dcnv3_core
from spike2former_tpu_torch.engine import config as tconfig
from spike2former_tpu_torch.models import layers as tl
from spike2former_tpu_torch.models import maskformer_head as th
from spike2former_tpu_torch.models import pixel_decoder as tp
from spike2former_tpu_torch.models import sdtv2 as ts
from spike2former_tpu_torch.models import transformer_decoder as td
from spike2former_tpu_torch.ops import dcnv3

from torch_port_helpers import (TINY, jit_exact, load_port, spikes,
                                write_ade_tree)

BF16 = torch.bfloat16
ULP = 2.0 ** -7            # one bf16 ulp, relative, at the top of a binade
GRAD_RTOL = 1e-2           # doffset, dmask: of the largest magnitude
FLIP_SHARE = 0.01          # elements beyond a block's tolerance (flips)
PRESET = "SDTv2_maskformer_DCNpixelDecoder_ade20k"


# ---- the sampler ----------------------------------------------------------

# (n, h, w, g, gc, offset std): taps off the map; the Motivation's shape
SAMPLER_CASES = [(2, 7, 9, 4, 8, 2.0), (2, 6, 5, 2, 4, 1.5)]


def _sampler_inputs(n, h, w, g, gc, std, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, h, w, g * gc)).astype(np.float32)
    x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    off = (rng.normal(size=(n, h, w, g * 18)) * std).astype(np.float32)
    mask = rng.uniform(0, 1, size=(n, h, w, g * 9)).astype(np.float32)
    cot = rng.normal(size=(n, h, w, g * gc)).astype(np.float32)
    cot = np.asarray(jnp.asarray(cot, jnp.bfloat16).astype(jnp.float32))
    return x, off, mask, cot


def _interpret():
    from jax.experimental import pallas as pl
    orig = pl.pallas_call

    def interp_call(*args, **kw):
        kw["interpret"] = True
        kw.pop("cost_estimate", None)
        return orig(*args, **kw)

    return mock.patch.object(pl, "pallas_call", interp_call)


def _jax_sampler(x, off, mask, cot, g, gc, impl):
    """JAX's bf16 dcnv3_core (bf16 x, f32 offsets and mask): out and the
    gradients of <out, cot> to x, offset and mask."""
    def f(xx, oo, mm):
        return jax_dcnv3_core(xx, oo, mm, group=g, group_channels=gc,
                              impl=impl)

    xb = jnp.asarray(x, jnp.bfloat16)
    out, vjp = jax.vjp(f, xb, jnp.asarray(off), jnp.asarray(mask))
    grads = vjp(jnp.asarray(cot, jnp.bfloat16))
    return [np.asarray(jnp.asarray(a, jnp.float32)) for a in (out, *grads)]


def _port_sampler(x, off, mask, cot, g, gc):
    xt = torch.tensor(x).to(BF16).requires_grad_()
    ot, mt = (torch.from_numpy(a).requires_grad_() for a in (off, mask))
    out = dcnv3.dcnv3_core(xt, ot, mt, group=g, group_channels=gc)
    out.backward(torch.from_numpy(cot).to(BF16))
    assert out.dtype == BF16 and xt.grad.dtype == BF16
    assert ot.grad.dtype == mt.grad.dtype == torch.float32
    return [t.detach().float().numpy() for t in (out, xt.grad, ot.grad,
                                                  mt.grad)]


def _check_sampler(got, want):
    for name, gv, wv in zip(("out", "dx", "doffset", "dmask"), got, want):
        assert gv.shape == wv.shape, name
        tol = (ULP if name in ("out", "dx") else GRAD_RTOL)
        err = np.abs(gv - wv).max()
        assert err <= tol * np.abs(wv).max(), (name, err, np.abs(wv).max())


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("case", SAMPLER_CASES)
def test_bf16_sampler_matches_jax(case, impl):
    """The plain bf16 K1 (forward) and K2 (its autograd) through
    ``dcnv3_core`` against JAX's bf16 ``dcnv3_core``: the TPU kernels
    ``dcnv3_sample_pallas_t5`` / ``_t5_bwd`` in interpret mode, and the
    XLA path."""
    n, h, w, g, gc, std = case
    x, off, mask, cot = _sampler_inputs(n, h, w, g, gc, std)
    if impl == "pallas":
        with _interpret():
            want = _jax_sampler(x, off, mask, cot, g, gc, "pallas")
    else:
        want = _jax_sampler(x, off, mask, cot, g, gc, "xla")
    _check_sampler(_port_sampler(x, off, mask, cot, g, gc), want)


def test_bf16_backward_reference_is_the_f32_one_rounded():
    """The plain bf16 K2 sums in f32 and rounds dvalue once: it is the f32
    backward of the same values, dvalue rounded to bf16."""
    rng = np.random.default_rng(2)
    n, h, w, g, cg, p = 2, 5, 6, 2, 4, 9
    value = torch.from_numpy(rng.normal(size=(n, h, w, g * cg))).to(BF16)
    py, px = (torch.from_numpy(rng.uniform(-2, 7, (n, h * w, g, p))).float()
              for _ in range(2))
    mask = torch.from_numpy(rng.uniform(0, 1, (n, h * w, g, p))).float()
    dout = torch.from_numpy(rng.normal(size=(n, h * w, g * cg))).to(BF16)
    got = dcnv3.dcnv3_sample_backward(value, py, px, mask, dout)
    want = dcnv3.dcnv3_sample_backward_reference(value.float(), py, px, mask,
                                                 dout.float())
    assert got[0].dtype == BF16
    assert torch.equal(got[0], want[0].to(BF16))
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    out = dcnv3.dcnv3_sample(value, py, px, mask)
    assert torch.equal(out, dcnv3.dcnv3_sample_reference(
        value.float(), py, px, mask).to(BF16))


def test_kernel_args_take_bf16_features_and_f32_coordinates():
    v = torch.zeros((1, 4, 4, 16), dtype=BF16)
    py = torch.zeros((1, 16, 2, 9))
    dout = torch.zeros((1, 16, 16), dtype=BF16)
    args = (("px", py), ("mask", py))
    assert dcnv3._check_kernel_args(v, py, *args, ("dout", dout))[0] == 1
    with pytest.raises(TypeError, match="dout must be torch.bfloat16"):
        dcnv3._check_kernel_args(v, py, *args, ("dout", dout.float()))
    with pytest.raises(TypeError, match="py must be torch.float32"):
        dcnv3._check_kernel_args(v, py.to(BF16), *args)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        dcnv3._check_kernel_args(v.half(), py, *args)


# ---- building blocks --------------------------------------------------------

def _x5(c, seed=0, t=1, h=6, w=7):
    return spikes((t, 2, h, w, c), seed) * 4.0 - 1.0


def _tok(n, seed=0, c=16):
    return spikes((1, 2, n, c), seed) * 3.0 - 1.0


def _pyramid(seed, b=2, hw=64):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1.5, (1, b, hw // s, hw // s, c)).astype(np.float32)
            for s, c in ((2, 4), (4, 8), (8, 16), (16, 32))]


BJ, BT = dict(dtype=jnp.bfloat16), dict(dtype=BF16)
HEAD = dict(in_channels=(4, 8, 16, 32), feat_channels=16, out_channels=16,
            num_classes=5, num_queries=4, num_decoder_layers=2,
            num_encoder_layers=1, dcn_group=4)
# name: (JAX block, port block, inputs, tolerance of the largest |output|)
BLOCKS = {
    "ConvBN": (lambda: jl.ConvBN(6, (3, 3), padding=1, use_bias=True, **BJ),
               lambda: tl.ConvBN(8, 6, 3, 1, 1, bias=True, **BT),
               (_x5(8)[0],), ULP),
    "MSBlock": (lambda: js.MSBlock(16, 4, **BJ),
                lambda: ts.MSBlock(16, 4, **BT), (_x5(16),), ULP),
    "DCNEncoderLayer": (
        lambda: jp.DCNEncoderLayer(16, 32, group=4, **BJ),
        lambda: tp.DCNEncoderLayer(16, 32, group=4, **BT), (_x5(16, h=8),),
        1e-5),
    "DetrDecoderLayer": (
        lambda: jd.DetrDecoderLayer(16, 4, 32, **BJ),
        lambda: td.DetrDecoderLayer(16, 4, 32, **BT),
        (_tok(4, 1), _tok(9, 2), _tok(9, 2),
         np.random.default_rng(5).normal(size=(2, 4, 16)).astype(np.float32),
         np.random.default_rng(6).normal(size=(2, 9, 16)).astype(np.float32)),
        ULP),
    "head": (lambda: jh.MaskFormerHead(eval_last_only=False, **HEAD, **BJ),
             lambda: th.MaskFormerHead(eval_last_only=False, **HEAD, **BT),
             (_pyramid(10),), ULP),
}


def _bf16_inputs(args):
    """The blocks' activations in bf16 (exact: multiples of 1/8 or bf16
    values), positional encodings in f32 as the head makes them."""
    def one(a, bf16):
        a = np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
        return a, bf16
    out = []
    for i, a in enumerate(args):
        if isinstance(a, list):
            out.append([one(x, True) for x in a])
        else:
            out.append(one(a, i < 3))
    return out


def _run_bf16(jm, tm, args, seed=1):
    ins = _bf16_inputs(args)

    def jx(item):
        if isinstance(item, list):
            return [jx(i) for i in item]
        a, bf16 = item
        return jnp.asarray(a, jnp.bfloat16 if bf16 else jnp.float32)

    def tx(item):
        if isinstance(item, list):
            return [tx(i) for i in item]
        a, bf16 = item
        return torch.tensor(a).to(BF16 if bf16 else torch.float32)

    f32 = [[a for a, _ in x] if isinstance(x, list) else x[0] for x in ins]
    variables = load_port(jm, tm, *f32, seed=seed)
    want = jit_exact(jm.apply, variables, *[jx(i) for i in ins])
    with torch.no_grad():
        got = tm(*[tx(i) for i in ins])
    flat_w = [np.asarray(jnp.asarray(a, jnp.float32))
              for a in jax.tree_util.tree_leaves(want)]
    flat_g = [t.float().numpy() for t in jax.tree_util.tree_leaves(got)]
    dtypes = [t.dtype for t in jax.tree_util.tree_leaves(got)]
    return flat_w, flat_g, dtypes, jax.tree_util.tree_leaves(want)


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_matches_jax_at_bf16(name):
    make_j, make_t, args, tol = BLOCKS[name]
    want, got, dtypes, jout = _run_bf16(make_j(), make_t(), args)
    assert [str(d).replace("torch.", "") for d in dtypes] == [
        str(a.dtype) for a in jout], "output dtypes differ from JAX's"
    for w, g in zip(want, got):
        assert g.shape == w.shape
        scale = np.abs(w).max()
        assert scale > 0.1
        beyond = np.abs(g - w) > tol * scale
        assert beyond.mean() <= FLIP_SHARE, (name, beyond.mean(),
                                             np.abs(g - w).max(), scale)


@pytest.mark.parametrize("out_hw", [(16, 24), (11, 7)])
def test_bf16_resize_matches_jax_and_serves_inference_and_training(out_hw):
    """The bf16 bilinear resizes equal JAX's bit for bit (upscale: the
    per-axis products; otherwise the gather), and their cached weights,
    made under inference mode, then serve a step under autograd."""
    from spike2former_tpu.ops import resize as jr
    from spike2former_tpu_torch.ops import resize as tr

    x = np.random.default_rng(3).normal(size=(2, 8, 12, 4))
    xb = jnp.asarray(x, jnp.bfloat16)
    xt = torch.tensor(np.asarray(xb.astype(jnp.float32))).to(BF16)
    for jf, tf, arr in ((jr.resize_bilinear, tr.resize_bilinear, (xb, xt)),
                        (jr.resize_bilinear_hw, tr.resize_bilinear_hw,
                         (xb.transpose(0, 3, 1, 2),
                          xt.permute(0, 3, 1, 2).contiguous()))):
        want = np.asarray(jf(arr[0], out_hw).astype(jnp.float32))
        with torch.inference_mode():
            got = tf(arr[1], out_hw)
        assert got.dtype == BF16
        np.testing.assert_array_equal(got.float().numpy(), want)
        leaf = arr[1].clone().requires_grad_()
        tf(leaf, out_hw).float().sum().backward()
        assert leaf.grad is not None


def test_spike_is_exact_at_bf16():
    x = np.random.default_rng(0).normal(0, 0.6, (3, 5, 7)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jl.Spike().apply({}, xb).astype(jnp.float32))
    got = tl.Spike()(torch.from_numpy(x).to(BF16))
    assert got.dtype == BF16
    np.testing.assert_array_equal(got.float().numpy(), want)


# ---- config and CLIs ------------------------------------------------------

def test_bf16_config_keys_at_jax_defaults_and_dtype_reaches_every_layer():
    from spike2former_tpu.engine.config import get_config as jget

    want, got = jget(PRESET), tconfig.get_config(PRESET)
    for part, key in (("model", "dtype"), ("model", "remat"),
                      ("train", "packed_residuals"),
                      ("train", "unroll_loss")):
        assert getattr(getattr(got, part), key) == getattr(
            getattr(want, part), key), key
    small = [f"model.{k}={v!r}".replace(" ", "") for k, v in TINY.items()]
    cfg = tconfig.get_config(PRESET, small + [
        "model.dtype='bfloat16'", "model.remat=True",
        "train.packed_residuals=True", "train.unroll_loss=True"])
    model = tconfig.build_model(cfg.model, cfg.train.packed_residuals)
    layers = [m for m in model.modules()
              if isinstance(m, (tl.Conv2d, tl.Linear))]
    assert layers and all(m.compute_dtype == BF16 for m in layers)
    assert not [m for m in model.modules()
                if type(m) in (torch.nn.Conv2d, torch.nn.Linear)]
    assert all(m.packed == m.spike_input for m in layers)
    assert any(m.packed for m in layers)
    assert model.dtype == BF16 and model.backbone.remat
    assert model.head.pixel_decoder.remat
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with pytest.raises(ValueError, match="model.dtype"):
        tconfig.build_model(tconfig.get_config(
            PRESET, ["model.dtype='float16'"]).model)


def test_train_and_eval_clis_run_at_bf16_on_cpu(tmp_path, capsys):
    """A tiny train-CLI run and a tiny eval-CLI run on its checkpoint with
    ``--cfg-options model.dtype='bfloat16' --device cpu``."""
    from spike2former_tpu_torch.tools import test as eval_cli
    from spike2former_tpu_torch.tools import train as train_cli

    root = write_ade_tree(tmp_path / "ade", n=2, num_labels=5)
    opts = [f"model.{k}={v!r}".replace(" ", "") for k, v in TINY.items()]
    opts += ["model.dtype='bfloat16'", "data.crop_size=(64,64)",
             "data.test_scale=(128,96)"]
    wd = tmp_path / "wd"
    assert train_cli.main([
        PRESET, "--device", "cpu", "--data-root", root, "--work-dir",
        str(wd), "--log-interval", "1", "--cfg-options", *opts,
        "data.batch_size=2", "data.num_workers=1", "train.total_iters=2",
        "train.checkpoint_interval=2", "train.val_interval=100",
        "train.warmup_iters=1"]) == 0
    out = capsys.readouterr().out
    assert "iter 2/2" in out and "nan" not in out.lower()
    assert eval_cli.main([
        PRESET, "--device", "cpu", "--data-root", root, "--checkpoint",
        str(wd / "ckpt_2"), "--max-images", "2", "--cfg-options",
        *opts]) == 0
    assert "mIoU" in capsys.readouterr().out
