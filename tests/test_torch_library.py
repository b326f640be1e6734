"""The port's library modules against their JAX counterparts, on the same
seeded weights (``torch_port_helpers.randomize_variables``, carried by
``engine.convert.from_jax_variables`` and loaded strictly) and the same
seeded inputs: the attention variants (``models/attention.py``), the
spikeformer library (``models/spikeformer_lib.py``), CycleMLP, the
spiking RNNs and the encoders.  No preset builds any of them.

In training mode (BN on the batch's statistics) the JAX module runs in
float64: flax's float32 BatchNorm takes the variance as ``E[x^2] -
E[x]^2``, whose cancellation over these few rows flips quantized spike
levels against the exact statistic, which the port's centred float32
form keeps to its rounding (the approach of ``test_torch_dab.py``).

Tolerances (the port in float32, TF32 off):
* forward outputs: 1e-5 absolute plus 1e-5 relative;
* gradients of ``sum(out * r)`` for a seeded ``r``, with respect to the
  parameters and the float inputs: 1e-4 of the largest gradient plus
  1e-4 relative;
* ``seek_local_maximum``, ``QueryProposal``'s pick of pixels, the
  encoders' spikes and the RNNs' spike trains: exact.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spike2former_tpu.models import attention as jatt
from spike2former_tpu.models import cyclemlp as jcyc
from spike2former_tpu.models import spikeformer_lib as jlib
from spike2former_tpu.ops import encoding as jenc
from spike2former_tpu.ops import rnn as jrnn
from spike2former_tpu_torch.engine.convert import from_jax_variables
from spike2former_tpu_torch.models import attention as tatt
from spike2former_tpu_torch.models import cyclemlp as tcyc
from spike2former_tpu_torch.models import spikeformer_lib as tlib
from spike2former_tpu_torch.ops import encoding as tenc
from spike2former_tpu_torch.ops import rnn as trnn
from spike2former_tpu_torch.utils import jax_random as jr

from torch_port_helpers import randomize_variables

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
FWD = dict(atol=1e-5, rtol=1e-5)
GRAD_FRAC, GRAD_RTOL = 1e-4, 1e-4


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(0, scale, shape)
            .astype(np.float32))


def _to_t(x):
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _to_j(x, f64=False):
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    x = np.asarray(x)
    return jnp.asarray(x.astype(np.float64) if f64 and x.dtype ==
                       np.float32 else x)


def _load(jmod, pmod, args, kwargs, seed):
    variables = jax.eval_shape(
        lambda: jmod.init(jax.random.PRNGKey(0),
                          *map(_to_j, args),
                          **{k: _to_j(v) for k, v in kwargs.items()}))
    variables = randomize_variables(variables, seed)
    pmod.load_state_dict(from_jax_variables(variables), strict=True)
    return variables


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def check(jmod, pmod, args, kwargs=None, *, train=None, grad=False,
          grad_argnums=(), seed=0):
    """Hold ``pmod`` to ``jmod`` on ``args``/``kwargs`` (numpy).  ``train``
    None: the modules take no mode; else JAX gets ``train=`` and the port
    is put in that mode.  With ``grad`` also the gradients of ``sum(out
    * r)`` over the parameters and the inputs at ``grad_argnums``.
    Returns (JAX output, port output) as numpy trees."""
    with jax.enable_x64(bool(train)):
        return _check(jmod, pmod, args, dict(kwargs or {}), train, grad,
                      grad_argnums, seed)


def _check(jmod, pmod, args, kwargs, train, grad, grad_argnums, seed):
    variables = _load(jmod, pmod, args, kwargs, seed)
    f64 = bool(train)
    if f64:
        jmod = jmod.clone(dtype=jnp.float64)
        variables = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64), variables)
    jkw = {k: _to_j(v, f64) for k, v in kwargs.items()}
    if train is not None:
        jkw["train"] = train
        pmod.train(train)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    rest = {k: v for k, v in variables.items() if k != "params"}

    def jf(p, *a):
        out = jmod.apply({"params": p, **rest}, *a, **jkw,
                         **({"mutable": ["batch_stats"]} if train else {}))
        return out[0] if train else out

    jargs = [_to_j(a, f64) for a in args]
    want = jax.jit(jf)(params, *jargs)
    targs = [_to_t(a) for a in args]
    for i in grad_argnums:
        targs[i] = targs[i].clone().requires_grad_(True)
    got = pmod(*targs, **{k: _to_t(v) for k, v in kwargs.items()})
    w_leaves = _leaves(want)
    g_leaves = jax.tree_util.tree_leaves(
        got, is_leaf=lambda x: isinstance(x, torch.Tensor))
    g_leaves = [x for x in g_leaves if x is not None]
    assert len(w_leaves) == len(g_leaves)
    for w, g in zip(w_leaves, g_leaves):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.detach().numpy(), w, **FWD)
    if grad:
        out_w = w_leaves[0]
        r = _normal(out_w.shape, 99).astype(out_w.dtype)

        def loss(p, *a):
            o = jf(p, *a)
            o = jax.tree_util.tree_leaves(o)[0]
            return jnp.sum(o * r)

        argn = (0,) + tuple(1 + i for i in grad_argnums)
        grads = jax.jit(jax.grad(loss, argnums=argn))(params, *jargs)
        out_t = g_leaves[0]
        (out_t * torch.from_numpy(r).float()).sum().backward()
        want_g = from_jax_variables({"params": grads[0]})
        got_g = {k: p.grad for k, p in pmod.named_parameters()
                 if p.grad is not None}
        pairs = [(got_g[k], v.float()) for k, v in want_g.items()
                 if float(v.abs().max()) > 0 or k in got_g]
        pairs += [(targs[i].grad, torch.from_numpy(np.asarray(g)).float())
                  for i, g in zip(grad_argnums, grads[1:])]
        top = max(float(w.abs().max()) for _, w in pairs)
        assert top > 0
        for g, w in pairs:
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=GRAD_RTOL,
                                       atol=GRAD_FRAC * top)
    return w_leaves, [g.detach().numpy() for g in g_leaves]


# --- models/attention.py ---

DIM, HEADS = 16, 4


@pytest.mark.parametrize("train", [False, True])
def test_linear_sa(train):
    q, k = _normal((1, 2, 5, DIM), 1, 2.0), _normal((1, 2, 7, DIM), 2, 2.0)
    check(jatt.LinearSpikeMHA(DIM, HEADS, mode="SA"),
          tatt.LinearSpikeMHA(DIM, HEADS, mode="SA"), (q, k, k),
          train=train, grad=train, grad_argnums=(0, 1))


@pytest.mark.parametrize("train", [False, True])
def test_linear_ca(train):
    q = _normal((1, 2, 5, DIM), 3, 2.0)
    k = _normal((1, 2, 3, 4, DIM), 4, 2.0)
    check(jatt.LinearSpikeMHA(DIM, HEADS, mode="CA"),
          tatt.LinearSpikeMHA(DIM, HEADS, mode="CA"), (q, k, k),
          train=train, grad=train, grad_argnums=(0, 1))


@pytest.mark.parametrize("attn_type", ["SA", "CA", "LinearSA", "LinearCA"])
def test_spike_multihead_attention(attn_type):
    q = _normal((1, 2, 5, DIM), 5)
    key = (_normal((1, 2, 3, 4, DIM), 6) if attn_type == "LinearCA"
           else _normal((1, 2, 7, DIM), 6))
    pos = _normal((2, 5, DIM), 7)
    kpos = None if attn_type == "LinearCA" else _normal((2, 7, DIM), 8)
    check(jatt.SpikeMultiheadAttention(DIM, HEADS, attn_type=attn_type),
          tatt.SpikeMultiheadAttention(DIM, HEADS, attn_type=attn_type),
          (q, key, key, pos, kpos), train=True, grad=True,
          grad_argnums=(0,))


@pytest.mark.parametrize("masked", [False, True])
def test_pem_cross_attention(masked):
    tgt, mem = _normal((2, 6, DIM), 9), _normal((2, 4, 5, DIM), 10)
    kw = dict(pos=_normal((2, 4, 5, DIM), 11),
              query_pos=_normal((2, 6, DIM), 12))
    if masked:
        mask = _normal((2, 6, 4, 5), 13)
        mask[1] = -1.0   # batch 1: every query wholly masked -> unmasked
        mask[0, 2] = -1.0
        kw["memory_mask"] = mask
    check(jatt.PEMCrossAttention(DIM, HEADS),
          tatt.PEMCrossAttention(DIM, HEADS), (tgt, mem), kw, train=True,
          grad=True, grad_argnums=(0, 1))


# --- models/spikeformer_lib.py ---

T, B, NQ, NK, C = 1, 2, 8, 16, 32


@pytest.mark.parametrize("train", [False, True])
def test_spikeformer_self_attention(train):
    x, pos = _normal((T, B, NQ, C), 20, 2.0), _normal((T, B, NQ, C), 21)
    check(jlib.SpikeformerSelfAttention(C, 4),
          tlib.SpikeformerSelfAttention(C, 4), (x,), dict(query_pos=pos),
          train=train, grad=True, grad_argnums=(0,))


@pytest.mark.parametrize("mask", [None, "bool", "float"])
def test_spikeformer_cross_attention(mask):
    q, k = _normal((T, B, NQ, C), 22, 2.0), _normal((T, B, NK, C), 23, 2.0)
    kw = dict(query_pos=_normal((T, B, NQ, C), 24),
              key_pos=_normal((T, B, NK, C), 25))
    if mask == "bool":
        kw["attn_mask"] = np.random.default_rng(26).random(
            (B, 1, NQ, NK)) < 0.3
    elif mask == "float":
        kw["attn_mask"] = _normal((B, 1, NQ, NK), 27)
    check(jlib.SpikeformerCrossAttention(C, 4),
          tlib.SpikeformerCrossAttention(C, 4), (q, k), kw, train=True,
          grad=True, grad_argnums=(0, 1))


def test_spikeformer_mlp():
    check(jlib.SpikeformerMLP(C, 64), tlib.SpikeformerMLP(C, 64),
          (_normal((T, B, NQ, C), 28, 2.0),), train=True, grad=True,
          grad_argnums=(0,))


@pytest.mark.parametrize("train", [False, True])
def test_spikeformer_decoder_layer(train):
    q, k = _normal((T, B, NQ, C), 29, 2.0), _normal((T, B, NK, C), 30, 2.0)
    kw = dict(query_pos=_normal((T, B, NQ, C), 31),
              key_pos=_normal((T, B, NK, C), 32))
    check(jlib.SpikeformerDecoderLayer(C, 4, 64),
          tlib.SpikeformerDecoderLayer(C, 4, 64), (q, k), kw, train=train,
          grad=True, grad_argnums=(0, 1))


@pytest.mark.parametrize("train", [False, True])
def test_base_transformer_decoder_layer(train):
    # the weights' gammas are drawn at O(1), as torch_golden.randomize_torch
    # draws them: at their 1e-6 init every branch is silent
    tgt, mem = _normal((T, B, NQ, C), 33), _normal((T, B, NK, C), 34)
    kw = dict(query_pos=_normal((T, B, NQ, C), 35),
              mem_pos=_normal((T, B, NK, C), 36))
    check(jlib.BaseTransformerDecoderLayer(C, 4, 64),
          tlib.BaseTransformerDecoderLayer(C, 4, 64), (tgt, mem), kw,
          train=train, grad=True, grad_argnums=(0, 1))


def test_seek_local_maximum_exact():
    # integer plateaus: ties between neighbours everywhere
    x = np.random.default_rng(37).integers(0, 3, (2, 7, 9, 3)).astype(
        np.float32)
    want = np.asarray(jlib.seek_local_maximum(jnp.asarray(x)))
    got = tlib.seek_local_maximum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("train", [False, True])
def test_query_proposal(train):
    x = _normal((2, 8, 8, 16), 38, 2.0)
    pos = _normal((1, 8, 8, 16), 39)
    want, got = check(jlib.QueryProposal(num_queries=12, num_classes=3),
                      tlib.QueryProposal(16, num_queries=12, num_classes=3),
                      (x, pos), dict(train=train))
    # the picks: every proposal is a pixel of x, in JAX's order
    np.testing.assert_array_equal(got[0], want[0])


# --- models/cyclemlp.py ---

@pytest.mark.parametrize("kernel", [(1, 3), (3, 1), (1, 5)])
def test_cycle_fc(kernel):
    x = _normal((2, 5, 6, 12), 40)
    check(jcyc.CycleFC(8, kernel), tcyc.CycleFC(12, 8, kernel), (x,),
          grad=True, grad_argnums=(0,))


def test_cycle_mlp():
    check(jcyc.CycleMLP(16), tcyc.CycleMLP(16), (_normal((2, 5, 6, 16), 41),),
          grad=True, grad_argnums=(0,))


def test_cycle_block():
    check(jcyc.CycleBlock(16), tcyc.CycleBlock(16),
          (_normal((2, 5, 6, 16), 42),), grad=True, grad_argnums=(0,))


# --- ops/rnn.py and ops/encoding.py ---

RNNS = {"lstm": (jrnn.SpikingLSTM, trnn.SpikingLSTM),
        "gru": (jrnn.SpikingGRU, trnn.SpikingGRU),
        "vanilla": (jrnn.SpikingVanillaRNN, trnn.SpikingVanillaRNN)}


@pytest.mark.parametrize("kind", sorted(RNNS))
@pytest.mark.parametrize("surrogates", [("erf", None), ("sigmoid", "atan")])
def test_spiking_rnn(kind, surrogates):
    jcls, tcls = RNNS[kind]
    s1, s2 = surrogates
    if kind == "vanilla":
        jmod, tmod = jcls(4, surrogate=s1), tcls(6, 4, surrogate=s1)
    else:
        jmod = jcls(4, surrogate1=s1, surrogate2=s2)
        tmod = tcls(6, 4, surrogate1=s1, surrogate2=s2)
    x = _normal((5, 2, 6), 43)
    want, got = check(jmod, tmod, (x,), grad=True, grad_argnums=(0,))
    # the spike trains are the same bits
    np.testing.assert_array_equal(got[0], want[0])


def test_encoders():
    x = np.random.default_rng(44).random((3, 4, 5)).astype(np.float32)
    x[0, 0, :3] = (0.0, 1.0, 0.5)
    for t in (1, 4, 7):
        np.testing.assert_array_equal(
            tenc.latency_encode(torch.from_numpy(x), t).numpy(),
            np.asarray(jenc.latency_encode(jnp.asarray(x), t)))
        np.testing.assert_array_equal(
            tenc.repeat_encode(torch.from_numpy(x), t).numpy(),
            np.asarray(jenc.repeat_encode(jnp.asarray(x), t)))
    key = jax.random.PRNGKey(5)
    want = np.asarray(jenc.poisson_encode(jnp.asarray(x), 8, key))
    # the same key on both sides: JAX's spikes, bit for bit
    got = tenc.poisson_encode(torch.from_numpy(x), 8, jr.key(5)).numpy()
    np.testing.assert_array_equal(got, want)
    rate = tenc.poisson_encode(torch.full((2000,), 0.3), 50,
                               jr.key(0)).mean().item()
    assert abs(rate - 0.3) < 0.01
