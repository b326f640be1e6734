"""The port's initial weights against flax's, bit for bit: from the same
seed, ``engine/weights.py:init_weights_`` draws what ``model.init(
PRNGKey(seed))`` of the JAX package draws, and ``fast_init_`` what
``utils/initfast.py:fast_variables`` draws, with nothing of JAX handed to
the port.

JAX's side.  ``model.init`` is traced once (``jax.eval_shape``) with
flax's ``Module.param`` recording each parameter's initializer and the
static data flax folds into the root key for it (``LazyRng``'s suffix:
the scope path and the ``make_rng`` count); each initializer is then
called concretely on ``flax.core.scope._fold_in_static(PRNGKey(seed),
suffix)``, the key ``model.init`` hands it, so every preset's variables
come without compiling its forward.  Inside those calls ``jax.random``'s
``normal``, ``truncated_normal`` and ``uniform`` draw over a flat length
rounded up to a power of two and cut to the shape (``flat_samplers``):
under the partitionable layout element ``i`` of a draw depends on the
key and ``i`` alone, so the values are the shape's own
(``test_flat_samplers_are_jax_samplers``), and XLA compiles the samplers
once a length bucket instead of once a shape (minutes across the
presets).  ``test_compiled_model_init_under_remat`` holds the recorder
and the port against a compiled ``model.init`` of the tiny flagship under
``model.remat`` (~30 s).

Tolerances.  Constants, uniforms and keys are bitwise.  Normal-law
entries (``normal``, ``truncated_normal``, ``lecun_normal``) go through
XLA's float32 ``erf_inv``, which the port reproduces with the FMAs XLA's
CPU compiler makes; where a compiled fusion rounds otherwise the two may
differ by ``NORMAL_ULP`` units in the last place of the unit draw (seen:
none, in these models' 14 535 entries or in a million
``jax.random.normal`` draws, ``tests/test_torch_jax_random.py``).

Tiny widths (``torch_port_helpers.TINY``, ``TINY_FPN``), 64x64 inputs.
"""
import functools
import math
import os
import sys
from contextlib import contextmanager

sys.path.insert(0, os.path.dirname(__file__))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from flax.core import scope as fscope
from jax._src import random as jrandom

from spike2former_tpu.engine.config import build_model as jax_build
from spike2former_tpu.engine.config import get_config as jax_config
from spike2former_tpu.utils.initfast import fast_variables
from spike2former_tpu_torch.engine.config import (PRESETS, build_model,
                                                  get_config)
from spike2former_tpu_torch.engine.convert import (flax_entries,
                                                   from_jax_variables)
from spike2former_tpu_torch.engine.weights import (fast_init_, init_laws,
                                                   init_weights_)

from test_torch_fpn import TINY_FPN
from test_torch_init_fpn import LIBRARY
from torch_port_helpers import TINY

TINY_OPTS = [f"model.{k}={v!r}".replace(" ", "") for k, v in TINY.items()]
FLAGSHIP = "SDTv2_maskformer_DCNpixelDecoder_ade20k"
NORMAL_ULP = 2


@contextmanager
def recording(rec: dict):
    """Record ``(collection, path) -> (init_fn, args, kwargs, suffix,
    rng)`` of every parameter flax creates inside the block: its key is
    ``_fold_in_static(rng, suffix)`` (``LazyRng.as_jax_rng``)."""
    param, as_jax_rng = fnn.Module.param, fscope.LazyRng.as_jax_rng
    made = {}

    def record_rng(self):
        out = as_jax_rng(self)
        made[id(out)] = (self, out)     # keep ``out`` alive: ids unique
        return out

    def rec_param(self, name, init_fn, *args, **kw):
        path = self.scope.path + (name,)

        def keyed(k, *a, **k_kw):
            lazy = made.get(id(k), (None,))[0]
            rec.setdefault(("params", path), (
                init_fn, a, k_kw, None if lazy is None else lazy.suffix,
                None if lazy is None else lazy.rng))
            return init_fn(k, *a, **k_kw)
        return param(self, name, keyed, *args, **kw)

    fnn.Module.param, fscope.LazyRng.as_jax_rng = rec_param, record_rng
    try:
        yield rec
    finally:
        fnn.Module.param, fscope.LazyRng.as_jax_rng = param, as_jax_rng


_SAMPLERS = {n: getattr(jrandom, n)
             for n in ("normal", "truncated_normal", "uniform")}


def _bucket(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


@functools.cache
def _flat_draw(name: str, length: int, dtype):
    """The jitted ``jax.random.<name>`` of ``(length,)``."""
    fn = _SAMPLERS[name]
    if name == "normal":
        return jax.jit(lambda k: fn(k, (length,), dtype))
    if name == "uniform":
        return jax.jit(lambda k, lo, hi: fn(k, (length,), dtype, lo, hi))
    return jax.jit(lambda k, lo, hi: fn(k, lo, hi, (length,), dtype))


def _install(samplers: dict) -> dict:
    """Set ``jax.random``'s samplers (both modules); returns the old."""
    old = {n: getattr(jrandom, n) for n in samplers}
    for mod in (jrandom, jax.random):
        for n, f in samplers.items():
            setattr(mod, n, f)
    return old


def _cut(name: str, key, shape, dtype, *bounds):
    shape = tuple(int(d) for d in shape)
    n = math.prod(shape)
    dtype = jax.dtypes.canonicalize_dtype(float if dtype is None else dtype)
    patched = _install(_SAMPLERS)   # JAX's own inside the flat draw
    try:
        flat = _flat_draw(name, _bucket(n), dtype)(key, *bounds)
    finally:
        _install(patched)
    return jnp.asarray(np.asarray(flat)[:n].reshape(shape))


@contextmanager
def flat_samplers():
    """``jax.random``'s ``normal``, ``truncated_normal`` and ``uniform``
    (as ``jax.nn.initializers`` reaches them, unsharded) drawn over a flat
    power-of-two length and cut to the shape."""
    def normal(key, shape=(), dtype=None, *, out_sharding=None):
        assert out_sharding is None
        return _cut("normal", key, shape, dtype)

    def truncated_normal(key, lower, upper, shape=None, dtype=None, *,
                         out_sharding=None):
        assert shape is not None and out_sharding is None
        return _cut("truncated_normal", key, shape, dtype, lower, upper)

    def uniform(key, shape=(), dtype=None, minval=0.0, maxval=1.0, *,
                out_sharding=None):
        assert out_sharding is None
        return _cut("uniform", key, shape, dtype, minval, maxval)

    _install(dict(normal=normal, truncated_normal=truncated_normal,
                  uniform=uniform))
    try:
        yield
    finally:
        _install(_SAMPLERS)


def flax_tree(jm, seed: int, *args) -> dict:
    """``jm.init({'params': k, 'dropout': k}, *args)`` with ``k =
    PRNGKey(seed)``, the train engine's call, as numpy ``params`` and
    ``batch_stats`` trees: every parameter from the recorded initializer
    and key, every BN statistic its constant."""
    rec, traced = {}, []

    def init(k):
        traced.append(k)
        return jm.init({"params": k, "dropout": k}, *args)

    with recording(rec):
        shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    root = jax.random.PRNGKey(seed)
    tree = {"params": {}, "batch_stats": {}}
    for (col, path), (fn, a, kw, suffix, rng) in rec.items():
        assert rng is traced[0], f"{path}: not keyed from the root key"
        node = tree[col]
        for name in path[:-1]:
            node = node.setdefault(name, {})
        with flat_samplers():
            node[path[-1]] = np.asarray(
                fn(fscope._fold_in_static(root, suffix), *a, **kw),
                np.float32)
    for p, leaf in jax.tree_util.tree_flatten_with_path(
            shapes.get("batch_stats", {}))[0]:
        names = [str(getattr(k, "key", k)) for k in p]
        node = tree["batch_stats"]
        for name in names[:-1]:
            node = node.setdefault(name, {})
        node[names[-1]] = np.full(leaf.shape, names[-1] == "var",
                                  np.float32)
    return tree


def flax_init(jm, seed: int, *args) -> dict:
    """``flax_tree`` in the port's layout."""
    return from_jax_variables(flax_tree(jm, seed, *args))


def compare(pm: torch.nn.Module, want: dict, drawn: dict | None = None
            ) -> dict:
    """The port's ``drawn`` state (``init_weights_`` at seed 0 by default)
    against ``want`` entry by entry: bitwise, or within ``NORMAL_ULP`` of
    the unit draw for normal-law entries.  Returns counts and the largest
    gap found, in ulp."""
    laws = init_laws(pm)
    drawn = drawn or {k: v.clone() for k, v in
                      init_weights_(pm, 0).state_dict().items()}
    assert set(drawn) == set(want), sorted(set(drawn) ^ set(want))
    fails, exact, worst = [], 0, 0.0
    for key, w in want.items():
        got, w = drawn[key].numpy(), w.numpy()
        if np.array_equal(got, w):
            exact += 1
            continue
        law = laws[key]
        gap = np.abs(got.astype(np.float64) - w) / np.spacing(
            np.float32(law.factor) * np.maximum(np.abs(w / law.factor),
                                                np.float32(1e-30)))
        worst = max(worst, float(gap.max()))
        if law.kind not in ("normal", "truncated_normal") or (
                gap.max() > NORMAL_ULP):
            fails.append(f"{key} ({law}): {(got != w).sum()} of {w.size} "
                         f"differ, up to {gap.max():.3g} ulp")
    assert not fails, "\n".join(fails)
    return {"exact": exact, "entries": len(want), "worst_ulp": worst}


_DONE: dict = {}


def preset_pair(preset: str, opts: list[str]):
    jm = jax_build(jax_config(preset, opts).model)
    return jm, build_model(get_config(preset, opts).model)


def check_preset(preset: str, opts: list[str]) -> dict:
    """``compare`` of the preset under ``opts`` (64x64 input), once for
    equal models."""
    jm, pm = preset_pair(preset, opts)
    key = (jm, repr(get_config(preset, opts).model))
    if key not in _DONE:
        x = jnp.zeros((1, 64, 64, 3), jnp.float32)
        _DONE[key] = compare(pm, flax_init(jm, 0, x, True))
    return _DONE[key]


def _opts(preset: str) -> list[str]:
    return TINY_FPN if ("fpn" in preset) else TINY_OPTS


@pytest.mark.parametrize("compat", [False, True])
@pytest.mark.parametrize("preset", list(PRESETS))
def test_init_weights_is_flax_init(preset, compat):
    counts = check_preset(preset, _opts(preset) + [f"model.compat={compat}"])
    assert counts["exact"] > 0.9 * counts["entries"], counts


@pytest.mark.parametrize("option", ["model.decoder='dab'",
                                    "model.masked_attention=True",
                                    "model.neuron='plif'"])
def test_head_and_neuron_variants_are_flax_init(option):
    """The DAB decoder (anchors ``normal(1.0)``, the sixth of the head's
    own parameters), the Mask2Former mode, and PLIF's 0-d ``w``."""
    preset = "fpn_sdtv3_512x512_10M_ade20k" if "plif" in option else FLAGSHIP
    counts = check_preset(preset, _opts(preset) + [option])
    assert counts["entries"] > 100


@pytest.mark.parametrize("name", sorted(LIBRARY))
def test_library_modules_are_flax_init(name):
    jm, pm, args = LIBRARY[name]()
    counts = compare(pm, flax_init(jm, 0, *args))
    assert counts["entries"] > 0


@functools.cache
def _compiled_remat_init() -> dict:
    """A compiled ``model.init`` of the tiny flagship under ``model.remat``
    (seed 3), in the port's layout."""
    jm, _ = preset_pair(FLAGSHIP, TINY_OPTS + ["model.remat=True"])
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    return from_jax_variables(jax.jit(
        lambda k: jm.init({"params": k, "dropout": k}, x, True))(
            jax.random.PRNGKey(3)))


@pytest.mark.parametrize("against", ["recorder", "port"])
def test_compiled_model_init_under_remat(against):
    """A compiled ``model.init`` of the tiny flagship under ``model.remat``
    (seed 3) bitwise against the recorder's variables of the flagship
    without it (flax's lifted ``nn.remat`` hands its scopes keys of its
    own, which the recorder does not follow, but the keys and so the
    variables are the same), or against the port's draw, which knows
    nothing of remat."""
    real = _compiled_remat_init()
    if against == "recorder":
        jm, _ = preset_pair(FLAGSHIP, TINY_OPTS)
        recorded = flax_init(jm, 3, jnp.zeros((1, 64, 64, 3), jnp.float32),
                             True)
        assert set(real) == set(recorded)
        for key in real:
            np.testing.assert_array_equal(recorded[key].numpy(),
                                          real[key].numpy(), err_msg=key)
        return
    _, pm = preset_pair(FLAGSHIP, TINY_OPTS + ["model.remat=True"])
    drawn = {k: v.clone() for k, v in
             init_weights_(pm, 3).state_dict().items()}
    counts = compare(pm, real, drawn)
    assert counts["exact"] == counts["entries"], counts


@pytest.mark.parametrize("seed", [0, 1])
def test_flat_samplers_are_jax_samplers(seed):
    """``flat_samplers``' draws (a power-of-two flat draw, cut) are
    ``jax.random``'s of the shape itself, bitwise."""
    k = jax.random.PRNGKey(seed)
    calls = [lambda: jax.random.normal(k, (3, 3, 5, 7)),
             lambda: jax.random.truncated_normal(k, -2.0, 2.0, (33, 4)),
             lambda: jax.random.uniform(k, (9, 1, 2), jnp.float32, -1, 1),
             lambda: jax.random.normal(k, ())]
    want = [np.asarray(c()) for c in calls]
    with flat_samplers():
        got = [np.asarray(c()) for c in calls]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))


def _fast_want(jm, *args) -> dict:
    return from_jax_variables(fast_variables(jm, *args, seed=5,
                                             scale=0.05))


@pytest.mark.parametrize("preset,opts", [
    (FLAGSHIP, []), ("fpn_msresnet18_512x512_ade20k", []),
    ("fpn_sdtv3_512x512_10M_ade20k", ["model.neuron='plif'"])])
def test_fast_init_is_fast_variables(preset, opts):
    """``fast_init_`` and ``fast_variables`` are both numpy: bitwise,
    BN statistics and the 0-d PLIF ``w`` included."""
    jm, pm = preset_pair(preset, _opts(preset) + opts)
    want = _fast_want(jm, jnp.zeros((1, 64, 64, 3), jnp.float32))
    got = fast_init_(pm, 5, 0.05).state_dict()
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), want[key].numpy(),
                                      err_msg=key)


def test_flax_entries_invert_from_jax_variables():
    """Each port entry's flax path and shape lead back to it through
    ``from_jax_variables``, kernels through the layout both share."""
    jm, pm = preset_pair(FLAGSHIP, TINY_OPTS)
    entries, sd = flax_entries(pm), pm.state_dict()
    assert set(entries) == set(sd)
    for key, e in entries.items():
        tree = np.arange(np.prod(e.shape), dtype=np.float32).reshape(e.shape)
        for name in reversed(e.path):
            tree = {name: tree}
        (back, value), = from_jax_variables({e.collection: tree}).items()
        assert back == key
        assert tuple(value.shape) == tuple(sd[key].shape)
        np.testing.assert_array_equal(
            e.to_port(torch.from_numpy(np.arange(
                np.prod(e.shape), dtype=np.float32).reshape(e.shape))),
            value.numpy())
