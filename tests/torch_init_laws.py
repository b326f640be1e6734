"""Shared set-up of the tests of the port's initial weights
(``engine/weights.py``): each leaf of a JAX model's ``model.init``, pooled
over fixed seeds, against the port's entry under the same name, pooled the
same way.

JAX's side: ``model.init`` is traced once (``jax.eval_shape``), with
flax's ``Module.param`` and ``Module.variable`` recording the initializer
each module declares for each leaf and the arguments flax gives it.  Each
initializer is then called with ``PRNGKey(s)`` for the seeds ``s`` a pool
needs, as ``model.init`` calls it with the key flax folds for the leaf:
the same law, without compiling the model's forward once per seed (an
XLA compile of a tiny model's init takes ~25 s on the CPU, the trace ~2 s).

The port's side: ``init_laws(model)`` gives each state_dict entry its law
and ``init_weights_`` draws each entry from it; the pool draws the entry's
law at the entry's shape from one key (``Law.sample``).

A leaf is constant when two seeds give the same bits; a constant leaf must
equal the port's bit for bit.  A random leaf's pools hold at least
``POOL`` samples a side (a std ratio's standard error is then 1%) and
must pass a two-sample KS test at ``KS_P``, agree in std within
``STD_RTOL`` and stay within the law's bound on |x|.  A leaf whose KS p
falls below ``KS_P`` is drawn again, on other seeds on both sides, and
fails when that pair falls below it too: of the ~600 distinct leaves of
the files that use this module, each of a law equal on both sides, one
in a thousand would fall below ``KS_P`` by chance on one pair (one did),
one in a million on two; a law that differs falls far below it on both
(``randomize_``, the entry points' draw before flax's laws: p = 0 for
``head.query_feat``, 4.9e-117 for ``head.mask_embed.Dense_0.weight``).
"""
from __future__ import annotations

import math
from contextlib import contextmanager

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import linen as fnn
from scipy import stats

from spike2former_tpu_torch.engine.convert import from_jax_variables
from spike2former_tpu_torch.engine.weights import (fast_init_, fast_laws,
                                                   init_laws, init_weights_)
from spike2former_tpu_torch.utils import jax_random

POOL = 10_000
# the bit generator of the pools: XLA compiles its draws in a third of
# threefry's time; the laws do not depend on it
PRNG = "unsafe_rbg"
KS_P, STD_RTOL = 1e-3, 0.05
# a float32 product (a unit draw in (-2, 2) times the law's scale) may
# round past 2 * scale by an ulp
BOUND_ULP = 1.0 + 2.0 ** -20


@contextmanager
def recording(rec: dict):
    """Record ``(collection, path) -> (init_fn, args, kwargs, keyed)`` of
    every variable a flax module declares inside the block (first
    declaration wins)."""
    param, variable = fnn.Module.param, fnn.Module.variable

    def rec_param(self, name, init_fn, *args, **kw):
        rec.setdefault(("params", self.scope.path + (name,)),
                       (init_fn, args, {k: v for k, v in kw.items()
                                        if k != "unbox"}, True))
        return param(self, name, init_fn, *args, **kw)

    def rec_variable(self, col, name, init_fn=None, *args, **kw):
        if col in ("params", "batch_stats") and init_fn is not None:
            rec.setdefault((col, self.scope.path + (name,)),
                           (init_fn, args, {k: v for k, v in kw.items()
                                            if k != "unbox"}, False))
        return variable(self, col, name, init_fn, *args, **kw)

    fnn.Module.param, fnn.Module.variable = rec_param, rec_variable
    try:
        yield rec
    finally:
        fnn.Module.param, fnn.Module.variable = param, variable


def jax_initializers(jm, *init_args, **init_kwargs) -> dict:
    """``(collection, path) -> initializer record`` of ``jm.init``."""
    rec = {}
    with recording(rec):
        jax.eval_shape(lambda k: jm.init(k, *init_args, **init_kwargs),
                       jax.random.PRNGKey(0))
    return rec


def _nest(col: str, path: tuple, leaf) -> dict:
    tree = leaf
    for name in reversed(path):
        tree = {name: tree}
    return {col: tree}


# one initializer's draws, by what decides them: its code, its closure's
# values and its arguments (so modules of many models share the compiles
# of the draws at each shape, ~0.3 s each on the CPU)
_DRAWS: dict = {}


def _frozen(x):
    if isinstance(x, (list, tuple)):
        return tuple(_frozen(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((k, _frozen(v)) for k, v in x.items()))
    return x


def _identity(record):
    fn, args, kw, keyed = record
    call = _frozen((args, kw, keyed))
    try:
        key = (fn.__code__, _frozen(tuple(
            c.cell_contents for c in fn.__closure__ or ())), call)
        hash(key)
        return key
    except (TypeError, ValueError, AttributeError):
        return None     # drawn anew each time


def jax_draw(record, seed: int) -> np.ndarray:
    """The leaf ``record``'s initializer draws at ``PRNGKey(seed)``."""
    ident = _identity(record)
    if (ident, seed) in _DRAWS:
        return _DRAWS[ident, seed]
    fn, args, kw, keyed = record
    out = np.asarray(fn(jax.random.key(seed, impl=PRNG), *args, **kw) if keyed
                     else fn(*args, **kw), np.float32)
    if ident is not None:
        _DRAWS[ident, seed] = out
    return out


def need(numel: int) -> int:
    """Seeds a pool of ``POOL`` samples needs."""
    return max(2, math.ceil(POOL / max(numel, 1)))


def port_pool(law, shape, n: int, stage: int = 0) -> np.ndarray:
    """``n`` draws of the port's ``law`` at ``shape`` (a law's draw does
    not depend on the shape it fills: one draw of ``n`` stacked, from the
    key of seed ``1000 + stage``)."""
    return law.sample(jax_random.key(1000 + stage),
                      (n,) + tuple(shape)).numpy().ravel()


def _port_layout(col: str, path: tuple, leaf: np.ndarray):
    """(port key, the leaf in the port's layout)."""
    (key, value), = from_jax_variables(_nest(col, path, leaf)).items()
    return key, value.numpy()


def flax_leaves(jm, *init_args, **init_kwargs) -> dict:
    """Port key -> (seed 0's leaf and seed 1's in the port's layout, a
    function of (n, stage) -> the draws of seeds n * stage to
    n * (stage + 1) pooled) of ``jm.init``."""
    out = {}
    for (col, path), rec in jax_initializers(jm, *init_args,
                                             **init_kwargs).items():
        key, first = _port_layout(col, path, jax_draw(rec, 0))
        assert key not in out, key
        out[key] = (first, _port_layout(col, path, jax_draw(rec, 1))[1],
                    lambda n, stage, rec=rec: np.concatenate(
                        [jax_draw(rec, s).ravel()
                         for s in range(n * stage, n * (stage + 1))]))
    return out


def fast_leaves(jm, *init_args, **init_kwargs) -> dict:
    """As ``flax_leaves``, of ``utils/initfast.py:fast_variables``.  It is
    called once, on a stand-in model whose variables are the leaves of
    ``jm.init``, each stacked ``2 * need(numel)`` times on a new first axis
    (the pools of two stages):
    the same path names and dtype, and an axis where the leaf has one, so
    the same law (the law of a leaf without an axis is 0, its stand-in
    two copies of it).  One draw pools them all, where a call per seed
    would trace ``jm.init`` again for each."""
    from spike2former_tpu.utils.initfast import fast_variables

    shapes = jax.eval_shape(lambda k: jm.init(k, *init_args, **init_kwargs),
                            jax.random.PRNGKey(0))
    specs = {}
    for col in ("params", "batch_stats"):
        for path, spec in jax.tree_util.tree_flatten_with_path(
                shapes.get(col, {}))[0]:
            names = tuple(str(getattr(k, "key", k)) for k in path)
            specs[col, names] = (spec, 2 * need(int(np.prod(spec.shape))))

    def stand_in(spec, n):
        return ([jnp.zeros(spec.shape, spec.dtype)] * 2 if not spec.shape
                else jnp.zeros((n,) + spec.shape, spec.dtype))

    class StandIn:
        @staticmethod
        def init(_key):
            tree = {}
            for (col, names), (spec, n) in specs.items():
                node = tree.setdefault(col, {})
                for name in names[:-1]:
                    node = node.setdefault(name, {})
                node[names[-1]] = stand_in(spec, n)
            return tree

    drawn = fast_variables(StandIn())
    out = {}
    for (col, names), (spec, n) in specs.items():
        node = drawn[col]
        for name in names:
            node = node[name]
        stack = (np.asarray(node, np.float32) if spec.shape
                 else [np.asarray(x, np.float32) for x in node])
        key, first = _port_layout(col, names, stack[0])
        out[key] = (first, _port_layout(col, names, stack[1])[1],
                    lambda k, stage, x=stack: np.concatenate(
                        [v.ravel() for v in x[k * stage:k * (stage + 1)]]))
    return out


def check_random(key, pool, law, shape) -> list[str]:
    """The failures of one random leaf (empty when it passes); ``pool``
    is the JAX side's (n, stage) -> draws."""
    fails = []
    n = need(int(np.prod(shape)))
    jax_pool, port = pool(n, 0), port_pool(law, shape, n)
    ps = [stats.ks_2samp(jax_pool, port).pvalue]
    if ps[0] < KS_P:
        ps.append(stats.ks_2samp(pool(n, 1),
                                 port_pool(law, shape, n, 1)).pvalue)
    if len(ps) == 2 and ps[1] < KS_P:
        fails.append(f"{key}: KS p={ps[0]:.2e}, then {ps[1]:.2e}")
    ratio = port.std() / jax_pool.std()
    if abs(ratio - 1.0) > STD_RTOL:
        fails.append(f"{key}: std ratio {ratio:.4f}")
    for side, x in (("jax", jax_pool), ("port", port)):
        if np.abs(x).max() > law.bound * BOUND_ULP:
            fails.append(f"{key}: {side} max |x| {np.abs(x).max():.4g} "
                         f"over the bound {law.bound:.4g}")
    return fails


def compare(leaves: dict, laws: dict, init_, pm: torch.nn.Module) -> dict:
    """``leaves`` (``flax_leaves`` or ``fast_leaves``) against the port's
    ``laws`` of ``pm`` and its draw ``init_(pm, seed)``: the key sets
    equal, every constant leaf bit for bit at seeds 0 and 1, every random
    leaf pooled to ``POOL`` samples a side (``check_random``).  Returns
    counts of constant and random leaves."""
    assert set(leaves) == set(laws), (sorted(set(leaves) - set(laws)),
                                      sorted(set(laws) - set(leaves)))
    drawn = [{k: v.detach().clone().numpy() for k, v in
              init_(pm, seed).state_dict().items()} for seed in (0, 1)]
    fails, n_const = [], 0
    for key, (first, second, pool) in leaves.items():
        got, law = drawn[0][key], laws[key]
        if np.array_equal(first, second):
            n_const += 1
            if not (np.array_equal(got, first)
                    and np.array_equal(drawn[1][key], got)):
                fails.append(f"{key}: constant {first.ravel()[:3]} != "
                             f"port {got.ravel()[:3]}")
            continue
        fails += check_random(key, pool, law, first.shape)
        if np.abs(got).max() > law.bound * BOUND_ULP:
            fails.append(f"{key}: the port's draw over the bound")
    assert not fails, "\n".join(fails)
    return {"constant": n_const, "random": len(leaves) - n_const}


def compare_init(jm, pm: torch.nn.Module, *init_args, **init_kwargs
                 ) -> dict:
    """Every leaf of ``jm.init`` against ``init_weights_(pm)``."""
    return compare(flax_leaves(jm, *init_args, **init_kwargs),
                   init_laws(pm), init_weights_, pm)


def compare_fast(jm, pm: torch.nn.Module, *init_args, **init_kwargs
                 ) -> dict:
    """Every leaf of ``fast_variables(jm)`` against ``fast_init_(pm)``."""
    return compare(fast_leaves(jm, *init_args, **init_kwargs),
                   fast_laws(pm), fast_init_, pm)


_DONE: dict = {}


def check_preset(preset: str, opts: list[str], fast: bool = False) -> dict:
    """``compare_init`` (``compare_fast`` with ``fast``) of the preset's
    JAX model and port model under ``opts`` on a 64x64 input, once for
    equal models (an equal flax module and an equal port config)."""
    from spike2former_tpu.engine.config import build_model as jax_build
    from spike2former_tpu.engine.config import get_config as jax_config
    from spike2former_tpu_torch.engine.config import build_model, get_config

    jm = jax_build(jax_config(preset, opts).model)
    cfg = get_config(preset, opts).model
    key = (jm, repr(cfg), fast)
    if key not in _DONE:
        x = jnp.zeros((1, 64, 64, 3), jnp.float32)
        _DONE[key] = (compare_fast if fast else compare_init)(
            jm, build_model(cfg), x)
    return _DONE[key]
