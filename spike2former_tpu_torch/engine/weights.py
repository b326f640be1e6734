"""Initial weights of a port model that has no checkpoint.

``init_weights_`` is the counterpart of flax's ``model.init``, which every
JAX entry point that starts without a checkpoint calls: each entry of the
state_dict from the law ``init_laws`` gives it (``models/initializers.py``:
flax's defaults by module type, or the law the owning module declares).
``fast_init_`` is the counterpart of ``utils/initfast.py:fast_variables``,
which the JAX benchmark tool calls.  Both draw JAX's numbers from the same
seed: ``init_weights_`` keys each entry as flax does
(``fold_in_static(PRNGKey(seed), scope + (n,))``, ``n`` the entry's
``make_rng`` count in its flax scope, ``engine/convert.py:flax_entries``)
and draws it in flax's shape with ``jax.random``'s samplers
(``utils/jax_random.py``), on the entry's device; ``fast_init_`` draws
numpy's normals in JAX's ``tree_flatten`` order, in flax's shapes.

``randomize_`` is the tests' draw (``tests/torch_golden.py:
randomize_torch``), not a law of the JAX package: layer-scale gammas and
BatchNorm statistics at O(1) (at flax's init the 1e-6 gammas keep whole
branches, the DCN one among them, numerically silent, and so does every
MS-ResNet residual branch, whose second BN scale starts at 0), conv and
linear weights at ``2/sqrt(fan_in)`` so that the q8 spikes fire at any
width.  Kernel checks and profilers that need weights that fire call it
explicitly.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..models import initializers as init
from ..models.layers import BatchNorm, BNAndPad
from ..utils import jax_random as jr
from .convert import flax_entries


def _default_law(m: nn.Module, name: str, t: torch.Tensor):
    """flax's default for ``m``'s own entry ``name``, or None."""
    if isinstance(m, (nn.Conv2d, nn.Linear)):
        # flax's fan_in, of an HWIO, (1, in, out) or (in, out) kernel, is
        # weight[0].numel() of its OIHW or (out, in) port tensor
        return (init.lecun_normal(t[0].numel()) if name == "weight"
                else init.zeros)
    if isinstance(m, (BatchNorm, BNAndPad)):
        return init.ones if name in ("scale", "var") else init.zeros
    if isinstance(m, nn.LayerNorm):
        return init.ones if name == "weight" else init.zeros
    return None


def init_laws(model: nn.Module) -> dict[str, init.Law]:
    """Every state_dict entry of ``model`` -> its initial law; raises
    ``KeyError`` naming the entries no module gives a law, or a module's
    ``init_laws`` names that are no entry."""
    laws = {}
    for prefix, m in model.named_modules():
        p = prefix + "." if prefix else ""
        for name, t in [*m.named_parameters(recurse=False),
                        *m.named_buffers(recurse=False)]:
            law = _default_law(m, name, t)
            if law is not None:
                laws[p + name] = law
    for prefix, m in model.named_modules():
        p = prefix + "." if prefix else ""
        for name, law in getattr(m, "init_laws", {}).items():
            laws[p + name] = law
    keys = list(model.state_dict())
    missing = [k for k in keys if k not in laws]
    unknown = sorted(set(laws) - set(keys))
    if missing or unknown:
        raise KeyError(f"no initial law for {missing}; laws of no entry "
                       f"{unknown}")
    return {k: laws[k] for k in keys}


def init_weights_(model: nn.Module, seed: int = 0) -> nn.Module:
    """Draw every state_dict entry of ``model`` in place, on its device,
    as flax's ``model.init(PRNGKey(seed))`` draws its variable: the
    entry's law (``init_laws``) from its flax key, in flax's shape, turned
    into the port's layout; returns ``model``.  Raises ``KeyError`` for a
    random entry whose flax ``make_rng`` count the port cannot tell."""
    laws, entries = init_laws(model), flax_entries(model)
    root = jr.key(seed)
    sd = model.state_dict(keep_vars=True)
    with torch.no_grad():
        for key, law in laws.items():
            t = sd[key]
            if law.kind == "constant":
                t.fill_(law.scale)
                continue
            e = entries[key]
            if e.counter is None:
                raise KeyError(f"{key}: the order of its flax scope's "
                               f"parameters is not declared")
            k = jr.fold_in_static(root, e.path[:-1] + (e.counter,))
            t.copy_(e.to_port(law.sample(k, e.shape, device=t.device)))
    return model


def fast_laws(model: nn.Module, scale: float = 0.05
              ) -> dict[str, init.Law]:
    """``fast_variables``' law of every state_dict entry: N(0, ``scale``)
    where the entry is floating with at least one axis, else 0, and 1 for
    every BN variance."""
    laws = {}
    for key, t in model.state_dict().items():
        if key.rsplit(".", 1)[-1] == "var":
            laws[key] = init.ones
        elif t.is_floating_point() and t.dim() >= 1:
            laws[key] = init.normal(scale)
        else:
            laws[key] = init.zeros
    return laws


def fast_init_(model: nn.Module, seed: int = 0, scale: float = 0.05
               ) -> nn.Module:
    """``fast_variables(seed, scale)``: ``np.random.default_rng(seed)
    .normal(0, scale)`` in float64, rounded to float32, for every floating
    entry with at least one axis in JAX's ``tree_flatten`` order (sorted
    collection, then path: ``batch_stats`` before ``params``) and flax's
    shape; 0 for the others, then 1 for every BN variance (drawn first,
    as JAX draws it); returns ``model``."""
    entries = flax_entries(model)
    rng = np.random.default_rng(seed)
    sd = model.state_dict(keep_vars=True)
    with torch.no_grad():
        for key in sorted(entries, key=lambda k: (entries[k].collection,
                                                  entries[k].path)):
            e, t = entries[key], sd[key]
            if e.path[-1] == "var":
                rng.normal(0.0, scale, e.shape)
                t.fill_(1.0)
            elif t.is_floating_point() and e.shape:
                t.copy_(e.to_port(torch.from_numpy(
                    rng.normal(0.0, scale, e.shape).astype(np.float32))))
            else:
                t.zero_()
    return model


def randomize_(model: nn.Module, seed: int = 0) -> nn.Module:
    """Draw every parameter and BN statistic of ``model`` in place from a
    CPU ``torch.Generator`` seeded with ``seed`` (the tests' draw, above);
    returns ``model`` in eval mode."""
    gen = torch.Generator().manual_seed(seed)

    def draw(t: torch.Tensor, kind: str, a: float, b: float):
        cpu = torch.empty(t.shape, dtype=t.dtype)
        getattr(cpu, kind)(a, b, generator=gen)
        t.copy_(cpu)

    covered = set()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (BatchNorm, BNAndPad)):
                draw(m.mean, "normal_", 0.0, 0.3)
                draw(m.var, "uniform_", 0.5, 2.0)
                draw(m.scale, "normal_", 1.0, 0.2)
                draw(m.bias, "normal_", 0.0, 0.2)
            elif isinstance(m, (nn.Conv2d, nn.Linear)):
                draw(m.weight, "normal_", 0.0, 2.0 / m.weight[0].numel() ** 0.5)
                if m.bias is not None:
                    draw(m.bias, "normal_", 0.0, 0.5)
            else:
                continue
            covered.update(id(p) for p in m.parameters(recurse=False))
        for p in model.parameters():
            if id(p) not in covered:  # gammas, w, queries, embeddings
                draw(p, "normal_", 0.5, 0.2)
    return model.eval()
