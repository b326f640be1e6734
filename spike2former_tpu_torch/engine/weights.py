"""Initial weights of a port model that has no checkpoint.

``init_weights_`` is the counterpart of flax's ``model.init``, which every
JAX entry point that starts without a checkpoint calls: each entry of the
state_dict from the law ``init_laws`` gives it (``models/initializers.py``:
flax's defaults by module type, or the law the owning module declares).
``fast_init_`` is the counterpart of ``utils/initfast.py:fast_variables``,
which the JAX benchmark tool calls.  Both draw from a CPU
``torch.Generator``: the laws are flax's, the draws are not JAX's.

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

import torch
from torch import nn

from ..models import initializers as init
from ..models.layers import BatchNorm, BNAndPad


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


def _draw_(model: nn.Module, laws: dict[str, init.Law], seed: int
           ) -> nn.Module:
    gen = torch.Generator().manual_seed(seed)
    sd = model.state_dict(keep_vars=True)
    for key, law in laws.items():
        law.draw_(sd[key], gen)
    return model


def init_weights_(model: nn.Module, seed: int = 0) -> nn.Module:
    """Draw every state_dict entry of ``model`` in place from its law
    (``init_laws``), in state_dict order, from a CPU ``torch.Generator``
    seeded with ``seed``; returns ``model``."""
    return _draw_(model, init_laws(model), seed)


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
    """Draw every state_dict entry of ``model`` in place from its
    ``fast_laws`` law, as ``init_weights_`` does; returns ``model``."""
    return _draw_(model, fast_laws(model, scale), seed)


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
