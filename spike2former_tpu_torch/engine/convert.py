"""JAX variables -> the port's state_dict.

The port names its submodules after the flax module names, so the mapping
is mechanical:

* the path joins with ``.``;
* ``kernel`` becomes ``weight``: HWIO conv kernels turn OIHW, width-1 token
  conv kernels ``(1, in, out)`` and Dense kernels ``(in, out)`` turn
  ``(out, in)`` for ``nn.Linear``;
* the flax ``BatchNorm`` wrapper holds an inner ``nn.BatchNorm`` named
  ``BatchNorm_0``; its ``scale``/``bias``/``mean``/``var`` fold into the
  port's one ``BatchNorm`` module.

The same holds for every head variant: the Mask2Former mode adds no
parameter, and the DAB-DETR head's ``dab_decoder/...`` (its Dense layers
and width-1 ``out_proj`` convs) and ``query_anchors`` map as above.  So
does the FPN family: PLIF's scalar ``w``, TEBN's ``temporal_scale``,
MS-ResNet's named ``stem_bn`` (flax's own ``nn.BatchNorm``, no wrapper)
and its ``ConvBNF/BatchNorm_0`` (flax's ``nn.BatchNorm`` directly in the
module, whose leaves fold into the port's ``ConvBNF``, itself the BN).
And so do the deformable encoder (``layer_<i>/gamma1``, ``gamma2``,
``self_attn/{value_proj,sampling_offsets,attention_weights,output_proj}``
token convs + BN, ``ffn``) and the Transformer and FPN pixel decoders
(``encoder_attn_<i>``, ``encoder_ffn_<i>``, ``last_feat_conv``,
``output_<i>``, beside the DCN decoder's names).

The library modules map the same way: a flax ``nn.LayerNorm``'s
``scale`` becomes the torch LayerNorm's ``weight`` (the modules named
``norm1``/``norm2`` in CycleMLP, ``query_norm`` in PEM cross-attention,
and flax's own ``LayerNorm_<i>``); plain parameters (``alpha``,
``gamma1``-``gamma3``, the spiking RNNs' ``hh_kernel`` [H, G*H] and
``hh_bias``) carry across as they are; the RNNs' ``linear_ih`` Dense
layers and an ``AnnSequential``'s auto-named ``layers_<i>`` (Dense or
Conv) as above.
Load the result with ``model.load_state_dict(sd, strict=True)``.

``flax_entries`` is the inverse: each state_dict entry of a port model ->
its flax variable (collection, path, shape and, for a parameter, its
``make_rng`` count in its scope), which ``engine/weights.py`` draws from
in flax's shape and turns into the port's layout with ``FlaxEntry.to_port``
(``kernel_to_port``, which ``from_jax_variables`` uses too).
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Iterator, Mapping

import numpy as np
import torch
from torch import nn

BN_LEAVES = ("scale", "bias", "mean", "var")
# flax nn.LayerNorm modules of the JAX package, by name
LAYER_NORM = re.compile(r"LayerNorm_\d+|norm\d+|query_norm")


def _leaves(tree: Mapping[str, Any], prefix=()) -> Iterator[tuple[tuple, Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def kernel_to_port(arr):
    """A flax kernel (numpy array or tensor) in the port's layout: HWIO
    conv kernels OIHW, width-1 token conv kernels ``(1, in, out)`` and
    Dense kernels ``(in, out)`` ``(out, in)``."""
    if arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1) if isinstance(arr, np.ndarray) \
            else arr.permute(3, 2, 0, 1)
    return arr[0].T if arr.ndim == 3 else arr.T


def from_jax_variables(variables: Mapping[str, Any]
                       ) -> dict[str, torch.Tensor]:
    """``variables`` (nested dicts of arrays with ``params`` and/or
    ``batch_stats``: initial, or as a train step returns them, gradients
    included) -> a state_dict, or the part of one, for the port's
    model."""
    sd = {}
    for col in ("params", "batch_stats"):
        for path, leaf in _leaves(variables.get(col, {})):
            *mods, name = path
            if name in BN_LEAVES and mods and mods[-1] == "BatchNorm_0":
                mods = mods[:-1]
            # a copy: arrays a JAX step hands back are read-only
            arr = np.array(leaf, dtype=np.float32)
            if name == "scale" and mods and LAYER_NORM.fullmatch(mods[-1]):
                name = "weight"
            if name == "kernel":
                name = "weight"
                arr = kernel_to_port(arr)
            key = ".".join(mods + [name])
            if key in sd:
                raise KeyError(f"two variables map to {key!r}")
            # (ascontiguousarray would turn a scalar leaf, PLIF's w, 1-d)
            sd[key] = torch.from_numpy(np.ascontiguousarray(arr).reshape(
                arr.shape))
    return sd


@dataclass(frozen=True)
class FlaxEntry:
    """A port state_dict entry's flax variable: ``collection``
    ('params' or 'batch_stats'), ``path`` (module names, then the leaf),
    ``shape`` (flax's; a width-1 token conv's ``(1, in, out)`` kernel is
    given as the Dense ``(in, out)``, which flattens alike) and ``counter``
    (the parameter's ``make_rng('params')`` count in its scope, 1-based:
    its key is ``fold_in_static(root, path[:-1] + (counter,))``; None
    where the port cannot tell, and for statistics)."""
    collection: str
    path: tuple[str, ...]
    shape: tuple[int, ...]
    counter: int | None

    def to_port(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` of ``shape`` in the port's layout."""
        return kernel_to_port(x) if self.path[-1] == "kernel" else x


# a leaf's place among its flax module's ``self.param`` calls: nn.Dense and
# nn.Conv declare kernel then bias, nn.LayerNorm and nn.BatchNorm scale then
# bias, nn.Embed its embedding
_LEAF_RANK = {"kernel": 0, "scale": 0, "embedding": 0, "bias": 1}


def flax_entries(model: nn.Module) -> dict[str, FlaxEntry]:
    """Every state_dict entry of the port model ``model`` -> its
    ``FlaxEntry``.  ``nn.Conv2d`` / ``nn.Linear`` weights are flax
    kernels, ``nn.LayerNorm`` weights scales; a module with a
    ``flax_scope`` attribute (the BatchNorms) keeps its leaves in that
    sub-scope (``BatchNorm_0`` of the JAX wrapper, none for flax's own
    ``nn.BatchNorm``), its ``mean`` / ``var`` in ``batch_stats``.  A module
    whose own scope holds several parameters of its own kind lists their
    JAX order in ``jax_param_order`` (names relative to it)."""
    out, scopes = {}, {}
    for prefix, m in model.named_modules():
        mods = tuple(prefix.split(".")) if prefix else ()
        scope = mods + tuple(getattr(m, "flax_scope", ()))
        entries = [(n, t, False) for n, t in m.named_parameters(
            recurse=False)] + [(n, t, True) for n, t in m.named_buffers(
                recurse=False)]
        key_of = {}
        for name, t, buffer in entries:
            key = ".".join(mods + (name,))
            leaf, shape = name, tuple(t.shape)
            if isinstance(m, (nn.Conv2d, nn.Linear)) and name == "weight":
                leaf = "kernel"
                shape = (shape[2:] + (shape[1], shape[0]) if t.dim() == 4
                         else (shape[1], shape[0]))
            elif isinstance(m, nn.LayerNorm) and name == "weight":
                leaf = "scale"
            col = "params"
            if buffer:
                if name not in ("mean", "var"):
                    continue    # not a flax variable (and not in the sd)
                col = "batch_stats"
            out[key] = FlaxEntry(col, scope + (leaf,), shape, None)
            if not buffer:
                key_of[name] = key
        if key_of:
            scopes[scope] = (m, key_of)
    for scope, (m, key_of) in scopes.items():
        order = getattr(m, "jax_param_order", None)
        if order is not None:
            ranked = [n for n in order if n in key_of]
        elif len(key_of) == 1 or all(out[k].path[-1] in _LEAF_RANK
                                     for k in key_of.values()):
            ranked = sorted(key_of, key=lambda n: _LEAF_RANK.get(
                out[key_of[n]].path[-1], 0))
        else:
            continue
        for i, name in enumerate(ranked):
            e = out[key_of[name]]
            out[key_of[name]] = FlaxEntry(e.collection, e.path, e.shape,
                                          i + 1)
    keys = set(model.state_dict())
    return {k: v for k, v in out.items() if k in keys}
