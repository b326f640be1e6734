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
"""
from __future__ import annotations

import re
from typing import Any, Iterator, Mapping

import numpy as np
import torch

BN_LEAVES = ("scale", "bias", "mean", "var")
# flax nn.LayerNorm modules of the JAX package, by name
LAYER_NORM = re.compile(r"LayerNorm_\d+|norm\d+|query_norm")


def _leaves(tree: Mapping[str, Any], prefix=()) -> Iterator[tuple[tuple, Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


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
                arr = (arr.transpose(3, 2, 0, 1) if arr.ndim == 4
                       else arr[0].T if arr.ndim == 3 else arr.T)
            key = ".".join(mods + [name])
            if key in sd:
                raise KeyError(f"two variables map to {key!r}")
            sd[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return sd
