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

Load the result with ``model.load_state_dict(sd, strict=True)``.
"""
from __future__ import annotations

from typing import Any, Iterator, Mapping

import numpy as np
import torch

BN_LEAVES = ("scale", "bias", "mean", "var")


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
            if name == "kernel":
                name = "weight"
                arr = (arr.transpose(3, 2, 0, 1) if arr.ndim == 4
                       else arr[0].T if arr.ndim == 3 else arr.T)
            key = ".".join(mods + [name])
            if key in sd:
                raise KeyError(f"two variables map to {key!r}")
            sd[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return sd
