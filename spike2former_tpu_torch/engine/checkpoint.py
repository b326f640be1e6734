"""Loading reference checkpoints (port of ``load_torch_state_dict_raw`` and
``load_reference_model`` of ``spike2former_tpu/engine/checkpoint.py``): a
published mmseg ``EncoderDecoder`` ``.pth`` becomes a state dict of the
port's ``compat=True`` model."""
from __future__ import annotations

import pickle
import types

import numpy as np
import torch

from .convert import from_jax_variables
from .convert_reference import convert_spike2former


class _Inert:
    """Stands in for a pickled class or function outside the allowlist:
    it takes any arguments and any state, runs nothing and holds
    nothing."""

    def __new__(cls, *args, **kwargs):
        return object.__new__(cls)

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        pass

    def __setitem__(self, key, value):
        pass

    def append(self, item):
        pass

    def extend(self, items):
        pass


_ALLOWED = {("collections", "OrderedDict"), ("builtins", "set"),
            ("builtins", "frozenset"), ("torch", "Size"),
            ("torch", "device"), ("torch", "Tensor"),
            ("torch.nn.parameter", "Parameter"),
            ("torch._tensor", "_rebuild_from_type_v2")}


class _Unpickler(pickle.Unpickler):
    """Resolves only what a tensor state dict is made of: torch's tensor
    rebuild functions, dtypes, ``torch.Size``, ``OrderedDict`` (storage
    types are resolved by ``torch.load`` before this).  Any other global,
    such as mmengine's ``HistoryBuffer`` or a numpy scalar in a
    checkpoint's ``meta``, becomes an ``_Inert`` subclass named after it,
    without importing its module."""

    def find_class(self, module, name):
        if ((module, name) in _ALLOWED
                or (module == "torch._utils" and name.startswith("_rebuild_"))
                or (module == "torch"
                    and isinstance(getattr(torch, name, None), torch.dtype))):
            return super().find_class(module, name)
        return type(f"{module}.{name}", (_Inert,), {})


_restricted_pickle = types.ModuleType("restricted_pickle")
_restricted_pickle.Unpickler = _Unpickler
_restricted_pickle.load = lambda f, **kw: _Unpickler(f, **kw).load()


def load_torch_state_dict_raw(path: str) -> dict[str, np.ndarray]:
    """The tensors of a torch checkpoint as numpy, with their module
    prefixes (``backbone.``, ``decode_head.``), unwrapped from a
    ``state_dict`` or ``model`` entry.  The file is read by a restricted
    unpickler (``_Unpickler``): tensors and plain containers are rebuilt,
    every other pickled object (an mmengine checkpoint's ``meta``) is
    read as an inert placeholder, and no code of the file runs."""
    ckpt = torch.load(path, map_location="cpu",
                      pickle_module=_restricted_pickle, weights_only=False)
    for key in ("state_dict", "model"):
        if isinstance(ckpt, dict) and key in ckpt:
            ckpt = ckpt[key]
            break
    if not isinstance(ckpt, dict):
        raise ValueError(f"{path}: no state dict, found "
                         f"{type(ckpt).__name__}")
    out = {}
    for k, v in ckpt.items():
        if isinstance(v, _Inert):
            raise ValueError(f"{path}: {k} is a {type(v).__name__}, "
                             "not a tensor")
        out[k] = v.detach().numpy() if hasattr(v, "detach") else np.asarray(v)
    return out


def load_reference_model(path: str, *, depths_stage3: int = 6,
                         depths_stage4: int = 2, num_encoder_layers: int = 6,
                         num_decoder_layers: int = 6
                         ) -> dict[str, torch.Tensor]:
    """A full reference ``EncoderDecoder`` checkpoint (the ``load_from``
    flow, tools/test.py:104) -> a state dict for the port's SDTv2
    ``Spike2Former(compat=True)``, to load with ``strict=True``: the
    reference keys go to the JAX package's variable tree
    (``convert_reference.py``), then to the port's keys
    (``from_jax_variables``)."""
    return from_jax_variables(convert_spike2former(
        load_torch_state_dict_raw(path), depths_stage3=depths_stage3,
        depths_stage4=depths_stage4, num_encoder_layers=num_encoder_layers,
        num_decoder_layers=num_decoder_layers))
