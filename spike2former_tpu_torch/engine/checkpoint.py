"""Train checkpoints and reference checkpoints (port of
``spike2former_tpu/engine/checkpoint.py``).

Train checkpoints (``save_state``, ``prune_checkpoints``,
``latest_checkpoint``, ``restore_state``, ``restore_variables``) follow the
JAX package's orbax ones in the port's own format: ``work_dir/ckpt_{step}``
is one ``torch.save`` file of plain tensors, ints and dicts, loadable with
``weights_only=True``: ``{"step", "model": the model's state dict
(parameters and BN buffers), "optimizer": AdamW.state_dict()}``.  A save
copies the state to the host inline and writes the file in a background
thread, under a temporary name that becomes ``ckpt_{step}`` only when the
file is whole.

Reference checkpoints (``load_torch_state_dict_raw``,
``load_reference_model``): a published mmseg ``EncoderDecoder`` ``.pth``
becomes a state dict of the port's ``compat=True`` model.
"""
from __future__ import annotations

import os
import pickle
import re
import types
from concurrent.futures import Future, ThreadPoolExecutor
from typing import TYPE_CHECKING

import numpy as np
import torch

from .convert import from_jax_variables
from .convert_reference import (convert_sdtv2_backbone,
                                convert_sdtv3_backbone, convert_spike2former)

if TYPE_CHECKING:
    from .train import TrainState

# One writer thread for the process, so that saves reach the disk in the
# order they were made, and the saves not yet known to be written.
_WRITER: ThreadPoolExecutor | None = None
_PENDING: list[Future] = []


def wait_for_saves() -> None:
    """Block until every save made so far is on disk; raise a failed
    save's error."""
    while _PENDING:
        _PENDING.pop(0).result()


def _host_copy(tensors: dict) -> dict:
    """Host copies of a (nested) dict of tensors, complete on return: the
    device's are copied into pinned memory behind the work already queued
    on the stream, then the stream is synchronized, so a step that later
    updates a tensor in place cannot reach the copy."""
    def copy(t):
        if isinstance(t, dict):
            return {k: copy(v) for k, v in t.items()}
        if not isinstance(t, torch.Tensor):
            return t
        t = t.detach()
        return (t.to("cpu", non_blocking=True) if t.is_cuda
                else t.clone())

    out = copy(tensors)
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return out


def _write(obj: dict, path: str) -> None:
    tmp = f"{path}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_state(work_dir: str, state: TrainState, step: int, *,
               wait: bool = False, keep: int | None = None) -> str:
    """Checkpoint ``state`` as ``work_dir/ckpt_{step}``; returns its path.

    The host copy is made before this returns; the file is written in the
    background unless ``wait``.  ``keep``: retain only the newest ``keep``
    checkpoints (mmengine's ``max_keep_ckpts``), this one counted."""
    global _WRITER
    wait_for_saves()
    os.makedirs(work_dir, exist_ok=True)
    path = os.path.abspath(os.path.join(work_dir, f"ckpt_{step}"))
    obj = _host_copy({"step": int(step),
                      "model": state.model.state_dict(),
                      "optimizer": state.optimizer.state_dict()})
    if _WRITER is None:
        _WRITER = ThreadPoolExecutor(1, thread_name_prefix="ckpt-writer")
    _PENDING.append(_WRITER.submit(_write, obj, path))
    if wait:
        wait_for_saves()
    if keep is not None:
        # this save counts toward ``keep`` whether or not it is written:
        # keep - 1 of the others
        prune_checkpoints(work_dir, keep - 1, protect={path})
    return path


def prune_checkpoints(work_dir: str, keep: int,
                      protect=frozenset()) -> list[str]:
    """Delete all but the newest ``keep`` ``ckpt_*`` (by step).  Paths in
    ``protect`` (absolute) are left out before counting and never
    removed; ``keep=0`` removes every other one.  Returns the removed
    paths."""
    if keep < 0:
        return []
    ckpts = sorted(_list_ckpts(work_dir), key=lambda d: int(d.split("_")[1]))
    cand = [os.path.abspath(os.path.join(work_dir, d)) for d in ckpts]
    cand = [p for p in cand if p not in protect]
    remove = cand[:-keep] if keep > 0 else cand
    for path in remove:
        os.remove(path)
    return remove


def _list_ckpts(work_dir: str) -> list[str]:
    """The written ``ckpt_<step>`` files (a save in flight still has its
    temporary name)."""
    if not os.path.isdir(work_dir):
        return []
    return [d for d in os.listdir(work_dir) if re.fullmatch(r"ckpt_\d+", d)]


def latest_checkpoint(work_dir: str) -> str | None:
    """The written checkpoint of the highest step, or None."""
    ckpts = _list_ckpts(work_dir)
    if not ckpts:
        return None
    return os.path.join(work_dir,
                        max(ckpts, key=lambda d: int(d.split("_")[1])))


def _load(path: str) -> dict:
    wait_for_saves()
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_state(path: str, state: TrainState) -> TrainState:
    """Load a train checkpoint into ``state`` in place (the model
    strictly, the optimizer's count and moments, the step), on the
    devices ``state`` lives on."""
    ckpt = _load(path)
    state.model.load_state_dict(ckpt["model"], strict=True)
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step = int(ckpt["step"])
    return state


def restore_variables(path: str) -> dict[str, torch.Tensor]:
    """The model's state dict from a train checkpoint of ``save_state``
    or from a bare state dict saved by ``torch.save`` (the reference's
    ``load_from`` takes training checkpoints the same way)."""
    ckpt = _load(path)
    return ckpt["model"] if "model" in ckpt and "optimizer" in ckpt else ckpt


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


def load_reference_backbone(path: str, state_dict: dict[str, torch.Tensor],
                            depths_stage3: int = 6, depths_stage4: int = 2,
                            variant: str = "sdtv2"
                            ) -> dict[str, torch.Tensor]:
    """A reference checkpoint's backbone (the init_cfg Pretrained flow,
    sdtv2.py:577-612) in a port model's ``state_dict``: the
    ``backbone.*`` entries of a copy of ``state_dict`` replaced by the
    checkpoint's (its ``backbone.`` prefix stripped when present),
    carried over by ``convert_sdtv2_backbone`` or
    ``convert_sdtv3_backbone`` (``variant`` 'sdtv3' or 'sdtv3mae').  The
    backbone's keys must be the model's exactly."""
    sd = {(k[len("backbone."):] if k.startswith("backbone.") else k): v
          for k, v in load_torch_state_dict_raw(path).items()}
    if variant == "sdtv2":
        tree = convert_sdtv2_backbone(sd, depths_stage3, depths_stage4)
    else:
        tree = convert_sdtv3_backbone(sd, depths_stage3, depths_stage4,
                                      mae=variant == "sdtv3mae")
    backbone = {f"backbone.{k}": v
                for k, v in from_jax_variables(tree).items()}
    have = {k for k in state_dict if k.startswith("backbone.")}
    if have != set(backbone):
        raise KeyError(f"backbone keys differ: "
                       f"{sorted(have ^ set(backbone))[:8]}")
    return dict(state_dict, **backbone)


def load_reference_model(path: str, *, variant: str = "sdtv2",
                         depths_stage3: int = 6, depths_stage4: int = 2,
                         num_encoder_layers: int = 6,
                         num_decoder_layers: int = 6
                         ) -> dict[str, torch.Tensor]:
    """A full reference ``EncoderDecoder`` checkpoint (the ``load_from``
    flow, tools/test.py:104) -> a state dict for the port's
    ``Spike2Former(compat=True, variant=variant)``, to load with
    ``strict=True``: the reference keys go to the JAX package's variable
    tree by the variant's key map (``convert_reference.py``), then to the
    port's keys (``from_jax_variables``).  A checkpoint of another
    variant raises ``KeyError``."""
    return from_jax_variables(convert_spike2former(
        load_torch_state_dict_raw(path), variant=variant,
        depths_stage3=depths_stage3, depths_stage4=depths_stage4,
        num_encoder_layers=num_encoder_layers,
        num_decoder_layers=num_decoder_layers))
