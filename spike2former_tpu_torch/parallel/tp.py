"""Tensor parallelism over a mesh's ``model`` axis (port of
``spike2former_tpu/parallel/tp.py``): the Megatron column-then-row split
of every spiking FFN's hidden axis.

The JAX package annotates parameter shardings and lets GSPMD insert the
collectives.  Here ``shard_params_tp`` keeps each rank's slice of the
sharded tensors, in place, and the layers run the split themselves
(``models/layers.py:Linear``), over the mesh's model group:

* column-parallel (``ffn.Conv_0``, ``mask_embed.Dense_0``): the rank holds
  its rows of the weight (and of the bias); the input passes through
  ``copy_to_model``, the identity whose backward sums the input's
  gradient over the model group;
* row-parallel (``ffn.Conv_1``, ``mask_embed.Dense_1``): the rank holds
  its columns; its partial product, in float32, is summed over the model
  group by ``reduce_from_model`` (the backward is the identity) before
  the bias, which is added once;
* ``ffn.BatchNorm_0`` runs on its channel shard: per channel it is exact,
  and its training-mode moments go over the data group as any BN's.

The rules (``tp_pspec``) are JAX's, on the port's names (the flax paths
joined by ``.``, kernels as ``weight`` in ``(out, in)`` order): a width
the model axis does not divide stays replicated.  They are by name, so
they apply to every model with an ``ffn`` (``MSDAFFN``) or a
``mask_embed`` (``SpikeMLP3``).  ``gather_params_tp`` restores the
logical tensors of a state dict (``engine/checkpoint.py:save_state``
gathers before it writes, so a checkpoint equals a one-process one).
"""
from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.distributed as dist
from torch import nn

from .mesh import Mesh, current_mesh

# the ``Linear`` layers split by the rules, and how
COLUMN, ROW = "column", "row"


def tp_pspec(name: str, shape: Sequence[int], size: int) -> int | None:
    """The axis of the port's tensor ``name`` (a state-dict key) of
    ``shape`` that a model axis of ``size`` ranks splits, or None
    (replicated): JAX's ``tp_pspec`` (tp.py:48-77) on the port's layout.
    ``ffn.Conv_0.weight`` [F, C] splits its rows, ``ffn.Conv_0.bias`` and
    ``ffn.BatchNorm_0.*`` [F] their one axis, ``ffn.Conv_1.weight``
    [C, F] its columns; ``Conv_1.bias`` and ``BatchNorm_1`` stay whole;
    ``mask_embed.Dense_0.weight`` splits its rows and
    ``mask_embed.Dense_1.weight`` its columns."""
    parts = name.split(".")
    shape = tuple(shape)

    def split(axis: int) -> int | None:
        ok = len(shape) > axis and shape[axis] % size == 0
        return axis if ok else None

    if "ffn" in parts[:-1]:
        i = len(parts) - 1 - parts[::-1].index("ffn")
        sub = parts[i + 1:]
        if sub == ["Conv_0", "weight"] or sub == ["Conv_0", "bias"]:
            return split(0)
        if sub[:1] == ["BatchNorm_0"] and len(sub) == 2:
            return split(0)
        if sub == ["Conv_1", "weight"]:
            return split(1)
    if "mask_embed" in parts[:-1]:
        if parts[-2:] == ["Dense_0", "weight"]:
            return split(0)
        if parts[-2:] == ["Dense_1", "weight"]:
            return split(1)
    return None


class _CopyToModel(torch.autograd.Function):
    """The identity; the backward sums the gradient over the group
    (Megatron's ``f``: the input of a column-parallel layer)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """The sum over the group; the backward is the identity (Megatron's
    ``g``: every rank computes the same function of the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromModel.apply(x, group)


def _tensors(module: nn.Module):
    """(module, attribute, state-dict name, tensor) of every parameter
    and buffer of ``module``."""
    for prefix, mod in module.named_modules():
        for attr, t in list(mod.named_parameters(recurse=False)) + list(
                mod.named_buffers(recurse=False)):
            yield mod, attr, f"{prefix}.{attr}" if prefix else attr, t


@torch.no_grad()
def shard_params_tp(module_or_state: Any, mesh: Mesh | None = None) -> Any:
    """Keep this rank's slice (``mesh.model_rank`` of ``mesh.model_size``)
    of every tensor ``tp_pspec`` splits, in place: the parameters (their
    ``.data``, so an optimizer holding them sees the slices), BN buffers
    and, for a ``TrainState``, AdamW's moments; mark the split ``Linear``
    layers column- or row-parallel over the model group and record the
    layout on ``mesh``.  A model converted by ``from_jax_variables`` and
    then sharded computes what JAX's ``shard_params_tp`` tree computes.
    Returns its argument; nothing at a model axis of 1."""
    mesh = mesh or current_mesh()
    m = mesh.model_size
    if m <= 1:
        return module_or_state
    model = getattr(module_or_state, "model", module_or_state)
    axes = {}
    for mod, attr, name, t in _tensors(model):
        axis = tp_pspec(name, t.shape, m)
        if axis is None:
            continue
        piece = t.chunk(m, axis)[mesh.model_rank].contiguous().clone()
        mesh.layout[name] = (axis, t.shape[axis])
        axes[name] = axis
        if isinstance(t, nn.Parameter):
            t.data, t.grad = piece, None
            t.tp_axis, t.tp_group = axis, mesh.model
        else:
            setattr(mod, attr, piece)
        if attr == "weight" and hasattr(mod, "compute_dtype"):
            mod.tp = (COLUMN if axis == 0 else ROW, mesh.model)
    opt = getattr(module_or_state, "optimizer", None)
    if opt is not None:
        for moments in (opt.mu, opt.nu):
            for i, name in enumerate(opt.names):
                if name in axes:
                    moments[i] = moments[i].chunk(m, axes[name])[
                        mesh.model_rank].contiguous().clone()
    return module_or_state


@torch.no_grad()
def gather_params_tp(state_dict: dict, mesh: Mesh | None = None) -> dict:
    """A copy of ``state_dict`` (a model's, or a dict of such dicts, as
    AdamW's moments by name) with every tensor ``shard_params_tp``
    split gathered over the model group into its logical tensor: what a
    one-process model holds.  Every rank of the model group calls it."""
    mesh = mesh or current_mesh()
    out = {}
    for k, v in state_dict.items():
        if isinstance(v, dict):
            out[k] = gather_params_tp(v, mesh)
            continue
        axis, size = mesh.layout.get(k, (None, None))
        if (mesh.model_size <= 1 or axis is None
                or not isinstance(v, torch.Tensor)
                or v.shape[axis] * mesh.model_size != size):
            out[k] = v
            continue
        parts = [torch.empty_like(v) for _ in range(mesh.model_size)]
        dist.all_gather(parts, v.contiguous(), group=mesh.model)
        out[k] = torch.cat(parts, axis)
    return out


def tp_sharded(p: torch.Tensor) -> bool:
    """Whether ``p`` is a parameter that ``shard_params_tp`` split."""
    return getattr(p, "tp_axis", None) is not None
