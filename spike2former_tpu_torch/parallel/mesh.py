"""Data-parallel training across processes (port of
``spike2former_tpu/parallel/mesh.py``): the reference's DDP over NCCL
(``tools/dist_train.sh``), one process a card.

The JAX package compiles its step once over a mesh whose ``data`` axis
shards the batch, so every reduction over the batch is a reduction over
the global batch, and XLA inserts the collectives.  The port runs one
step a process on that process's rows and makes each such reduction
global itself, inside ``global_batch()`` (the train steps open it when a
process group of more than one rank exists):

* training-mode BatchNorm statistics (``batch_moments``): the count, the
  sum and the centred sum of squares are summed over the ranks with a
  differentiable all-reduce, so the batch mean and variance pass their
  gradient to every rank's rows;
* loss normalizers (``global_sum``): the MaskFormer's ``num_total_masks``
  and class-weight sums; the FPN family's pixel losses see the whole
  batch (``gather_rows``), since OHEM and Lovász sort over it;
* random draws (``global_draw``): each rank draws the global batch's
  uniforms and keeps its own rows, so the draws are the one-process run's;
* gradients (``all_reduce_grads``): summed in one flat buffer before the
  global-norm clip; the logged metrics are the global ones.

``make_mesh(model_axis)`` is JAX's ``make_mesh`` for process groups: the
world's ranks as a ``data`` x ``model`` grid, each model group
``model_axis`` consecutive ranks, as JAX's ``reshape(n // model_axis,
model_axis)`` lays the devices out.  What a sharded array type and its
compiler do in JAX is written out in the layers: every reduction above
runs over the mesh's data group (the world without a mesh, or with
``model_axis=1``: the default group, as before meshes); the model group
carries the tensor-parallel FFNs (``parallel/tp.py``) and the data group
the row bands of spatially sharded inference (``parallel/spatial.py``).
``shard_batch`` gives a data rank its rows and ``replicate`` broadcasts
the first data rank's state over its data group.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import socket
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable

import torch
import torch.distributed as dist


@dataclass
class Mesh:
    """The world's ranks as a ``data`` x ``model`` grid: this rank's data
    group (the ranks that hold the same model shard) and model group (the
    ranks that share one data rank), with its place and the size of each.
    A group of None is the default group (``data``) or no group
    (``model``, size 1).  ``layout`` is filled by
    ``tp.shard_params_tp``: the sharded tensors' names, each with its
    split axis and logical size."""

    data: Any = None
    model: Any = None
    data_rank: int = 0
    data_size: int = 1
    model_rank: int = 0
    model_size: int = 1
    layout: dict = field(default_factory=dict)


_MESH = [None]      # the mesh of ``make_mesh``; None: the world as data
_ACTIVE = [None]    # the mesh inside ``global_batch()``; every thread


def make_mesh(model_axis: int = 1) -> Mesh:
    """The ``('data', 'model')`` groups of the world (JAX ``make_mesh``):
    model groups of ``model_axis`` consecutive ranks, data groups of the
    ranks ``model_axis`` apart.  Every rank calls it, in the same order
    (``new_group`` is collective); it becomes the process's mesh
    (``current_mesh``), which the reductions of ``global_batch()`` read.
    With ``model_axis=1`` the data group is the default group itself."""
    rank, n = world()
    if model_axis < 1 or n % model_axis:
        raise ValueError(f"{n} ranks do not split into model groups of "
                         f"{model_axis}")
    mesh = Mesh(data_rank=rank // model_axis, data_size=n // model_axis,
                model_rank=rank % model_axis, model_size=model_axis)
    if model_axis > 1:
        for i in range(n // model_axis):
            g = dist.new_group(list(range(i * model_axis,
                                          (i + 1) * model_axis)))
            if i == mesh.data_rank:
                mesh.model = g
        if n > model_axis:
            for j in range(model_axis):
                g = dist.new_group(list(range(j, n, model_axis)))
                if j == mesh.model_rank:
                    mesh.data = g
    _MESH[0] = mesh
    return mesh


def current_mesh() -> Mesh:
    """The mesh ``make_mesh`` made last in this process, or the world as
    one data axis."""
    if _MESH[0] is not None:
        return _MESH[0]
    rank, n = world()
    return Mesh(data_rank=rank, data_size=n)


def distributed_init(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None) -> tuple[int, int]:
    """Join the process group of ``num_processes`` ranks at
    ``coordinator_address`` (``host:port``, a TCP store that rank 0
    serves) as rank ``process_id``; returns (rank, world size).

    ``backend`` defaults to ``nccl`` where CUDA is available and ``gloo``
    otherwise; pass ``gloo`` to run several ranks on one card, which NCCL
    refuses.  Under NCCL each rank takes card ``rank % device_count``.
    Without a coordinator the ``MASTER_ADDR``/``MASTER_PORT`` of the
    environment (torchrun's) are read, and a single process takes a free
    local port.  Safe to call twice (the second call returns the group
    that exists) and to skip for one process, as the JAX function is."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    n = num_processes or int(os.environ.get("WORLD_SIZE", "1"))
    rank = (process_id if process_id is not None
            else int(os.environ.get("RANK", "0")))
    if coordinator_address is None:
        if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
            coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                                   f"{os.environ['MASTER_PORT']}")
        elif n == 1:
            coordinator_address = f"localhost:{free_port()}"
        else:
            raise ValueError(f"{n} processes need a coordinator address")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}", world_size=n,
        rank=rank, timeout=datetime.timedelta(minutes=30))
    return dist.get_rank(), dist.get_world_size()


def free_port() -> int:
    """A TCP port on localhost that no socket holds now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def world() -> tuple[int, int]:
    """(rank, world size) of the default process group; (0, 1) without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def barrier() -> None:
    """Wait for every rank; nothing without a process group."""
    if world()[1] > 1:
        dist.barrier()


def shutdown() -> None:
    """Leave the process group, if there is one, and forget the mesh."""
    _MESH[0] = None
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


@contextlib.contextmanager
def global_batch():
    """Inside the block, where the data axis of ``current_mesh()`` has
    more than one rank, the reductions below run over every data rank's
    rows.  The flag is process-wide: the autograd engine runs a card's
    backward, and with it the recomputations of checkpointed blocks, on a
    thread of its own."""
    mesh = current_mesh()
    prev = _ACTIVE[0]
    _ACTIVE[0] = mesh if mesh.data_size > 1 else None
    try:
        yield
    finally:
        _ACTIVE[0] = prev


def synced() -> bool:
    """Whether the reductions run over every data rank now."""
    return _ACTIVE[0] is not None


def _data() -> Mesh:
    return _ACTIVE[0] or current_mesh()


def _all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the data group in place; returns it."""
    dist.all_reduce(t, group=_data().data)
    return t


def _all_gather(t: torch.Tensor) -> torch.Tensor:
    """Every data rank's ``t``, concatenated along axis 0 in rank
    order."""
    mesh = _data()
    parts = [torch.empty_like(t) for _ in range(mesh.data_size)]
    dist.all_gather(parts, t.contiguous(), group=mesh.data)
    return torch.cat(parts)


class _AllSum(torch.autograd.Function):
    """All-reduce sum whose backward sums the incoming gradients over the
    ranks: each rank's loss may read the sum, so every rank's share of
    it feeds every rank's input."""

    @staticmethod
    def forward(ctx, x):
        return _all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_(grad.clone())


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks inside ``global_batch()``, with the
    gradient of the sum; ``x`` otherwise."""
    if not synced():
        return x
    return _AllSum.apply(x)


def batch_moments(xf: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean, biased variance) of ``xf`` over all its leading axes, over
    every rank's rows inside ``global_batch()``.  The variance is the
    centred sum of squares over the count, as ``torch.var_mean`` takes
    it, without the cancellation of ``E[x^2] - E[x]^2``."""
    dims = tuple(range(xf.dim() - 1))
    if not synced():
        var, mean = torch.var_mean(xf, dims, correction=0)
        return mean, var
    count = xf.numel() // xf.shape[-1]
    sums = global_sum(torch.cat([xf.sum(dims), xf.new_tensor([count])]))
    mean = sums[:-1] / sums[-1]
    var = global_sum(((xf - mean) ** 2).sum(dims)) / sums[-1]
    return mean, var


def global_any(flag: torch.Tensor) -> bool:
    """A host bool: ``flag`` on any rank inside ``global_batch()``."""
    if not synced():
        return bool(flag)
    return bool(_all_reduce_(flag.detach().float().reshape(1)).item() > 0)


def global_draw(draw: Callable, axis: int = 0) -> Callable:
    """A draw of this rank's rows of the global batch's uniforms: the
    wrapped ``draw(shape, *args)`` is called with ``shape[axis]`` times
    the world size and the rank's block of that axis is kept, so each
    rank sees what a one-process run draws for its rows.  ``draw`` itself
    outside ``global_batch()``."""
    if not synced():
        return draw
    rank, size = _data().data_rank, _data().data_size

    def local(shape, *args):
        shape = tuple(shape)
        n = shape[axis]
        full = shape[:axis] + (n * size,) + shape[axis + 1:]
        return draw(full, *args).narrow(axis, rank * n, n)

    return local


class _GatherRows(torch.autograd.Function):
    """All-gather along axis 0; the backward keeps this rank's block of
    the gradient.  Every rank computes the same function of the gathered
    tensor, so the block is this rank's rows' whole gradient, and the
    summed parameter gradients (``all_reduce_grads``) are the global
    function's."""

    @staticmethod
    def forward(ctx, x):
        ctx.rank, ctx.n = _data().data_rank, x.shape[0]
        return _all_gather(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(0, ctx.rank * ctx.n, ctx.n)


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of ``x`` (axis 0), in rank order, inside
    ``global_batch()``: the global batch; ``x`` otherwise.  Its gradient
    flows to this rank's rows only (``_GatherRows``): use it where every
    rank then computes the same global loss."""
    if not synced():
        return x
    if x.requires_grad:
        return _GatherRows.apply(x)
    return _all_gather(x)


@torch.no_grad()
def all_reduce_grads(params: Iterable[torch.Tensor]) -> None:
    """Sum the ``.grad`` of ``params`` over the data ranks inside
    ``global_batch()``, as one flat buffer (parameters without a gradient
    stay so: every rank runs the same graph).  Under tensor parallelism
    the gradients of the parameters every rank of a model group holds
    whole are then its first rank's on every rank (one broadcast): the
    ranks compute the same gradient, but the card's atomics (the DCN
    sampler's backward, cuDNN's weight gradients) sum it in another
    order on each, and the replicas must stay bitwise equal."""
    params = [p for p in params if p.grad is not None]
    if synced() and params:
        _copy_flat_([p.grad for p in params], _all_reduce_)
    mesh = current_mesh()
    whole = [p.grad for p in params if getattr(p, "tp_axis", None) is None]
    if mesh.model_size > 1 and whole:
        src = dist.get_global_rank(mesh.model, 0)

        def first_rank(t):
            dist.broadcast(t, src, group=mesh.model)
            return t

        _copy_flat_(whole, first_rank)


def _copy_flat_(grads: list[torch.Tensor], collective) -> None:
    """``collective`` on one flat buffer of ``grads``, copied back."""
    flat = collective(torch.cat([g.reshape(-1) for g in grads]))
    parts = flat.split([g.numel() for g in grads])
    torch._foreach_copy_(grads, [f.view_as(g) for f, g in zip(parts, grads)])


@torch.no_grad()
def all_reduce_metrics(metrics: dict[str, torch.Tensor]
                       ) -> dict[str, torch.Tensor]:
    """``metrics`` summed over the ranks in one all-reduce inside
    ``global_batch()``: each rank's term of a loss whose normalizer is
    global adds up to the global loss, and counts add up."""
    if not synced() or not metrics:
        return metrics
    flat = _all_reduce_(torch.stack([v.float() for v in metrics.values()]))
    return dict(zip(metrics, flat.unbind()))


def shard_batch(batch: Any, pid: int | None = None,
                pcount: int | None = None) -> Any:
    """Rank ``pid``'s rows of a global batch (a tensor, an array or a
    tuple of them, split along axis 0 into ``pcount`` equal blocks): the
    per-rank loader's convention, which the one-process run on the whole
    batch is held to.  By default the data rank and size of
    ``current_mesh()``: the ranks of a model group take the same rows."""
    if pid is None or pcount is None:
        mesh = current_mesh()
        pid, pcount = mesh.data_rank, mesh.data_size
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(b, pid, pcount) for b in batch)
    n = batch.shape[0]
    if n % pcount:
        raise ValueError(f"batch of {n} does not split into {pcount} ranks")
    k = n // pcount
    return batch[pid * k:(pid + 1) * k]


@torch.no_grad()
def replicate(module_or_state: Any) -> Any:
    """The first data rank's parameters and buffers (an ``nn.Module``, a
    ``TrainState`` or a dict of tensors) on every rank of its data group
    (``current_mesh()``'s: the world without tensor parallelism),
    broadcast in place; returns its argument.  Nothing without a process
    group."""
    mesh = current_mesh()
    if mesh.data_size <= 1:
        return module_or_state
    src = (0 if mesh.data is None
           else dist.get_global_rank(mesh.data, 0))
    obj = getattr(module_or_state, "model", module_or_state)
    tensors = (list(obj.state_dict().values())
               if isinstance(obj, torch.nn.Module) else list(obj.values()))
    for t in tensors:
        dist.broadcast(t, src, group=mesh.data)
    return module_or_state
