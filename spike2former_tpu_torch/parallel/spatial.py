"""Row-sharded (spatial) inference (port of
``spike2former_tpu/parallel/mesh.py:spatial_sharding``): the image height
split over the mesh's data axis, for large images (Cityscapes 1024x2048).

In JAX a sharding annotation on the input's height is enough: GSPMD
inserts the halo exchanges.  Here ``spatial_sharding()`` opens the same
regime for the layers, which exchange what they need themselves: inside
it each of the data group's R ranks holds rows ``[r0, r1)`` of every
activation (rank ``i`` the ``i``-th of R equal bands of the map at each
scale), and

* every convolution with a kernel taller than one row takes the halo it
  reads from its neighbours (``halo``; from further ranks where a halo is
  taller than a band) and pads with zeros only at the map's top and
  bottom (``models/layers.py:conv_nhwc``); ``BNAndPad`` writes its pad
  value only there;
* sums over every token (``k^T v`` of linear attention, the decoder's
  cross-attention over pixel tokens) are summed over the group
  (``all_sum_``), in float32, before any rounding;
* bilinear upsamples take one clamped halo row, and downscales by an
  integer factor read only their band's rows (``ops/resize.py``);
* what mixes pixels across the whole map (the DCN's value map, which
  its offsets may sample anywhere; the ``compat`` reshapes; the keys and
  values of attention whose queries are pixel tokens too) is gathered
  (``gather_rows_h``) and the rank keeps its rows;
* what the whole map decides per query (Mask2Former's "a query that
  masks every key is unmasked") is an all-reduce of the bands' counts.

Every model that ``engine/config.py:PRESETS`` builds, and the library
pixel decoders, run in this regime; the bands split the image at the
model's coarsest stride (``band_stride``: 16, or 32 for MS-ResNet).
Inference only (no gradients cross the group), as in JAX.  A module
without a sharded form raises a ``ValueError`` inside the block
(``refuse``).
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
import torch.distributed as dist

from .mesh import Mesh, current_mesh

# the coarsest scale of the MetaFormer pyramids: every level's band must
# have whole rows (a model with a coarser level says so in its
# ``band_stride``)
STRIDE = 16


class Bands(NamedTuple):
    group: object    # the data group (None: the default group)
    rank: int
    size: int


_BANDS: list[Bands | None] = [None]


@contextlib.contextmanager
def spatial_sharding(mesh: Mesh | None = None):
    """Inside the block, where the data axis of ``mesh`` (by default
    ``current_mesh()``) has more than one rank, activations are row bands
    over its data group."""
    mesh = mesh or current_mesh()
    prev = _BANDS[0]
    _BANDS[0] = (Bands(mesh.data, mesh.data_rank, mesh.data_size)
                 if mesh.data_size > 1 else None)
    try:
        yield
    finally:
        _BANDS[0] = prev


def bands() -> Bands | None:
    """The row bands in force, or None outside ``spatial_sharding()``."""
    return _BANDS[0]


def refuse(what: str) -> None:
    """Raise inside ``spatial_sharding()``: ``what`` has no row-sharded
    form."""
    if _BANDS[0] is not None:
        raise ValueError(f"{what} does not run under spatial sharding "
                         "(parallel.spatial_sharding)")


def rows(band: int) -> tuple[int, int]:
    """The global rows ``[r0, r1)`` of this rank's band of ``band``
    rows."""
    b = _BANDS[0]
    return b.rank * band, (b.rank + 1) * band


def band_rows(band: int) -> tuple[int, int] | None:
    """``rows(band)`` inside ``spatial_sharding()``, None outside."""
    return rows(band) if _BANDS[0] is not None else None


def shard_rows(images: torch.Tensor, axis: int = 1,
               stride: int = STRIDE) -> torch.Tensor:
    """This rank's band of ``images`` ([B, H, W, C]: ``axis`` 1) inside
    ``spatial_sharding()``; ``images`` outside.  H must split into equal
    bands at the pyramid's coarsest scale, ``stride`` (the model's
    ``band_stride``)."""
    b = _BANDS[0]
    if b is None:
        return images
    h = images.shape[axis]
    if h % (stride * b.size):
        raise ValueError(
            f"images of shape {tuple(images.shape)}: height {h} does not "
            f"split into {b.size} equal bands at /{stride} (a multiple of "
            f"{stride * b.size})")
    band = h // b.size
    return images.narrow(axis, b.rank * band, band)


def gather_rows_h(x: torch.Tensor, axis: int = 1) -> torch.Tensor:
    """Every rank's band of ``x`` concatenated along ``axis`` in rank
    order: the whole map (``x`` outside ``spatial_sharding()``)."""
    b = _BANDS[0]
    if b is None:
        return x
    parts = [torch.empty_like(x) for _ in range(b.size)]
    dist.all_gather(parts, x.contiguous(), group=b.group)
    return torch.cat(parts, axis)


def all_sum_(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the bands, in place (``t`` outside)."""
    b = _BANDS[0]
    if b is not None:
        dist.all_reduce(t, group=b.group)
    return t


def halo(x: torch.Tensor, axis: int, above: int, below: int,
         edge: str | torch.Tensor = "zeros") -> tuple[torch.Tensor, int]:
    """``x`` with the ``above`` rows before its band and the ``below``
    rows after it along ``axis``, from the ranks that hold them (in one
    all-gather of every rank's edge rows; a halo taller than a band takes
    whole bands of further ranks).  Rows off the map are zeros
    (``edge='zeros'``), ``edge`` itself (a tensor broadcast to a row) or
    left out (``edge='none'``).  Returns the extended tensor and the
    number of rows it has above the band."""
    b = _BANDS[0]
    axis %= x.dim()
    band = x.shape[axis]
    ea, eb = min(above, band), min(below, band)
    if not ea and not eb:
        return x, 0
    mine = torch.cat([x.narrow(axis, band - ea, ea),
                      x.narrow(axis, 0, eb)], axis).contiguous()
    parts = [torch.empty_like(mine) for _ in range(b.size)]
    dist.all_gather(parts, mine, group=b.group)
    r0 = b.rank * band
    shape = list(x.shape)
    shape[axis] = 1

    def row(g: int) -> torch.Tensor | None:
        q, i = divmod(g, band)
        if not 0 <= q < b.size:
            if isinstance(edge, str):
                return None if edge == "none" else x.new_zeros(shape)
            return edge.to(x.dtype).expand(shape)
        if g < r0:     # the bottom rows of a rank above
            return parts[q].narrow(axis, i - (band - ea), 1)
        return parts[q].narrow(axis, ea + i, 1)

    top = [t for t in (row(g) for g in range(r0 - above, r0))
           if t is not None]
    bottom = [t for t in (row(g) for g in range(r0 + band,
                                                r0 + band + below))
              if t is not None]
    return torch.cat(top + [x] + bottom, axis), len(top)
