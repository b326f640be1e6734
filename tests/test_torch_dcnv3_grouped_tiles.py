"""The tile plan of the port's grouped-layout DCNv3 kernels
(``ops/dcnv3_grouped.py:grouped_tile_plan``): what one block of the
grouped forward or backward owns and stages in shared memory.  Plain
Python, so it runs here; the kernels that take the plans are held to
their plain versions and to K1/K2 on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` (grouped))."""
import math

import pytest

from spike2former_tpu_torch.ops import dcnv3
from spike2former_tpu_torch.ops.dcnv3_grouped import (GROUPED_SMEM_BYTES,
                                                      GroupedPlan,
                                                      _grouped_threads,
                                                      grouped_tile_plan)

G, CG = 32, 8
SERVE = (1, 32, 44)      # flagship /16 map of a 512x683 request
TRAIN = (6, 32, 32)      # batch 6 of 512x512 crops
LARGE = (1, 128, 128)    # 2 MB a group at Cg=32
WIDE = (1, 8, 2048)      # too wide for three staged rows at most Cg
CHANNELS = [1, 2, 4, 8, 16, 32]
# shared floats a staged pixel takes, as the kernels allocate them: the
# forward's pixel stride padded to an odd number of 16-byte quads
# (dcnv3::tile_stride), the backward's Cg channels and the accumulator of
# the first min(Cg, 4) (dcnv3::kShared)
FWD_FLOATS = {1: 1, 2: 2, 4: 4, 8: 12, 16: 20, 32: 36}
BWD_FLOATS = {1: 2, 2: 4, 4: 8, 8: 12, 16: 20, 32: 36}


def _band_extents(h, howo, bands, halo):
    """The rows each band of ``block_tile`` wants staged: its output
    pixels' rows (pixel o on row o*H // HoWo), ``halo`` above and
    ``halo + 1`` below, clipped to the map."""
    ob = -(-howo // bands)
    for lo in range(0, howo, ob):
        rows = [o * h // howo for o in range(lo, min(howo, lo + ob))]
        yield max(0, min(rows) - halo), min(h, max(rows) + halo + 2)


@pytest.mark.parametrize("shape, fwd, bwd", [
    # serve: 32 (image, group) pairs, 4 bands so that every SM works; the
    # backward one column a thread of 256
    (SERVE, GroupedPlan(4, 32, 0), GroupedPlan(6, 32, 0)),
    # train: 192 pairs; bands of 512 and 256 columns
    (TRAIN, GroupedPlan(2, 32, 0), GroupedPlan(4, 32, 0)),
])
def test_flagship_shapes_stage_a_groups_whole_map(shape, fwd, bwd):
    n, h, w = shape
    for backward, plan in ((False, fwd), (True, bwd)):
        got = grouped_tile_plan(n, h, w, h * w, G, CG, backward=backward)
        assert got == plan
        assert not got.whole(h)          # bands: dfeat is zero-filled
        assert got.bands * _grouped_threads(CG, backward) >= h * w
        assert got.smem_bytes(w, CG, backward) <= GROUPED_SMEM_BYTES
    # 32x32 at Cg=8: 48 KB a group either way
    assert (grouped_tile_plan(*TRAIN, 1024, G, CG, backward=True)
            .smem_bytes(32, CG, True) == 48 * 1024)


def test_a_small_map_is_one_backward_band_that_owns_it():
    plan = grouped_tile_plan(2, 9, 13, 117, 4, CG, backward=True)
    assert plan == GroupedPlan(1, 9, 0)
    assert plan.whole(9)                 # plain stores, no zero-fill
    # the forward takes more bands: 8 pairs on 132 SMs
    assert not grouped_tile_plan(2, 9, 13, 117, 4, CG,
                                 backward=False).whole(9)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("cg", CHANNELS)
@pytest.mark.parametrize("shape", [LARGE, WIDE], ids=["128x128", "8x2048"])
def test_plans_fit_and_cover_their_bands_or_stage_nothing(shape, cg,
                                                          backward):
    """Every plan fits the budget; a plan that stages part of the map
    covers each band's rows with its halo; one that stages nothing does so
    because not three rows fit."""
    n, h, w = shape
    plan = grouped_tile_plan(n, h, w, h * w, 4, cg, backward=backward)
    assert plan.smem_bytes(w, cg, backward) <= GROUPED_SMEM_BYTES
    assert 1 <= plan.bands <= min(h, h * w)
    assert plan.bands * _grouped_threads(cg, backward) >= h * w or (
        plan.bands == h)
    if plan.rows >= h:
        assert plan.halo == 0
        assert GroupedPlan(1, h, 0).smem_bytes(w, cg, backward) <= (
            GROUPED_SMEM_BYTES)
    elif plan.rows:
        assert not plan.whole(h) and plan.bands > 1
        for lo, hi in _band_extents(h, h * w, plan.bands, plan.halo):
            assert hi - lo <= plan.rows
    else:
        assert GroupedPlan(1, 3, 0).smem_bytes(w, cg, backward) > (
            GROUPED_SMEM_BYTES)


def test_a_2mb_group_is_staged_in_bands_with_halos():
    # 128x128 at Cg=32: 2 MB a group; 113 KB take 6 rows of the forward's
    # 36-float pixels (18 KB a row): bands of single rows, whose halo of 2
    # would want 7 rows, so a halo of 1 (5 rows)
    plan = grouped_tile_plan(*LARGE, 128 * 128, 4, 32, backward=False)
    assert plan == GroupedPlan(128, 5, 1)
    assert GroupedPlan(1, 128, 0).smem_bytes(128, 32, False) == (
        128 * 128 * 36 * 4)


def test_the_wide_map_stages_nothing_from_cg_8():
    """An 8x2048 map: 8 bands of one row; at Cg=8 a row of the forward's
    12-float pixels is 96 KB, so not three rows fit and nothing is staged
    (every tap reads, and the backward adds into, device memory)."""
    for backward in (False, True):
        plan = grouped_tile_plan(*WIDE, 8 * 2048, 4, 8, backward=backward)
        assert plan == GroupedPlan(8, 0, 0)
        assert plan.smem_bytes(2048, 8, backward) == 0
    assert grouped_tile_plan(*WIDE, 8 * 2048, 4, 1,
                             backward=False) == GroupedPlan(8, 8, 0)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("cg", CHANNELS)
def test_smem_bytes_are_what_the_kernels_allocate(cg, backward):
    floats = (BWD_FLOATS if backward else FWD_FLOATS)[cg]
    assert (GroupedPlan(3, 5, 1).smem_bytes(7, cg, backward)
            == floats * 5 * 7 * 4)
    if not backward:    # the same padding as K1's one-group tile
        assert floats == dcnv3._pixel_floats(1, cg, False)


@pytest.mark.parametrize("shape", [SERVE, TRAIN, LARGE, WIDE])
def test_forward_bands_keep_every_sm_busy(shape):
    """With fewer (image, group) pairs than SMs, the forward takes enough
    bands that the blocks cover the SMs (up to one band a map row)."""
    n, h, w = shape
    g = G if shape in (SERVE, TRAIN) else 4
    plan = grouped_tile_plan(n, h, w, h * w, g, CG, backward=False)
    want = max(math.ceil(h * w / _grouped_threads(CG, False)),
               dcnv3.NUM_SMS // (n * g))
    assert plan.bands >= min(h, want)
