"""The tile plan of the port's DCNv3 kernels (``ops/dcnv3.py:tile_plan``):
what one block of K1 or K2 owns and stages in shared memory.  Plain
Python, so it runs here; the kernels that take the plans are held to
their plain versions on the card (``tests/test_torch_cuda.py``)."""
import pytest

from spike2former_tpu_torch.ops import dcnv3
from spike2former_tpu_torch.ops.dcnv3 import TilePlan, tile_plan

G, CG, P = 32, 8, 9
COORD_BYTES = dcnv3.BWD_WARPS * 3 * 32 * P * 4   # K2: 27 KB
FWD_COORD_BYTES = dcnv3.FWD_WARPS * 3 * 32 * P * 4   # K1: 55 KB
SERVE = (1, 32, 44)      # flagship /16 map of a 512x683 request
TRAIN = (6, 32, 32)      # batch 6 of 512x512 crops
LARGE = (1, 64, 128)     # a map whose groups do not fit at Cg >= 16
WIDE = (1, 8, 2048)      # a map too wide for three staged rows at most Cg


def _budget(backward):
    return dcnv3.BWD_SMEM_BYTES if backward else dcnv3.FWD_SMEM_BYTES


@pytest.mark.parametrize("h, howo, bands, halo", [
    (32, 1024, 4, 0), (32, 1408, 6, 3), (64, 8192, 32, 3), (64, 8192, 64, 1),
    (8, 16384, 8, 1), (8, 16384, 3, 2), (9, 117, 1, 3), (5, 7, 7, 0),
])
def test_band_rows_cover_every_band(h, howo, bands, halo):
    """``_band_rows`` is at least the rows each band's output pixels sit
    on (pixel o on row o*H // HoWo), with ``halo`` rows above and
    ``halo + 1`` below, clipped to the map: the rows the kernels'
    ``block_tile`` stages for the band."""
    ob = -(-howo // bands)
    need = 0
    for lo in range(0, howo, ob):
        rows = {o * h // howo for o in range(lo, min(howo, lo + ob))}
        need = max(need, min(h, max(rows) + halo + 2)
                   - max(0, min(rows) - halo))
    got = dcnv3._band_rows(h, howo, bands, halo)
    assert need <= got <= h


@pytest.mark.parametrize("shape", [SERVE, TRAIN])
def test_backward_stages_a_groups_whole_map_at_the_flagship_shapes(shape):
    # one item a thread: 1408 and 1024 output pixels in bands of 256
    n, h, w = shape
    shared = dcnv3.SHARED_CHANNELS
    plan = tile_plan(n, h, w, h * w, G, CG, P, backward=True)
    assert plan == TilePlan(1, -(-h * w // 256), h, 0)
    assert not plan.whole(h)      # bands: dvalue is zero-filled
    assert (plan.smem_bytes(w, CG, P, backward=True)
            == (CG + shared) * h * w * 4 + COORD_BYTES)
    assert plan.smem_bytes(w, CG, P, True) <= dcnv3.BWD_SMEM_BYTES


@pytest.mark.parametrize("shape, plan", [
    (SERVE, TilePlan(1, 4, 32, 0)),   # 32 (image, group) pairs x 4 bands
    (TRAIN, TilePlan(2, 0, 32, 0)),   # 192 pairs: resident blocks
])
def test_forward_stages_whole_maps_at_the_flagship_shapes(shape, plan):
    n, h, w = shape
    assert tile_plan(n, h, w, h * w, G, CG, P, backward=False) == plan
    assert (plan.smem_bytes(w, CG, P, backward=False)
            == (plan.groups * CG + 4) * h * w * 4 + FWD_COORD_BYTES)
    assert plan.smem_bytes(w, CG, P, False) <= dcnv3.FWD_SMEM_BYTES


def test_a_small_map_is_one_band_that_owns_the_whole_map():
    plan = tile_plan(2, 9, 13, 117, 4, CG, P, backward=True)
    assert plan == TilePlan(1, 1, 9, 0)
    assert plan.whole(9)          # plain stores, no zero-fill


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("cg", [1, 2, 4, 8, 16, 32])
def test_plans_on_a_large_map_fit_and_cover_their_bands(cg, backward):
    n, h, w = LARGE
    g = 4
    plan = tile_plan(n, h, w, h * w, g, cg, P, backward=backward)
    assert plan.groups == 1
    assert plan.smem_bytes(w, cg, P, backward) <= _budget(backward)
    if TilePlan(1, 1, h, 0).smem_bytes(w, cg, P, backward) <= _budget(
            backward):
        # small Cg: the whole map (K2 still in bands of 256 items)
        assert plan.rows == h and plan.halo == 0
        assert plan.bands == (32 if backward else dcnv3.NUM_SMS // 4)
        return
    assert not plan.whole(h) and plan.bands > 1 and plan.rows < h
    if plan.rows:
        # no band's rows are cut by the clamp to plan.rows
        assert dcnv3._band_rows(h, h * w, plan.bands, plan.halo) <= plan.rows


# the wide map's plans, single-row bands: K1 stages the whole map at Cg 1
# and 2, five rows (halo 1) at Cg=4 and nothing from Cg=8 on; K2 five rows
# at Cg=1 and nothing from Cg=2 on
WIDE_PLANS = {
    (False, 1): TilePlan(1, 8, 8, 0), (False, 2): TilePlan(1, 8, 8, 0),
    (False, 4): TilePlan(1, 8, 5, 1), (False, 8): TilePlan(1, 8, 0, 0),
    (False, 16): TilePlan(1, 8, 0, 0), (False, 32): TilePlan(1, 8, 0, 0),
    (True, 1): TilePlan(1, 8, 5, 1), (True, 2): TilePlan(1, 8, 0, 0),
    (True, 4): TilePlan(1, 8, 0, 0), (True, 8): TilePlan(1, 8, 0, 0),
    (True, 16): TilePlan(1, 8, 0, 0), (True, 32): TilePlan(1, 8, 0, 0),
}


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("cg", [1, 2, 4, 8, 16, 32])
def test_plans_on_a_wide_map_fit_or_stage_nothing(cg, backward):
    """An 8x2048 map (the card tests' second large case): where not
    three rows fit, nothing is staged and every tap reads (and K2 adds
    into) device memory."""
    n, h, w = WIDE
    plan = tile_plan(n, h, w, h * w, 4, cg, P, backward=backward)
    assert plan == WIDE_PLANS[backward, cg]
    assert plan.smem_bytes(w, cg, P, backward) <= _budget(backward)
    assert not plan.whole(h)
    if 0 < plan.rows < h:
        assert dcnv3._band_rows(h, h * w, plan.bands, plan.halo) <= plan.rows
    if plan.rows == 0:
        # not even three rows fit beside the coordinate buffers
        assert (TilePlan(1, 1, 3, 0).smem_bytes(w, cg, P, backward)
                > _budget(backward))


def test_backward_on_a_wide_map_narrows_the_halo():
    # Cg=32 at W=128: 18 KB a row of value and accumulator, 5 rows fit
    # beside 4 warps' coordinate buffers: single rows with a halo of 1
    plan = tile_plan(*LARGE, 64 * 128, 4, 32, P, backward=True)
    assert plan == TilePlan(1, 64, 5, 1)


def test_backward_stages_nothing_when_not_three_rows_fit():
    plan = tile_plan(*WIDE, 8 * 2048, 4, 32, P, backward=True)
    assert plan == TilePlan(1, 8, 0, 0) and not plan.whole(8)
    # Cg=32: 4 warps a block
    assert plan.smem_bytes(2048, 32, P, backward=True) == COORD_BYTES // 2


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("cg", [1, 8, 32])
def test_pixel_floats_count_the_tile_and_accumulator(cg, backward):
    """A staged pixel's shared floats: K1's value stride padded to an odd
    number of 16-byte quads, K2's channels and its shared channels'
    accumulator."""
    want = ({1: 1, 8: 12, 32: 36}[cg] if not backward
            else cg + min(cg, dcnv3.SHARED_CHANNELS))
    assert dcnv3._pixel_floats(1, cg, backward) == want
    assert (TilePlan(1, 1, 2, 0).smem_bytes(10, cg, P, backward)
            == (2 * 10 * want + dcnv3._coord_floats(cg, P, backward)) * 4)
