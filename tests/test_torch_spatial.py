"""Row-sharded (spatial) inference of the port
(``spike2former_tpu_torch/parallel/spatial.py``) against the JAX
package's unsharded ``predict_logits``, the function its
``spatial_sharding`` tests hold the sharded run to
(``tests/test_multichip.py:45-77``, within 2e-5).

Gloo CPU ranks of ``tests/torch_parallel_worker.py`` each take a band of
the image's rows inside ``spatial_sharding()`` and gather the logits'
bands: 2 ranks at 64x64, 4 ranks at 64x64 (1-row bands at /16, under the
DCN's 5x5 depthwise conv, whose halo comes from two ranks away) and at
128x128, in both ``compat`` modes, at the tiny dims.  Beside them: the
plain ``dcnv3_core`` on a row range against that slice of the whole map's
output (exactly), K1's tile plan for a row band, and the modules that
refuse the regime.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from spike2former_tpu.models import Spike2Former as JaxSpike2Former
from spike2former_tpu_torch import parallel
from spike2former_tpu_torch.models.segmentor import Spike2Former
from spike2former_tpu_torch.ops import dcnv3
from spike2former_tpu_torch.ops.dcnv3 import dcnv3_core, tile_plan
from spike2former_tpu_torch.parallel import spatial

from torch_port_helpers import TINY, images, make_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_parallel_worker.py")
TIMEOUT = 300   # seconds, for each rank
TOL = 2e-5      # JAX's own bound for the sharded forward
SHAPES = {2: (64,), 4: (64, 128)}   # ranks -> image sizes


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def launch(cases: list, nproc: int, tmp) -> list[subprocess.Popen]:
    """Start ``nproc`` gloo ranks of the worker on ``cases``; their
    results go to ``tmp/rank{i}.pt``."""
    spec = tmp / "spec.pt"
    torch.save(cases, spec)
    coord = f"localhost:{parallel.free_port()}"
    return [subprocess.Popen(
        [sys.executable, WORKER, str(spec), coord, str(i), str(nproc),
         str(tmp / f"rank{i}.pt")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, env=_env(), text=True)
        for i in range(nproc)]


def collect(procs, tmp) -> list:
    """Each rank's results, once every rank has exited 0."""
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            p.kill()
            outs.append(p.communicate()[0])
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {i} failed:\n{out[-3000:]}"
    return [torch.load(tmp / f"rank{i}.pt", weights_only=False)
            for i in range(len(procs))]


def _jax_logits(jm, variables, x):
    fn = jax.jit(lambda v, im: jm.apply(
        v, im, method=JaxSpike2Former.predict_logits))
    return np.asarray(fn(variables, x))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{(ranks, hw, compat): (JAX's logits, each rank's gathered logits,
    each rank's band height)}."""
    pairs = {c: make_pair(cfg=TINY, compat=c, seed=5) for c in (False, True)}
    keys, procs = {}, {}
    for nproc, sizes in SHAPES.items():
        cases = []
        for hw in sizes:
            for compat in (False, True):
                _, _, pm = pairs[compat]
                keys[nproc, hw, compat] = len(cases)
                cases.append(dict(
                    kind="spatial", model=dict(TINY, compat=compat),
                    state_dict=pm.state_dict(),
                    images=images((hw, hw), b=1, seed=hw)))
        tmp = tmp_path_factory.mktemp(f"spatial{nproc}")
        procs[nproc] = (launch(cases, nproc, tmp), tmp)
    want = {}
    for hw in SHAPES[4]:
        for compat in (False, True):
            jm, variables, _ = pairs[compat]
            want[hw, compat] = _jax_logits(jm, variables,
                                           images((hw, hw), b=1, seed=hw))
    out = {}
    for nproc, (ps, tmp) in procs.items():
        ranks = collect(ps, tmp)
        for (n, hw, compat), i in keys.items():
            if n == nproc:
                out[n, hw, compat] = (want[hw, compat],
                                      [r[i]["logits"] for r in ranks],
                                      [r[i]["band_rows"] for r in ranks])
    return out


CASES = [(n, hw, c) for n, sizes in SHAPES.items() for hw in sizes
         for c in (False, True)]


@pytest.mark.parametrize("nproc, hw, compat", CASES)
def test_spatial_predict_logits_matches_jax(runs, nproc, hw, compat):
    want, got, bands = runs[nproc, hw, compat]
    assert bands == [hw // nproc] * nproc    # each rank held its band
    for g in got:
        assert g.shape == want.shape
        np.testing.assert_allclose(g.numpy(), want, atol=TOL, rtol=TOL)
    for g in got[1:]:
        assert torch.equal(g, got[0])


@pytest.mark.parametrize("row0, rows", [(0, 4), (4, 4), (3, 2), (7, 1)])
def test_dcnv3_core_on_a_row_range_is_that_slice_of_the_whole_map(row0,
                                                                  rows):
    g, cg, p, h, w = 4, 8, 9, 8, 6
    gen = torch.Generator().manual_seed(row0 * 10 + rows)
    x = torch.randn(2, h, w, g * cg, generator=gen)
    offset = torch.randn(2, h, w, g * p * 2, generator=gen) * 3.0
    mask = torch.rand(2, h, w, g * p, generator=gen)
    whole = dcnv3_core(x, offset, mask, group=g, group_channels=cg)
    part = dcnv3_core(x, offset[:, row0:row0 + rows],
                      mask[:, row0:row0 + rows], group=g, group_channels=cg,
                      row0=row0)
    assert torch.equal(part, whole[:, row0:row0 + rows])
    with pytest.raises(ValueError):
        dcnv3_core(x, offset[:, :rows], mask[:, :rows], group=g,
                   group_channels=cg, row0=h - rows + 1)


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("cg", [8, 16])
def test_k1_plan_for_a_row_band_stages_the_rows_its_pixels_sit_on(ranks,
                                                                  cg):
    """The Cityscapes /16 map (64x128, G=32) does not fit a block whole
    at Cg >= 8, so K1 bands it.  For each rank's band of output rows, the
    rows each block stages (``staged_rows``, the arithmetic of the
    kernel's ``block_tile``) hold the rows its pixels sit on with the
    plan's halo, and no plan stages more rows than fit."""
    n, h, w, g = 1, 64, 128, 32
    out_rows = h // ranks
    howo = out_rows * w
    plan = tile_plan(n, h, w, howo, g, cg, 9, backward=False,
                     out_rows=out_rows)
    assert 0 < plan.rows < h and plan.bands > 0
    assert plan.smem_bytes(w, cg, 9, False) <= dcnv3.FWD_SMEM_BYTES
    ob = -(-howo // plan.bands)
    for rank in range(ranks):
        row0 = rank * out_rows
        for band in range(plan.bands):
            lo, hi = band * ob, min(howo, (band + 1) * ob)
            if lo >= hi:
                continue
            need_lo = max(0, row0 + lo // w - plan.halo)
            need_hi = min(h, row0 + (hi - 1) // w + plan.halo + 2)
            y_lo, y_hi = dcnv3.staged_rows(plan, h, howo, band, row0,
                                           out_rows)
            assert y_lo <= need_lo and need_hi <= y_hi, (rank, band)
            assert y_hi - y_lo <= plan.rows
    # the whole-map plan puts a band's pixels on other rows than a
    # shard's: for the last rank's first band it would stage rows its
    # pixels never sample
    whole = tile_plan(n, h, w, howo, g, cg, 9, backward=False)
    assert dcnv3.staged_rows(whole, h, howo, 0)[1] <= h - out_rows


def test_a_height_that_does_not_split_at_16_names_the_shape():
    mesh = parallel.Mesh(data_rank=0, data_size=2)
    with parallel.spatial_sharding(mesh):
        band = parallel.shard_rows(torch.zeros(1, 64, 48, 3))
        assert band.shape == (1, 32, 48, 3)
        with pytest.raises(ValueError, match=r"\(1, 48, 64, 3\)"):
            parallel.shard_rows(torch.zeros(1, 48, 64, 3))
    assert spatial.bands() is None
    x = torch.zeros(1, 48, 64, 3)
    assert parallel.shard_rows(x) is x        # outside: the whole map


def test_modules_without_a_sharded_form_refuse():
    """Every model the presets build runs in row bands
    (``test_torch_spatial_families.py``); the library modules that mix
    the tokens of a map without a sharded form, and slide inference,
    raise inside the block and run outside it."""
    from spike2former_tpu_torch.engine.inference import slide_logits
    from spike2former_tpu_torch.models.attention import (
        LinearSpikeMHA, PEMCrossAttention, SpikeMultiheadAttention)
    from spike2former_tpu_torch.models.cyclemlp import CycleMLP
    from spike2former_tpu_torch.models.spikeformer_lib import (
        QueryProposal, SpikeformerCrossAttention, SpikeformerSelfAttention)
    mesh = parallel.Mesh(data_rank=0, data_size=2)
    tok = torch.zeros(1, 1, 8, 16)
    fmap = torch.zeros(1, 4, 4, 16)
    calls = {
        "LinearSpikeMHA": (LinearSpikeMHA(16, 4), lambda m: m(tok, tok, tok)),
        "PEMCrossAttention": (PEMCrossAttention(16, 4),
                              lambda m: m(tok[0], fmap)),
        "SpikeMultiheadAttention": (SpikeMultiheadAttention(16, 4, "CA"),
                                    lambda m: m(tok, tok, tok)),
        "SpikeformerSelfAttention": (SpikeformerSelfAttention(16, 4),
                                     lambda m: m(tok)),
        "SpikeformerCrossAttention": (SpikeformerCrossAttention(16, 4),
                                      lambda m: m(tok, tok)),
        "QueryProposal": (QueryProposal(16, 4, 5),
                          lambda m: m(fmap, fmap)),
        "CycleMLP": (CycleMLP(16), lambda m: m(fmap)),
        "slide inference": (Spike2Former(**TINY), lambda m: slide_logits(
            m, torch.zeros(1, 64, 64, 3, dtype=torch.uint8), (32, 32),
            (32, 32), TINY["num_classes"])),
    }
    for name, (model, call) in calls.items():
        model.eval()
        with torch.no_grad(), parallel.spatial_sharding(mesh):
            with pytest.raises(ValueError, match=f"{name} does not run "
                               "under spatial sharding"):
                call(model)
        if name != "slide inference":
            with torch.no_grad():
                call(model)                  # outside the block it runs
