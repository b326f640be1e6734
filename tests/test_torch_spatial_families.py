"""Row-sharded (spatial) inference of every model family the presets
build, and of the library pixel decoders, against the JAX package's
unsharded functions, which its ``spatial_sharding`` holds the sharded run
to (``tests/test_multichip.py:45-77``, within 2e-5).

Gloo CPU ranks of ``tests/torch_parallel_worker.py`` each take a band of
the image's rows inside ``parallel.spatial_sharding()`` (cut at the
model's ``band_stride``) and gather what they give; every case of a rank
count runs in one set of processes.  At the tiny dims, float32:

* bucketed eval (``valid_hw``) at 2 ranks of 64x64 (the lower band part
  padding) and 4 ranks of 128x128 (the lower two bands all padding);
* the SDTv3 and SDTv3-MAE backbones at 2 ranks of 64x64 and 4 of 128x128
  (the MAE's H/2 stripes: one band each at 2 ranks, two bands each at 4);
* the Mask2Former mode and the DAB-DETR decoder at 2 ranks, whose ranks'
  final queries (DAB: and anchors) are bitwise equal, and the Mask2Former
  gate alone on a query that masks every key of one band only;
* each in both ``compat`` modes, all held to JAX's ``predict_logits``;
* the panoptic merge on the confident tiny model of
  ``test_torch_panoptic.py``, ``sem``/``inst`` equal to JAX's
  ``whole_panoptic``;
* the FPN family on its tiny overrides: ``fpn_sdtv3`` and the cascade at
  2 ranks of 64x64, MS-ResNet-18 at 4 ranks of 128x128 (one /32 row a
  band);
* the Transformer-encoder and FPN pixel decoders as modules at 2 ranks,
  held to JAX's modules output by output, and the deformable encoder on
  two levels' bands.

Beside them, on one process: ``shard_rows`` at stride 32, a band's
bilinear downscale against the whole map's rows, and the CSWin
attention's stripes in three bands (one straddling two stripes).
"""
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from spike2former_tpu.models import Spike2Former as JaxSpike2Former
from spike2former_tpu.models import deformable as jax_deformable
from spike2former_tpu.models import sdtv2 as jax_sdtv2
from spike2former_tpu.models.maskformer_head import \
    mask2former_attn_mask as jax_m2f_mask
from spike2former_tpu_torch import parallel
from spike2former_tpu_torch.engine.convert import from_jax_variables
from spike2former_tpu_torch.models.deformable import SpikeDeformableEncoder
from spike2former_tpu_torch.models.sdtv2 import CSWinSpikeAttention
from spike2former_tpu_torch.ops.resize import (resize_bilinear,
                                               resize_bilinear_hw)

from test_torch_fpn import TINY_FPN
from test_torch_fpn import _pair as fpn_pair
from test_torch_panoptic import CFG as PAN_CFG
from test_torch_panoptic import NUM_THINGS, _confident_pair, jax_whole
from test_torch_pixel_decoders import IN_CHANNELS
from test_torch_pixel_decoders import _feats as decoder_feats
from test_torch_pixel_decoders import _pair as decoder_pair
from test_torch_spatial import TOL, collect, launch
from torch_port_helpers import (TINY, images, load_port, make_pair,
                                randomize_variables, spikes)

M2F = dict(TINY, masked_attention=True, num_decoder_layers=2)
DAB = dict(TINY, decoder="dab", num_decoder_layers=2)
# (preset, overrides, ranks, image side) of the FPN family
FPN_CASES = {
    "fpn_sdtv3": ("fpn_sdtv3_512x512_10M_ade20k", ["model.T=2"], 2, 64),
    "msresnet18": ("fpn_msresnet18_512x512_ade20k", [], 4, 128),
    "cascade": ("cascade_fpn_sdtv2_512x512_ade20k", ["model.T=2"], 2, 64),
}
DECODERS = {"transformer": ("pixel_decoder.TransformerEncoderPixelDecoder", dict(
                in_channels=IN_CHANNELS, feat_channels=32, out_channels=32,
                num_encoder_layers=1, feedforward_channels=64,
                num_heads=4)),
            "fpn": ("pixel_decoder.FPNPixelDecoder", dict(
                in_channels=IN_CHANNELS, feat_channels=32,
                out_channels=32))}
VALID_HW = {2: (64, (40, 52)), 4: (128, (60, 100))}   # ranks -> side, valid
V3_SIDES = {2: 64, 4: 128}
DEFORM_SHAPES = ((8, 6), (4, 4))        # two levels, /8 and /16 of 64x48
V3_WAKE = {"sdtv3": (1.0, 0.5), "sdtv3mae": (2.0, 0.5)}   # backbone's


# Random weights leave these tiny models' attention silent: the spikes
# after each attention's sum are all 0 (or all at one level), so a wrong
# sum over the bands would not reach the logits.  ``waken`` raises the
# BN biases (and narrows the scales) of the q, k and v projections of
# every attention whose sums the bands share, which sets those spikes
# firing at several levels.
WAKE = {
    "head": re.compile(r"((cross_attn|encoder_attn_\d+)/[qkv]/BatchNorm_0"
                       r"/BatchNorm_0|cross_attn/(qcontent|kcontent|v)_proj)"
                       r"/(bias|scale)$"),
    "backbone": re.compile(r"([qkv]_conv/BatchNorm_0(/BatchNorm_0)?"
                           r"|[qkv]_bn/BatchNorm_0)/(bias|scale)$"),
}


def waken(variables, pm, head=(4.0, 1.0), backbone=(2.0, 0.5)):
    """``variables`` with the ``WAKE`` leaves' biases raised by ``delta``
    and scales times ``scale`` of (``delta``, ``scale``) = ``head`` or
    ``backbone``, loaded into ``pm`` too."""
    def f(path, x):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        for (delta, scale), pat in ((head, WAKE["head"]),
                                    (backbone, WAKE["backbone"])):
            if pat.search(name):
                return x + delta if name.endswith("bias") else x * scale
        return x

    variables = jax.tree_util.tree_map_with_path(f, variables)
    pm.load_state_dict(from_jax_variables(variables), strict=True)
    return variables


def _jax_predict(jm, variables, x, valid_hw=None):
    fn = jax.jit(lambda v, im, vhw: jm.apply(
        v, im, vhw, method=JaxSpike2Former.predict_logits))
    vhw = None if valid_hw is None else jnp.asarray(valid_hw)
    return np.asarray(fn(variables, jnp.asarray(x), vhw))


def _segmentor_cases():
    """{name: (ranks, worker case, JAX's logits thunk)} of the MaskFormer
    families."""
    cases = {}
    for compat in (False, True):
        c = "compat" if compat else "plain"
        for n, (side, valid) in VALID_HW.items():
            jm, v, pm = make_pair(TINY, compat=compat, seed=30 + n)
            v = waken(v, pm)
            x = images((side, side), b=1, seed=side + 1)
            vhw = np.array([valid], np.int64)
            cases[f"valid_hw_{n}_{c}"] = (n, dict(
                kind="spatial", model=dict(TINY, compat=compat),
                state_dict=pm.state_dict(), images=x, valid_hw=vhw),
                lambda jm=jm, v=v, x=x, vhw=vhw: _jax_predict(jm, v, x, vhw))
        for variant in ("sdtv3", "sdtv3mae"):
            cfg = dict(TINY, variant=variant)
            jm, v, pm = make_pair(cfg, compat=compat, seed=40)
            v = waken(v, pm, head=(3.0, 1.0), backbone=V3_WAKE[variant])
            for n, side in V3_SIDES.items():
                x = images((side, side), b=1, seed=side + 2)
                cases[f"{variant}_{n}_{c}"] = (n, dict(
                    kind="spatial", model=dict(cfg, compat=compat),
                    state_dict=pm.state_dict(), images=x),
                    lambda jm=jm, v=v, x=x: _jax_predict(jm, v, x))
        for name, cfg, hook in (("m2f", M2F, "head.decoder_1"),
                                ("dab", DAB, "head.dab_decoder")):
            jm, v, pm = make_pair(cfg, compat=compat, seed=50)
            v = waken(v, pm)
            x = images((64, 64), b=1, seed=51)
            cases[f"{name}_2_{c}"] = (2, dict(
                kind="spatial", model=dict(cfg, compat=compat),
                state_dict=pm.state_dict(), images=x, hook=hook),
                lambda jm=jm, v=v, x=x: _jax_predict(jm, v, x))
    return cases


def _other_cases():
    """The panoptic, FPN-family and pixel-decoder cases, as
    ``_segmentor_cases``."""
    cases = {}
    for compat in (False, True):
        jm, v, pm = _confident_pair(compat)   # its maps hold a thing
        x = np.random.default_rng(60).integers(0, 256, (1, 64, 96, 3),
                                               dtype=np.uint8)
        cases[f"panoptic_{'compat' if compat else 'plain'}"] = (2, dict(
            kind="spatial_panoptic",
            model=dict(PAN_CFG, num_decoder_layers=2, compat=compat),
            state_dict=pm.state_dict(), images=x, num_things=NUM_THINGS,
            object_mask_thr=0.5), lambda jm=jm, v=v, x=x: tuple(
                np.asarray(a) for a in jax_whole(
                    jm, v, jnp.asarray(x.astype(np.float32)),
                    num_things=NUM_THINGS, object_mask_thr=0.5)))
    for name, (preset, opts, n, side) in FPN_CASES.items():
        jm, v, pm = fpn_pair(preset, opts, seed=61)
        v = waken(v, pm, backbone=V3_WAKE.get(name[4:], (2.0, 0.5)))
        x = images((side, side), b=1, seed=62)
        cases[name] = (n, dict(
            kind="spatial", preset=preset, overrides=TINY_FPN + opts,
            state_dict=pm.state_dict(), images=x),
            lambda jm=jm, v=v, x=x: np.asarray(jax.jit(
                lambda vv, im: jm.apply(vv, im, method=jm.predict_logits))(
                    v, jnp.asarray(x))))
    for name, module in DECODERS.items():
        jm, pm = decoder_pair(name if name == "fpn" else "transformer")
        feats = decoder_feats(63)
        v = waken(load_port(jm, pm, feats, seed=64), pm)
        cases[f"decoder_{name}"] = (2, dict(
            kind="spatial_module", module=module, state_dict=pm.state_dict(),
            inputs=feats), lambda jm=jm, v=v, feats=feats: [
                np.asarray(y) for y in jax.tree_util.tree_leaves(jax.jit(
                    jm.apply)(v, [jnp.asarray(f) for f in feats]))])
    # the deformable encoder over two levels in two bands (queries of
    # each level's band, every level's values gathered)
    levels = [np.random.default_rng(68 + i).normal(
        0.5, 1.0, (1, 2, h, w, 16)).astype(np.float32)
        for i, (h, w) in enumerate(DEFORM_SHAPES)]
    pos = [np.random.default_rng(70 + i).normal(
        0.0, 1.0, lvl.shape).astype(np.float32)
        for i, lvl in enumerate(levels)]
    kw = dict(num_layers=2, embed_dims=16, num_heads=4, num_points=3,
              feedforward_channels=32)
    jm = jax_deformable.SpikeDeformableEncoder(**kw)
    pm = SpikeDeformableEncoder(**kw, num_levels=len(DEFORM_SHAPES))

    def flat(maps):
        return np.concatenate([m.reshape(1, 2, -1, 16) for m in maps], 2)

    v = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.asarray(flat(levels)), DEFORM_SHAPES,
        jnp.asarray(flat(pos))))
    v = randomize_variables(v, 72)
    pm.load_state_dict(from_jax_variables(v), strict=True)

    def deform_ref(jm=jm, v=v):
        out = np.asarray(jax.jit(lambda vv, x, p: jm.apply(
            vv, x, DEFORM_SHAPES, p))(v, flat(levels), flat(pos)))
        sizes = np.cumsum([h * w for h, w in DEFORM_SHAPES])[:-1]
        return [o.reshape(1, 2, h, w, 16) for o, (h, w) in zip(
            np.split(out, sizes, 2), DEFORM_SHAPES)]

    cases["deformable"] = (2, dict(
        kind="spatial_tokens", module=("deformable.SpikeDeformableEncoder",
                                       dict(kw, num_levels=2)),
        state_dict=pm.eval().state_dict(), inputs=levels, pos=pos),
        deform_ref)
    # Mask2Former's gating at 2 ranks: query 0's logits are negative on
    # every key but some of the lower band's (it keeps its mask there),
    # query 1's everywhere (it is unmasked whole), query 2's random
    rng = np.random.default_rng(67)
    mask_pred = rng.normal(0.0, 1.0, (1, 3, 16, 8)).astype(np.float32)
    mask_pred[0, :2] = -1.0 - np.abs(mask_pred[0, :2])
    mask_pred[0, 0, 12:, 4:] = 2.0
    cases["attn_mask"] = (2, dict(kind="attn_mask", mask_pred=mask_pred,
                                  hw=(4, 4)),
                          lambda: np.asarray(jax_m2f_mask(
                              jnp.asarray(mask_pred), (4, 4))).reshape(
                                  1, 1, 3, 4, 4))
    # CSWin attention in three bands of a 12-row map: the middle band
    # straddles the two H/2 stripes
    x = spikes((1, 1, 12, 8, 16), 65) * 4.0 - 1.0
    for last in (False, True):
        jm = jax_sdtv2.CSWinSpikeAttention(16, 4, last_stage=last)
        pm = CSWinSpikeAttention(16, 4, last_stage=last)
        v = waken(load_port(jm, pm, x, seed=66), pm,
                  backbone=(1.5 if last else 2.5, 0.3))
        cases[f"cswin{'_last' if last else ''}_3"] = (3, dict(
            kind="spatial_module", module=(
                "sdtv2.CSWinSpikeAttention", dict(
                    dim=16, num_heads=4, last_stage=last)),
            state_dict=pm.state_dict(), inputs=x),
            lambda jm=jm, v=v: [np.asarray(jax.jit(jm.apply)(
                v, jnp.asarray(x)))])
    return cases


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case: (JAX's result, each rank's result)}."""
    cases = {**_segmentor_cases(), **_other_cases()}
    procs, index = {}, {}
    for nproc in sorted({n for n, _, _ in cases.values()}):
        names = [k for k, (n, _, _) in cases.items() if n == nproc]
        index[nproc] = names
        tmp = tmp_path_factory.mktemp(f"families{nproc}")
        procs[nproc] = (launch([cases[k][1] for k in names], nproc, tmp),
                        tmp)
    want = {k: ref() for k, (_, _, ref) in cases.items()}
    out = {}
    for nproc, (ps, tmp) in procs.items():
        ranks = collect(ps, tmp)
        for i, k in enumerate(index[nproc]):
            out[k] = (want[k], [r[i] for r in ranks])
    return out


def _hold_logits(runs, name):
    want, ranks = runs[name]
    for r in ranks:
        assert r["logits"].shape == want.shape
        np.testing.assert_allclose(r["logits"].numpy(), want, atol=TOL,
                                   rtol=TOL)
    for r in ranks[1:]:
        assert torch.equal(r["logits"], ranks[0]["logits"])
    assert np.ptp(want) > 0.01
    return ranks


COMPAT = ["plain", "compat"]


@pytest.mark.parametrize("c", COMPAT)
@pytest.mark.parametrize("nproc", [2, 4])
def test_bucketed_eval_with_valid_hw_matches_jax(runs, nproc, c):
    ranks = _hold_logits(runs, f"valid_hw_{nproc}_{c}")
    side = VALID_HW[nproc][0]
    assert [r["band_rows"] for r in ranks] == [side // nproc] * nproc


@pytest.mark.parametrize("c", COMPAT)
@pytest.mark.parametrize("nproc", [2, 4])
@pytest.mark.parametrize("variant", ["sdtv3", "sdtv3mae"])
def test_sdtv3_backbones_match_jax(runs, variant, nproc, c):
    _hold_logits(runs, f"{variant}_{nproc}_{c}")


@pytest.mark.parametrize("c", COMPAT)
@pytest.mark.parametrize("name", ["m2f", "dab"])
def test_mask2former_and_dab_match_jax_with_equal_queries(runs, name, c):
    ranks = _hold_logits(runs, f"{name}_2_{c}")
    hooked = [jax.tree_util.tree_leaves(r["hooked"]) for r in ranks]
    assert hooked[0]
    for h in hooked[1:]:
        assert all(torch.equal(a, b) for a, b in zip(h, hooked[0]))


def test_mask2former_gate_decides_over_every_bands_keys(runs):
    want, ranks = runs["attn_mask"]
    for r in ranks:
        np.testing.assert_array_equal(r["mask"].numpy(), want)
    q0 = want[0, 0, 0]
    assert q0[:2].all() and not q0.all()     # band 0 all masked, kept
    assert not want[0, 0, 1].any()           # masks every key: open


@pytest.mark.parametrize("c", COMPAT)
def test_panoptic_merge_in_bands_equals_jax(runs, c):
    want, ranks = runs[f"panoptic_{c}"]
    for r in ranks:
        for got, w in zip((r["sem"], r["inst"]), want):
            np.testing.assert_array_equal(got.numpy(), w)
    sem, inst = want
    assert (sem >= 0).any()
    if c == "plain":                  # a thing instance beside the stuff
        assert (inst > 0).any() and (sem >= NUM_THINGS).any()


@pytest.mark.parametrize("name", sorted(FPN_CASES))
def test_fpn_family_matches_jax(runs, name):
    ranks = _hold_logits(runs, name)
    _, _, n, side = FPN_CASES[name]
    assert [r["band_rows"] for r in ranks] == [side // n] * n


def _hold_outputs(runs, name):
    want, ranks = runs[name]
    for r in ranks:
        assert len(r["outputs"]) == len(want)
        for g, w in zip(r["outputs"], want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g.numpy(), w, atol=TOL, rtol=TOL)
    for r in ranks[1:]:
        assert all(torch.equal(a, b) for a, b in zip(r["outputs"],
                                                       ranks[0]["outputs"]))
    return ranks


@pytest.mark.parametrize("name", sorted(DECODERS))
def test_library_pixel_decoders_match_jax(runs, name):
    ranks = _hold_outputs(runs, f"decoder_{name}")
    assert len(ranks[0]["outputs"]) == 5
    if name == "fpn":     # the mask head's pad rows: one a band of two
        assert [r["band_rows"][0] for r in ranks] == [9, 9]


def test_deformable_encoder_in_bands_matches_jax(runs):
    ranks = _hold_outputs(runs, "deformable")
    want = runs["deformable"][0]
    assert np.abs(want[0] - np.random.default_rng(68).normal(
        0.5, 1.0, want[0].shape)).max() > 0.1       # the layers show


@pytest.mark.parametrize("last", [False, True])
def test_cswin_stripes_across_three_bands_match_jax(runs, last):
    ranks = _hold_outputs(runs, f"cswin{'_last' if last else ''}_3")
    assert [r["band_rows"][0] for r in ranks] == [4, 4, 4]


def test_shard_rows_at_stride_32_names_the_shape():
    mesh = parallel.Mesh(data_rank=1, data_size=4)
    with parallel.spatial_sharding(mesh):
        band = parallel.shard_rows(torch.zeros(1, 128, 64, 3), stride=32)
        assert band.shape == (1, 32, 64, 3)
        with pytest.raises(ValueError, match=r"\(1, 64, 64, 3\).*/32"):
            parallel.shard_rows(torch.zeros(1, 64, 64, 3), stride=32)
        # the MetaFormer families' default unit, /16, splits it
        assert parallel.shard_rows(torch.zeros(1, 64, 64, 3)).shape[1] == 16


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("factor", [2, 3, 8])
def test_band_downscale_is_the_whole_maps_rows(factor, dtype):
    """Mask2Former's masks at /2 sized down to an attention level: each
    band's downscale gives the whole map's rows, bit for bit, in both
    resizes and layouts."""
    size, band = 4, 2 * factor
    gen = torch.Generator().manual_seed(factor)
    x = torch.randn(2, 3, size * band, 20, generator=gen).to(dtype)
    out_hw = (size * band // factor, 9)
    whole = resize_bilinear_hw(x, out_hw)
    whole_c = resize_bilinear(x.movedim(1, -1), out_hw)
    ob = band // factor
    for rank in range(size):
        sl = slice(rank * band, (rank + 1) * band)
        with parallel.spatial_sharding(parallel.Mesh(data_rank=rank,
                                                     data_size=size)):
            got = resize_bilinear_hw(x[:, :, sl], (ob, 9))
            got_c = resize_bilinear(x[:, :, sl].movedim(1, -1), (ob, 9))
        rows = slice(rank * ob, (rank + 1) * ob)
        assert torch.equal(got, whole[:, :, rows])
        assert torch.equal(got_c, whole_c[:, rows])
    with parallel.spatial_sharding(parallel.Mesh(data_rank=0, data_size=2)):
        with pytest.raises(ValueError, match="integer factors"):
            resize_bilinear_hw(x[:, :, :5], (2, 9))
