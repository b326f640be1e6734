"""The port's ANN->SNN converter, Lava exchange, biomedical 3-D and extra
2-D transforms, native image runtime and loose public names against the
JAX package's, on the same seeded inputs.

Tolerances:
* ``AnnSequential`` (ANN, calibration statistics, SNN at T=8 and 32) on
  the same weights: 1e-5 absolute plus 1e-5 relative in float32;
  ``quantile`` against ``jnp.quantile``: 1e-6 relative;
* the Lava quantizers and the HDF5 file: equal values, entry by entry;
* transforms and the runtime: bit-equal arrays for the same
  ``np.random.Generator`` seed or the same input;
* the matching costs, the align-corners resize and ``spike_rate``:
  1e-5 absolute plus 1e-5 relative; ``update_iou``: exact;
  ``load_reference_backbone``: exact.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from PIL import Image

from spike2former_tpu import ann2snn as jann
from spike2former_tpu import lava_exchange as jlava
from spike2former_tpu import runtime as jrt
from spike2former_tpu.data import biomedical as jbio
from spike2former_tpu.data import transforms as jtr
from spike2former_tpu_torch import ann2snn as tann
from spike2former_tpu_torch import lava_exchange as tlava
from spike2former_tpu_torch import runtime as trt
from spike2former_tpu_torch.data import biomedical as tbio
from spike2former_tpu_torch.data import transforms as ttr
from spike2former_tpu_torch.engine.convert import from_jax_variables

from torch_port_helpers import randomize_variables

TOL = dict(atol=1e-5, rtol=1e-5)


# --- ann2snn.py ---

def _anns():
    jax_layers = (fnn.Conv(8, (3, 3), padding="SAME"), "relu",
                  fnn.Conv(8, (3, 3), strides=(2, 2),
                           padding=((1, 1), (1, 1))),
                  "relu", lambda x: x.reshape(x.shape[0], -1),
                  fnn.Dense(10))
    torch_layers = (torch.nn.Conv2d(3, 8, 3, padding=1), "relu",
                    torch.nn.Conv2d(8, 8, 3, stride=2, padding=1), "relu",
                    lambda x: x.reshape(x.shape[0], -1),
                    torch.nn.Linear(4 * 4 * 8, 10))
    return jann.AnnSequential(layers=jax_layers), tann.AnnSequential(
        torch_layers)


@pytest.fixture(scope="module")
def ann_pair():
    rng = np.random.default_rng(0)
    jm, tm = _anns()
    x0 = rng.uniform(0, 1, (4, 8, 8, 3)).astype(np.float32)
    variables = randomize_variables(
        jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x0)), 0)
    tm.load_state_dict(from_jax_variables(variables), strict=True)
    batches = [rng.uniform(0, 1, (4, 8, 8, 3)).astype(np.float32)
               for _ in range(3)]
    return jm, tm, variables, x0, batches


def test_ann_forward_matches_jax(ann_pair):
    jm, tm, variables, x0, _ = ann_pair
    tm.to("cpu")  # nn.Module's own methods still work on it
    want = np.asarray(jm.apply(variables, jnp.asarray(x0)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x0)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("mode", ["max", "99.9%", 0.9])
def test_converter_matches_jax(ann_pair, mode):
    jm, tm, variables, x0, batches = ann_pair
    want_snn, want_scales = jann.Converter(mode=mode).convert(
        jm, variables, [jnp.asarray(b) for b in batches])
    got_snn, got_scales = tann.Converter(mode=mode).convert(
        tm, [torch.from_numpy(b) for b in batches])
    np.testing.assert_allclose(got_scales, want_scales, rtol=1e-6)
    for t in (8, 32):
        want = np.asarray(jax.jit(lambda x, t=t: want_snn(x, t=t))(
            jnp.asarray(x0)))
        with torch.no_grad():
            got = got_snn(torch.from_numpy(x0), t=t).numpy()
        np.testing.assert_allclose(got, want, **TOL)


def test_converter_rejects_bad_modes(ann_pair):
    _, tm, _, x0, _ = ann_pair
    for mode in ("bogus", 1.5):
        with pytest.raises(ValueError):
            tann.Converter(mode=mode).calibrate(tm, [torch.from_numpy(x0)])


@pytest.mark.parametrize("q", [0.0, 0.5, 0.999, 1.0, 0.3])
def test_quantile_matches_jnp(q):
    x = np.random.default_rng(1).normal(0, 1, (7, 13, 11)).astype(
        np.float32)
    want = float(jnp.quantile(jnp.asarray(x).reshape(-1), q))
    got = float(tann.quantile(torch.from_numpy(x), q))
    np.testing.assert_allclose(got, want, rtol=1e-6)


# --- lava_exchange.py ---

def test_step_quantize_and_ste_match_jax():
    x = np.asarray([-1.3, -0.4, 0.0, 0.6, 2.49, 2.51, 3.0, -5.0],
                   np.float32)
    for step in (1.0, 2.0, 2.0 / 64):
        np.testing.assert_array_equal(
            tlava.step_quantize(torch.from_numpy(x), step).numpy(),
            np.asarray(jlava.step_quantize(jnp.asarray(x), step)))
    xt = torch.from_numpy(x).requires_grad_(True)
    (tlava.quantize_8bit(xt, 64) * 3.0).sum().backward()
    want = jax.grad(lambda v: jnp.sum(jlava.quantize_8bit(v, 64) * 3.0))(
        jnp.asarray(x))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))
    for descale in (False, True):
        np.testing.assert_array_equal(
            tlava.quantize_8bit(torch.from_numpy(x * 3), 64,
                                descale).numpy(),
            np.asarray(jlava.quantize_8bit(jnp.asarray(x * 3), 64,
                                           descale)))


def test_cuba_params_and_synapses_match_jax():
    for args in (("if", 0.5), ("lif", 1.0, None, 4.0)):
        assert tlava.to_cuba_params(*args) == jlava.to_cuba_params(*args)
    for bad in (dict(kind="if", v_reset=0.3),
                dict(kind="lif", decay_input=True)):
        with pytest.raises(ValueError):
            tlava.to_cuba_params(**bad)
    with pytest.raises(NotImplementedError):
        tlava.to_cuba_params("eif")
    rng = np.random.default_rng(2)
    k = rng.normal(0, 1, (3, 4)).astype(np.float32)      # flax [in, out]
    kc = rng.normal(0, 1, (2, 3, 4, 5)).astype(np.float32)  # HWIO
    sd = from_jax_variables({"params": {"d": {"kernel": k},
                                        "c": {"kernel": kc}}})
    np.testing.assert_array_equal(tlava.linear_to_synapse(sd["d.weight"]),
                                  jlava.linear_to_synapse(jnp.asarray(k)))
    np.testing.assert_array_equal(tlava.conv_to_synapse(sd["c.weight"]),
                                  jlava.conv_to_synapse(jnp.asarray(kc)))
    with pytest.raises(ValueError):
        tlava.linear_to_synapse(sd["d.weight"], bias=torch.zeros(4))
    with pytest.raises(ValueError):
        tlava.conv_to_synapse(sd["d.weight"])


def test_export_hdf5_matches_jax(tmp_path):
    h5py = pytest.importorskip("h5py")
    rng = np.random.default_rng(3)
    dense = rng.normal(0, 1, (4, 8)).astype(np.float32)
    conv = rng.normal(0, 1, (6, 2, 3, 3)).astype(np.float32)

    def layers(mod):
        return [{"type": "input", "shape": (8, 8, 2)},
                {"type": "conv", "weight": conv, "stride": 2, "padding": 1,
                 "neuron": mod.to_cuba_params("lif", tau=2.0),
                 "shape": (4, 4, 6)},
                {"type": "dense", "weight": dense,
                 "neuron": mod.to_cuba_params("if")}]

    tlava.export_hdf5(layers(tlava), str(tmp_path / "t.h5"), t_sample=16)
    jlava.export_hdf5(layers(jlava), str(tmp_path / "j.h5"), t_sample=16)

    def entries(path):
        out = {}
        with h5py.File(path, "r") as f:
            f.visititems(lambda name, obj: out.__setitem__(
                name, np.asarray(obj[()]))
                if isinstance(obj, h5py.Dataset) else None)
        return out

    got, want = entries(tmp_path / "t.h5"), entries(tmp_path / "j.h5")
    assert set(got) == set(want) and "layer/1/weight" in got
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# --- data/biomedical.py and the extra transforms ---

def _vol(seed=0, n=2, z=12, y=16, x=20):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(n, z, y, x)).astype(np.float32)
    seg = np.zeros((z, y, x), np.int32)
    seg[4:8, 5:10, 6:12] = 1
    seg[9:11, 2:5, 1:4] = 3
    return img, seg


BIO_CASES = {
    "crop": lambda m, img, seg, rng: m.random_crop_3d(img, seg, rng,
                                                      (8, 8, 8)),
    "crop_bg": lambda m, img, seg, rng: m.random_crop_3d(
        img, np.zeros_like(seg), rng, (8, 30, 8)),
    "crop_any": lambda m, img, seg, rng: m.random_crop_3d(
        img, seg, rng, 6, keep_foreground=False),
    "noise": lambda m, img, seg, rng: m.gaussian_noise_3d(img, rng,
                                                          prob=1.0),
    "blur": lambda m, img, seg, rng: m.gaussian_blur_3d(
        img, rng, prob=1.0, prob_per_channel=0.7),
    "blur_shared": lambda m, img, seg, rng: m.gaussian_blur_3d(
        img, rng, prob=1.0, prob_per_channel=1.0,
        different_sigma_per_channel=False, different_sigma_per_axis=False),
    "gamma": lambda m, img, seg, rng: m.random_gamma_3d(
        img, rng, prob=1.0, retain_stats=True),
    "gamma_inv": lambda m, img, seg, rng: m.random_gamma_3d(
        img, rng, prob=1.0, invert_image=True, per_channel=True),
    "pad": lambda m, img, seg, rng: m.pad_3d(img, seg, (14, 17, 25), 0.5,
                                             2),
    "flip": lambda m, img, seg, rng: m.random_flip_3d(
        img, seg, rng, 0.6, (0, 1, 2), swap_label_pairs=[(1, 3)]),
}


@pytest.mark.parametrize("case", sorted(BIO_CASES))
@pytest.mark.parametrize("seed", [1, 2])
def test_biomedical_bit_equal(case, seed):
    img, seg = _vol(seed)
    want = BIO_CASES[case](jbio, img, seg, np.random.default_rng(seed))
    got = BIO_CASES[case](tbio, img, seg, np.random.default_rng(seed))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _sample(seed, h=40, w=52):
    rng = np.random.default_rng(seed)
    return {"image": rng.integers(0, 255, (h, w, 3)).astype(np.uint8),
            "sem_seg": rng.integers(0, 6, (h, w)).astype(np.int32),
            "meta": {}}


TRANSFORM_CASES = {
    "rotate": lambda m, s, rng: m.random_rotate(s, rng, prob=1.0),
    "rotate_pad": lambda m, s, rng: m.random_rotate(s, rng, prob=0.7,
                                                    degree=45.0, pad_val=9),
    "rot_flip_rotate": lambda m, s, rng: m.random_rot_flip(
        s, rng, rotate_prob=1.0, degree=(-30.0, 10.0)),
    "rot_flip_flip": lambda m, s, rng: m.random_rot_flip(
        s, rng, rotate_prob=0.0, flip_prob=1.0),
    "rotate_exact": lambda m, s, rng: m._rotate_exact(s, 17.5, 255),
    "cutout": lambda m, s, rng: m.random_cutout(s, rng, prob=1.0,
                                                fill_in=(7, 8, 9)),
    "cutout_keep_seg": lambda m, s, rng: m.random_cutout(
        s, rng, prob=1.0, n_holes=(2, 4), seg_fill_in=None),
    "clahe": lambda m, s, rng: m.clahe(s),
    "clahe_grid": lambda m, s, rng: m.clahe(s, clip_limit=2.0,
                                            tile_grid_size=(4, 6)),
}


@pytest.mark.parametrize("case", sorted(TRANSFORM_CASES))
@pytest.mark.parametrize("seed", [3, 4])
def test_extra_transforms_bit_equal(case, seed):
    want = TRANSFORM_CASES[case](jtr, _sample(seed),
                                 np.random.default_rng(seed))
    got = TRANSFORM_CASES[case](ttr, _sample(seed),
                                np.random.default_rng(seed))
    assert set(got) == set(want)
    for k in ("image", "sem_seg"):
        if k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# --- runtime/ ---

@pytest.fixture(scope="module")
def runtimes():
    if not (trt.available() and jrt.available()):
        pytest.skip(f"native runtime not buildable: {trt.build_error()}")
    return trt, jrt


def test_runtime_decode_bit_equal(runtimes, tmp_path):
    rng = np.random.default_rng(5)
    Image.fromarray(rng.integers(0, 255, (37, 53, 3), np.uint8)).save(
        tmp_path / "x.jpg", quality=95)
    Image.fromarray(rng.integers(0, 200, (25, 31), np.uint8)).save(
        tmp_path / "s.png")
    Image.fromarray(rng.integers(0, 255, (9, 11, 4), np.uint8)).save(
        tmp_path / "a.png")
    for name in ("x.jpg", "s.png", "a.png"):
        got = trt.decode_image(str(tmp_path / name))
        np.testing.assert_array_equal(
            got, jrt.decode_image(str(tmp_path / name)))
    seg = np.asarray(Image.open(tmp_path / "s.png"))
    np.testing.assert_array_equal(
        trt.decode_image(str(tmp_path / "s.png"))[..., 0], seg)
    assert trt.decode_image(str(tmp_path / "missing.jpg")) is None


def test_runtime_ops_bit_equal(runtimes):
    rng = np.random.default_rng(6)
    img = rng.integers(0, 255, (40, 60, 3), np.uint8)
    seg = rng.integers(0, 150, (33, 47), np.int32)
    for oh, ow in ((80, 120), (17, 23), (40, 60)):
        np.testing.assert_array_equal(trt.resize_bilinear_u8(img, oh, ow),
                                      jrt.resize_bilinear_u8(img, oh, ow))
        np.testing.assert_array_equal(trt.resize_nearest_i32(seg, oh, ow),
                                      jrt.resize_nearest_i32(seg, oh, ow))
    mean, std = [123.675, 116.28, 103.53], [58.395, 57.12, 57.375]
    np.testing.assert_array_equal(trt.normalize_f32(img, mean, std),
                                  jrt.normalize_f32(img, mean, std))


def test_runtime_contract_without_a_library(monkeypatch):
    """Where the library cannot be built, ``available()`` is False and
    every function returns None, as in the JAX package."""
    monkeypatch.setattr(trt, "_lib", None)
    monkeypatch.setattr(trt, "_error", "no compiler")
    img = np.zeros((4, 4, 3), np.uint8)
    assert not trt.available() and trt.build_error() == "no compiler"
    assert trt.decode_image("x.jpg") is None
    assert trt.resize_bilinear_u8(img, 2, 2) is None
    assert trt.resize_nearest_i32(img[..., 0].astype(np.int32), 2, 2) is None
    assert trt.normalize_f32(img, [0] * 3, [1] * 3) is None


# --- loose public names ---

@pytest.mark.parametrize("name", ["focal_mask_cost", "dice_mask_cost"])
def test_mask_costs_match_jax(name):
    from spike2former_tpu.losses import matcher as jm
    from spike2former_tpu_torch.losses import matcher as tm

    rng = np.random.default_rng(7)
    pred = rng.normal(0, 3, (5, 12, 10)).astype(np.float32)
    gt = (rng.random((4, 12, 10)) < 0.4).astype(np.float32)
    want = np.asarray(getattr(jm, name)(jnp.asarray(pred), jnp.asarray(gt)))
    got = getattr(tm, name)(torch.from_numpy(pred),
                            torch.from_numpy(gt)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("out_hw", [(13, 21), (1, 5), (4, 1), (9, 9)])
def test_resize_bilinear_align_corners_matches_jax(out_hw):
    from spike2former_tpu.ops.resize import resize_bilinear_align_corners \
        as jresize
    from spike2former_tpu_torch.ops.resize import \
        resize_bilinear_align_corners as tresize

    x = np.random.default_rng(8).normal(0, 1, (2, 7, 9, 3)).astype(
        np.float32)
    want = np.asarray(jresize(jnp.asarray(x), out_hw))
    got = tresize(torch.from_numpy(x), out_hw).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    if min(out_hw) > 1:
        ref = torch.nn.functional.interpolate(
            torch.from_numpy(x).permute(0, 3, 1, 2), size=out_hw,
            mode="bilinear", align_corners=True).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got, ref.numpy(), atol=1e-5)


def test_spike_rate_matches_jax():
    from spike2former_tpu.ops.spike import spike_rate as jrate
    from spike2former_tpu_torch.ops.spike import spike_rate as trate

    y = (np.random.default_rng(9).integers(0, 9, (3, 5, 7)) / 8.0).astype(
        np.float32)
    np.testing.assert_allclose(float(trate(torch.from_numpy(y), 8.0)),
                               float(jrate(jnp.asarray(y), 8.0)), **TOL)


def test_ade_palette_matches_jax():
    from spike2former_tpu.data.metainfo import ade_palette as jpal
    from spike2former_tpu_torch.data.metainfo import ade_palette as tpal

    assert tpal() == jpal() and len(tpal()) == 150


def test_update_iou_on_tensors_matches_jax():
    from spike2former_tpu.evaluation import iou_metric as jiou
    from spike2former_tpu_torch.evaluation import iou_metric as tiou

    rng = np.random.default_rng(10)
    jstate, tstate = jiou.init_iou(6), tiou.init_iou(6)
    for _ in range(3):
        pred = rng.integers(0, 6, (2, 9, 11)).astype(np.int32)
        label = rng.integers(0, 6, (2, 9, 11)).astype(np.int32)
        label[:, :2] = 255
        jstate = jiou.update_iou(jstate, jnp.asarray(pred),
                                 jnp.asarray(label), 6)
        tstate = tiou.update_iou(tstate, torch.from_numpy(pred),
                                 torch.from_numpy(label), 6)
    for g, w in zip(tstate, jstate):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(
        tiou.compute_iou(tiou.IoUState(*(t.numpy() for t in tstate)))[
            "mIoU"],
        jiou.compute_iou(jstate)["mIoU"], rtol=1e-6)


def test_load_reference_backbone_matches_jax(tmp_path):
    from spike2former_tpu.engine.checkpoint import \
        load_reference_backbone as jload
    from spike2former_tpu.models import Spike2Former as JaxSpike2Former
    from spike2former_tpu_torch.engine.checkpoint import \
        load_reference_backbone as tload
    from spike2former_tpu_torch.models.segmentor import Spike2Former
    from torch_golden import GoldenSpike2Former, randomize_torch
    from torch_port_helpers import TINY

    golden = GoldenSpike2Former(
        num_classes=TINY["num_classes"], embed_dim=TINY["embed_dim"],
        heads=TINY["backbone_heads"], T=1, feat=TINY["feat_channels"],
        num_queries=TINY["num_queries"],
        dec_layers=TINY["num_decoder_layers"],
        enc_layers=TINY["num_encoder_layers"], group=TINY["dcn_group"],
        depths_stage3=TINY["depths_stage3"],
        depths_stage4=TINY["depths_stage4"])
    randomize_torch(golden, seed=4)
    path = str(tmp_path / "golden.pth")
    torch.save({"state_dict": golden.state_dict()}, path)
    depths = dict(depths_stage3=1, depths_stage4=1)
    jm = JaxSpike2Former(T=1, compat=True, **TINY)
    variables = randomize_variables(jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))), 5)
    want = from_jax_variables(jload(path, variables, **depths))
    pm = Spike2Former(T=1, compat=True, **TINY)
    sd = pm.state_dict()
    got = tload(path, sd, **depths)
    assert set(got) == set(sd) == set(want)
    for k in want:
        # the backbone from the checkpoint, the rest as it was
        ref = want[k] if k.startswith("backbone.") else sd[k]
        assert torch.equal(got[k], ref.to(got[k].dtype)), k
    pm.load_state_dict(got, strict=True)
