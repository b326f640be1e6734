"""Config dataclasses, the SDTv2 MaskFormer presets and dot-key overrides
(port of ``spike2former_tpu/engine/config.py``, without JAX).

Only the fields that inference, evaluation, the semantic train step and the
train CLI of the MaskFormer read are kept, so an override of anything else
(``model.kind``, ``model.masked_attention``, ...) is rejected as an
unknown key.  ``model.variant`` picks the backbone: ``sdtv2``
(Spiking_vit_MetaFormer), ``sdtv3`` (E-SpikeFormer) or ``sdtv3mae`` (its
MAE-pretrain flavour).  The presets are the SDTv2 MaskFormer's on ADE20K,
Cityscapes, VOC 2012 and COCO-Stuff, and the SDTv3 ones on ADE20K, VOC
and Cityscapes with the SDTv3-MAE one on ADE20K (T=4, collapsed); the
FPN, cascade, MS-ResNet and panoptic presets wait for later slices.

``train.loss_points > 0`` trains with the point-sampled matching costs
and mask losses (``losses/point_sample.py``; 12544 points, oversample 3.0
and importance 0.75 upstream); the presets keep 0, the reference's
active recipe.

``model.dtype`` ('float32' or 'bfloat16') is the compute dtype of the
convolutions and dense layers, as flax's ``dtype=``; parameters, BN
statistics and the optimizer stay float32.  ``model.remat`` recomputes
each backbone block and DCN encoder layer in the backward, and
``train.packed_residuals`` saves the spike codes at Spike->Conv sites as
packed 4-bit ``uint8`` (``ops/spike_op.py``): neither changes a number.
``train.unroll_loss`` is accepted and changes nothing: in the JAX package
it unrolls the loss's layer scans for the TPU compiler, and the port's
loss is a Python loop already.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field

import torch

from ..models.segmentor import Spike2Former


@dataclass
class ModelConfig:
    variant: str = "sdtv2"            # backbone: sdtv2 | sdtv3 | sdtv3mae
    num_classes: int = 150
    embed_dim: tuple = (64, 128, 256, 360)
    backbone_heads: int = 8
    T: int = 1
    feat_channels: int = 256
    num_queries: int = 100
    num_decoder_layers: int = 6
    num_encoder_layers: int = 6
    depths_stage3: int = 6
    depths_stage4: int = 2
    dcn_group: int = 32
    compat: bool = False              # reference-exact layout quirks
    norm_eval: bool = True            # freeze backbone BN in training
    collapse_t: bool = True           # skip provably-identical time steps
    eval_last_only: bool = True
    remat: bool = False               # recompute blocks in the backward
    lazy_masks: bool = True           # factored train-time mask logits
    dtype: str = "float32"            # compute dtype: float32 | bfloat16


@dataclass
class DataConfig:
    dataset: str = "ade20k"
    data_root: str = "data/ade/ADEChallengeData2016"
    crop_size: tuple = (512, 512)
    batch_size: int = 6
    num_workers: int = 8
    test_scale: tuple = (2048, 512)
    size_divisor: int = 32
    # MultiImageMixDataset-style mosaic mixing probability (0 = off; the
    # reference's RandomMosaic configs use 0.5), data/loader.py
    mosaic_prob: float = 0.0
    # decode-once RAM cache of the raw dataset (SegDataset.cache)
    cache: bool = False


@dataclass
class TrainConfig:
    base_lr: float = 1e-3
    # mmengine auto_scale_lr (ade20k config :212): base_lr scaled by
    # batch_size * accum_steps / auto_scale_lr_base_batch
    auto_scale_lr: bool = False
    auto_scale_lr_base_batch: int = 48
    weight_decay: float = 0.005
    backbone_lr_mult: float = 0.1
    clip_norm: float = 0.01
    warmup_iters: int = 1500
    total_iters: int = 160_000
    val_interval: int = 2500
    checkpoint_interval: int = 10_000
    max_keep_ckpts: int = 0           # >0: retain the newest N
    max_gt: int = 64
    # the exact fast path of the GT axis under the auction matcher
    # (losses.criterion.maskformer_loss); 0 disables
    compact_gt: int = 32
    matcher: str = "auction"          # 'auction' (on-device) | 'host' (scipy)
    loss_at: str = "gt"               # 'gt' (the reference) | 'pred'
    accum_steps: int = 1
    # a TPU compile knob of the JAX package (criterion.py's layer scans);
    # the port's loss loops in Python: accepted, no effect
    unroll_loss: bool = False
    # save Spike->Conv activations for the backward as packed 4-bit codes
    # (ops/spike_op.py): bit-identical gradients, less activation memory
    packed_residuals: bool = False
    layer_decay_rate: float = 0.0     # >0: layer-wise lr decay (optim.py)
    # point-sampled matching and mask losses (the Mask2Former recipe):
    # 0 = off (the loss_at path); 12544 upstream
    loss_points: int = 0
    loss_points_oversample: float = 3.0
    loss_points_importance: float = 0.75
    # the gradient-carrying point sampler's operand dtype
    loss_points_dtype: str = "float32"
    seed: int = 0


@dataclass
class TestConfig:
    mode: str = "whole"               # 'whole' | 'slide'
    crop_size: tuple = (512, 512)
    stride: tuple = (341, 341)
    bucket: int = 128                 # eval shape bucketing (0 = exact+pad32)


@dataclass
class Config:
    name: str = "custom"
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    test: TestConfig = field(default_factory=TestConfig)
    work_dir: str = "work_dirs"


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(name: str) -> torch.dtype:
    if name not in DTYPES:
        raise ValueError(f"model.dtype must be one of {tuple(DTYPES)}, "
                         f"got {name!r}")
    return DTYPES[name]


def build_model(cfg: ModelConfig, packed_residuals: bool = False
                ) -> Spike2Former:
    """The MaskFormer for ``cfg`` (the only kind ported yet) with the
    ``cfg.variant`` backbone, in ``cfg.dtype``; ``packed_residuals``
    (``train.packed_residuals``) saves packed spike codes at its
    Spike->Conv sites."""
    return Spike2Former(
        variant=cfg.variant,
        num_classes=cfg.num_classes, embed_dim=tuple(cfg.embed_dim),
        backbone_heads=cfg.backbone_heads, T=cfg.T,
        feat_channels=cfg.feat_channels, num_queries=cfg.num_queries,
        num_decoder_layers=cfg.num_decoder_layers,
        num_encoder_layers=cfg.num_encoder_layers,
        depths_stage3=cfg.depths_stage3, depths_stage4=cfg.depths_stage4,
        dcn_group=cfg.dcn_group, compat=cfg.compat,
        norm_eval=cfg.norm_eval, collapse_t=cfg.collapse_t,
        eval_last_only=cfg.eval_last_only, lazy_masks=cfg.lazy_masks,
        remat=cfg.remat, dtype=compute_dtype(cfg.dtype),
        packed_residuals=packed_residuals)


def apply_overrides(cfg: Config, options: list[str]) -> Config:
    """--cfg-options style dot-key overrides: ``'model.T=4'``."""
    for opt in options:
        key, _, raw = opt.partition("=")
        try:
            value = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            value = raw
        *parents, leaf = key.split(".")
        target = cfg
        for p in parents:
            target = getattr(target, p)
        if not hasattr(target, leaf):
            hint = (" (the port has the MaskFormer only: the FPN, cascade "
                    "and MS-ResNet kinds are not ported yet)"
                    if key == "model.kind" else "")
            raise AttributeError(
                f"unknown config key {key!r} ({type(target).__name__} "
                f"has no field {leaf!r}){hint}")
        setattr(target, leaf, value)
    return cfg


def _ade_spike2former_sdtv2() -> Config:
    """SDTv2_maskformer_DCNpixelDecoder_ade20k.py, the flagship."""
    return Config(name="SDTv2_maskformer_DCNpixelDecoder_ade20k",
                  model=ModelConfig(T=1, num_classes=150),
                  data=DataConfig(dataset="ade20k", batch_size=6),
                  test=TestConfig(mode="whole"))


def _cityscapes_spike2former_sdtv2() -> Config:
    """SDTv2_maskformer_DCNPixelDecoder_CityScapes.py: 512x1024 crops,
    whole-image eval at (2048, 1024)."""
    return Config(name="SDTv2_maskformer_DCNPixelDecoder_CityScapes",
                  model=ModelConfig(T=1, num_classes=19),
                  data=DataConfig(dataset="cityscapes", crop_size=(512, 1024),
                                  data_root="data/cityscapes",
                                  test_scale=(2048, 1024), batch_size=2),
                  test=TestConfig(mode="whole"))


def _voc_spike2former_sdtv2() -> Config:
    """SDTv2_Spike2former_voc_512x512.py."""
    return Config(name="SDTv2_Spike2former_voc_512x512",
                  model=ModelConfig(T=1, num_classes=21),
                  data=DataConfig(dataset="voc2012",
                                  data_root="data/VOCdevkit/VOC2012",
                                  test_scale=(2048, 512)))


def _cocostuff_spike2former_sdtv2(k: str) -> Config:
    """SDTv2_maskformer_cocostuff{10k,164k}_512x512.py: both read the
    164k layout, as the JAX package's presets do."""
    return Config(name=f"SDTv2_maskformer_cocostuff{k}_512x512",
                  model=ModelConfig(T=1, num_classes=171),
                  data=DataConfig(dataset="coco_stuff164k",
                                  data_root="data/coco_stuff164k"))


def _ade_spike2former_sdtv3() -> Config:
    """SDTv3_b_Spike2former_ade20k_512x512.py: the E-SpikeFormer
    backbone."""
    return Config(name="SDTv3_b_Spike2former_ade20k_512x512",
                  model=ModelConfig(variant="sdtv3", T=4, num_classes=150),
                  data=DataConfig(dataset="ade20k"))


def _voc_spike2former_sdtv3() -> Config:
    return Config(name="SDTv3_b_Spike2former_voc_512x512",
                  model=ModelConfig(variant="sdtv3", T=4, num_classes=21),
                  data=DataConfig(dataset="voc2012",
                                  data_root="data/VOCdevkit/VOC2012"))


def _cityscapes_spike2former_sdtv3() -> Config:
    return Config(name="SDTv3_b_Spike2former_Cityscapes_512x1024",
                  model=ModelConfig(variant="sdtv3", T=4, num_classes=19),
                  data=DataConfig(dataset="cityscapes", crop_size=(512, 1024),
                                  data_root="data/cityscapes",
                                  test_scale=(2048, 1024), batch_size=2))


def _ade_spike2former_sdtv3mae() -> Config:
    """The Spiking_vit_MetaFormerv3 (sdtv3MAE.py) backbone, which the
    reference registers without a config of its own: CSWin striped
    attention, multispike8, no stage-4 downsample."""
    return Config(name="SDTv3MAE_Spike2former_ade20k_512x512",
                  model=ModelConfig(variant="sdtv3mae", T=4, num_classes=150),
                  data=DataConfig(dataset="ade20k"))


PRESETS = {
    "SDTv2_maskformer_DCNpixelDecoder_ade20k": _ade_spike2former_sdtv2,
    "SDTv2_maskformer_DCNPixelDecoder_CityScapes":
        _cityscapes_spike2former_sdtv2,
    "SDTv2_Spike2former_voc_512x512": _voc_spike2former_sdtv2,
    "SDTv2_maskformer_cocostuff10k_512x512":
        lambda: _cocostuff_spike2former_sdtv2("10k"),
    "SDTv2_maskformer_cocostuff164k_512x512":
        lambda: _cocostuff_spike2former_sdtv2("164k"),
    "SDTv3_b_Spike2former_ade20k_512x512": _ade_spike2former_sdtv3,
    "SDTv3_b_Spike2former_voc_512x512": _voc_spike2former_sdtv3,
    "SDTv3_b_Spike2former_Cityscapes_512x1024":
        _cityscapes_spike2former_sdtv3,
    "SDTv3MAE_Spike2former_ade20k_512x512": _ade_spike2former_sdtv3mae,
}


def get_config(name: str, overrides: list[str] | None = None) -> Config:
    if name not in PRESETS:
        raise KeyError(f"no preset {name!r} in the port (it has "
                       f"{sorted(PRESETS)}; the FPN, cascade, MS-ResNet and "
                       "panoptic presets are not ported yet)")
    cfg = PRESETS[name]()
    return apply_overrides(cfg, overrides) if overrides else cfg
