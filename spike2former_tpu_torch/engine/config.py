"""Config dataclasses, the flagship preset and dot-key overrides (port of
``spike2former_tpu/engine/config.py``, without JAX).

Only the fields that inference, evaluation, the semantic train step and the
train CLI of the f32 SDTv2 MaskFormer read are kept, so an override of
anything else (``model.variant``, ``model.kind``, ``train.loss_points``,
...) is rejected as an unknown key; the other presets wait for later
slices of the port.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field

from ..models.segmentor import Spike2Former


@dataclass
class ModelConfig:
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
    lazy_masks: bool = True           # factored train-time mask logits


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
    layer_decay_rate: float = 0.0     # >0: layer-wise lr decay (optim.py)
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


def build_model(cfg: ModelConfig) -> Spike2Former:
    """The f32 SDTv2 MaskFormer for ``cfg`` (the only kind ported yet)."""
    return Spike2Former(
        num_classes=cfg.num_classes, embed_dim=tuple(cfg.embed_dim),
        backbone_heads=cfg.backbone_heads, T=cfg.T,
        feat_channels=cfg.feat_channels, num_queries=cfg.num_queries,
        num_decoder_layers=cfg.num_decoder_layers,
        num_encoder_layers=cfg.num_encoder_layers,
        depths_stage3=cfg.depths_stage3, depths_stage4=cfg.depths_stage4,
        dcn_group=cfg.dcn_group, compat=cfg.compat,
        norm_eval=cfg.norm_eval, collapse_t=cfg.collapse_t,
        eval_last_only=cfg.eval_last_only, lazy_masks=cfg.lazy_masks)


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
            raise AttributeError(
                f"unknown config key {key!r} ({type(target).__name__} "
                f"has no field {leaf!r})")
        setattr(target, leaf, value)
    return cfg


def _ade_spike2former_sdtv2() -> Config:
    """SDTv2_maskformer_DCNpixelDecoder_ade20k.py, the flagship."""
    return Config(name="SDTv2_maskformer_DCNpixelDecoder_ade20k",
                  model=ModelConfig(T=1, num_classes=150),
                  data=DataConfig(dataset="ade20k"),
                  test=TestConfig(mode="whole"))


PRESETS = {"SDTv2_maskformer_DCNpixelDecoder_ade20k": _ade_spike2former_sdtv2}


def get_config(name: str, overrides: list[str] | None = None) -> Config:
    cfg = PRESETS[name]()
    return apply_overrides(cfg, overrides) if overrides else cfg
