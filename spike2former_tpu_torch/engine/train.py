"""Semantic train step (port of ``make_train_step`` of
``spike2former_tpu/engine/train.py``) and its library entry points
``init_trainer`` / ``train_steps``, the loop of ``tools/train.py`` without
the data layer.

One step: forward in training mode (decoder-layer BNs on batch statistics,
backbone BNs frozen under ``norm_eval``), GT slots from the semantic map,
matching of all supervised layers in one call (the on-device auction with
the ``compact_gt`` fast path, the preset's default, or the exact host
matcher), CE + focal + dice, backward (through the DCNv3 backward kernel
on the card), global-norm clipping and the grouped AdamW update.  Unlike
the JAX step, which returns a new state, the step updates the model and
optimizer in place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable

import torch
from torch.profiler import record_function

from ..device import f32_precision, resolve_device
from ..losses.criterion import maskformer_loss, semantic_to_instances
from ..models.segmentor import Spike2Former, preprocess
from .config import Config, TrainConfig, build_model, get_config
from .optim import AdamW
from .weights import randomize_


@dataclass
class TrainState:
    """The model (its parameters and BN statistics), the optimizer state
    and the number of steps taken."""

    model: Spike2Former
    optimizer: AdamW
    step: int = 0


def scaled_base_lr(cfg: Config) -> float:
    """``cfg.train.base_lr``, or with ``auto_scale_lr`` the linear scaling
    rule against the recipe's batch (mmengine ``auto_scale_lr``, ade20k
    config :212): times ``batch_size * accum_steps /
    auto_scale_lr_base_batch``."""
    t = cfg.train
    if not t.auto_scale_lr:
        return t.base_lr
    return t.base_lr * (cfg.data.batch_size * t.accum_steps
                        / t.auto_scale_lr_base_batch)


def init_state(model: Spike2Former, train_cfg: TrainConfig,
               base_lr: float | None = None) -> TrainState:
    """Wrap ``model`` with a fresh AdamW of ``train_cfg``'s recipe, at
    ``base_lr`` when given (``scaled_base_lr``), with the layer-wise decay
    of ``train_cfg.layer_decay_rate`` when it is set."""
    opt = AdamW(model.named_parameters(),
                base_lr=train_cfg.base_lr if base_lr is None else base_lr,
                weight_decay=train_cfg.weight_decay,
                backbone_lr_mult=train_cfg.backbone_lr_mult,
                clip_norm=train_cfg.clip_norm,
                warmup_iters=train_cfg.warmup_iters,
                total_iters=train_cfg.total_iters,
                layer_decay_rate=train_cfg.layer_decay_rate or None)
    return TrainState(model, opt)


def make_train_step(num_classes: int, max_gt: int = 64,
                    matcher: str = "auction", loss_at: str = "gt",
                    accum_steps: int = 1, compact_gt: int = 32) -> Callable:
    """Returns ``train_step(state, images_u8, sem_seg) -> (state,
    metrics)``.

    images_u8 [B, H, W, 3] RGB and sem_seg [B, H, W] int (255 = ignore) on
    the model's device.  ``metrics`` holds the loss dict (``loss_cls``,
    ``d{i}.loss_mask``, ..., ``total``, ``repaired_gt``), ``dropped_gt``
    and ``grad_norm``, as 0-dim tensors.  After the step every parameter's
    ``.grad`` holds the gradient it was updated with.

    ``accum_steps > 1`` splits the batch into that many sequential
    microbatches, each updating the BN statistics, and averages their
    gradients (and metrics) before one optimizer update.

    ``compact_gt`` (0 disables) cuts the GT axis for the auction matcher
    where no slot past it is valid (``losses.criterion.maskformer_loss``).

    The stages run inside ``torch.profiler.record_function`` ranges
    (``forward``, ``match_and_loss``, ``backward``, ``optimizer``), which
    ``profile_train.py`` reads."""
    if matcher not in ("auction", "host"):
        raise ValueError(
            f"matcher must be 'auction' or 'host', got {matcher!r}")
    if loss_at not in ("gt", "pred"):
        raise ValueError(f"loss_at must be 'gt' or 'pred', got {loss_at!r}")

    def microbatch(model, images, sem_seg) -> dict[str, torch.Tensor]:
        with record_function("forward"):
            cls_scores, mask_preds = model(preprocess(images))
        with record_function("match_and_loss"):
            gt = semantic_to_instances(sem_seg, num_classes, max_gt)
            losses = maskformer_loss(cls_scores, mask_preds, gt,
                                     num_classes=num_classes,
                                     matcher=matcher, loss_at=loss_at,
                                     compact_gt=compact_gt or None)
        with record_function("backward"):
            (losses["total"] / accum_steps).backward()
        losses = {k: v.detach() for k, v in losses.items()}
        losses["dropped_gt"] = gt.dropped.sum().float()
        return losses

    def train_step(state: TrainState, images_u8: torch.Tensor,
                   sem_seg: torch.Tensor):
        model = state.model.train()
        b = images_u8.shape[0]
        if b % accum_steps:
            raise ValueError(f"batch {b} does not split into "
                             f"{accum_steps} microbatches")
        for p in model.parameters():
            p.grad = None
        per_mb = [microbatch(model, im, seg) for im, seg in zip(
            images_u8.chunk(accum_steps), sem_seg.chunk(accum_steps))]
        metrics = {k: torch.stack([m[k] for m in per_mb]).mean()
                   for k in per_mb[0]}
        with record_function("optimizer"):
            metrics["grad_norm"] = state.optimizer.step()
        state.step += 1
        return state, metrics

    return train_step


@dataclass
class Trainer:
    cfg: Config
    state: TrainState
    step_fn: Callable
    device: torch.device


def init_trainer(config: str | Config, overrides: list[str] | None = None,
                 device: str | torch.device | None = None,
                 seed: int | None = None,
                 state_dict: dict[str, torch.Tensor] | None = None
                 ) -> Trainer:
    """Build a model and its train step from a preset (or Config) on
    ``device`` (the card unless ``device="cpu"``).  Weights come from
    ``state_dict``, loaded strictly, or are drawn from ``seed``
    (``engine/weights.py``), which defaults to ``cfg.train.seed``.  The
    optimizer runs at ``scaled_base_lr(cfg)``."""
    dev = resolve_device(device)
    cfg = get_config(config, overrides) if isinstance(config, str) else config
    t = cfg.train
    step_fn = make_train_step(cfg.model.num_classes, max_gt=t.max_gt,
                              matcher=t.matcher, loss_at=t.loss_at,
                              accum_steps=t.accum_steps,
                              compact_gt=t.compact_gt)
    model = build_model(cfg.model)
    if state_dict is None:
        randomize_(model, t.seed if seed is None else seed)
    else:
        model.load_state_dict(state_dict, strict=True)
    model.to(dev)
    return Trainer(cfg, init_state(model, t, scaled_base_lr(cfg)), step_fn,
                   dev)


def train_steps(trainer: Trainer, batches: Iterable) -> list[dict]:
    """Take one step per ``(images_u8 [B, H, W, 3], sem_seg [B, H, W])``
    batch (numpy arrays or tensors); returns each step's metrics as
    floats.  The steps run in full float32 whatever the caller's TF32
    flags (``device.f32_precision``)."""
    out = []
    with f32_precision():
        for images, sem_seg in batches:
            _, metrics = trainer.step_fn(
                trainer.state,
                torch.as_tensor(images, device=trainer.device),
                torch.as_tensor(sem_seg, device=trainer.device))
            out.append({k: float(v) for k, v in metrics.items()})
    return out
