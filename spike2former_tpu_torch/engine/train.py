"""The semantic, panoptic and FPN-family train steps (port of
``make_train_step``, ``make_train_step_panoptic`` and
``make_train_step_fpn`` of ``spike2former_tpu/engine/train.py``) and
their library entry points ``init_trainer`` / ``train_steps``, the loop
of ``tools/train.py`` without the data layer.

One step: forward in training mode (decoder-layer BNs on batch statistics,
backbone BNs frozen under ``norm_eval``), GT slots from the semantic map
(or from the panoptic segments),
matching of all supervised layers in one call (the on-device auction with
the ``compact_gt`` fast path, the preset's default, or the exact host
matcher), CE + focal + dice, backward (through the DCNv3 backward kernel
on the card), global-norm clipping and the grouped AdamW update.  Unlike
the JAX step, which returns a new state, the step updates the model and
optimizer in place.

Where a process group of more than one rank exists, each step is one
data-parallel step of the global batch, every rank taking its own rows
(``parallel/mesh.py``): the BN statistics, loss normalizers, point and
dropout draws and logged metrics are the global batch's, the gradients
are summed over the ranks before the clip, and after the step every
rank holds the same parameters.  The FPN family's pixel losses run on
the gathered logits, the same on every rank.  With ``accum_steps > 1``
the global microbatch ``m`` is every rank's ``m``-th chunk.

These reductions run over the data group of the process's mesh
(``parallel.make_mesh``; the world without one).  Under tensor
parallelism (``parallel.shard_params_tp`` of the ``TrainState``) the
ranks of a model group take the same rows, compute the split FFNs
together and each update their own shards: gradients and metrics are
still summed over the data group only, and the clip reads the logical
norm (``engine/optim.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable

import torch
from torch import nn
from torch.profiler import record_function

from ..device import f32_precision, resolve_device
from ..losses.criterion import (GroundTruth, maskformer_loss,
                                semantic_to_instances, slot_map_from_masks)
from ..losses.pixel import build_pixel_loss, pixel_accuracy
from ..losses.point_sample import Draw
from ..models.fpn import Dropout, dropout_key
from ..models.segmentor import preprocess
from ..parallel.mesh import (all_reduce_grads, all_reduce_metrics,
                             gather_rows, global_batch, global_draw)
from .config import (Config, TrainConfig, build_model, compute_dtype,
                     get_config)
from .optim import AdamW
from ..utils import jax_random as jr
from .weights import init_weights_


@dataclass
class TrainState:
    """The model (its parameters and BN statistics), the optimizer state
    and the number of steps taken."""

    model: nn.Module
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


def init_state(model: nn.Module, train_cfg: TrainConfig,
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


def _step_fn(gt_of: Callable[..., GroundTruth], loss_kw: dict,
             accum_steps: int, num_points: int, seed: int,
             point_draw: Callable[[int, int], Draw] | None,
             report_dropped: bool) -> Callable:
    """``train_step(state, images, *targets) -> (state, metrics)``: the
    targets of each microbatch become its ``GroundTruth`` by ``gt_of``;
    the loss is ``maskformer_loss`` with ``loss_kw``."""

    def microbatch(model, images, targets, draw, rng
                   ) -> dict[str, torch.Tensor]:
        with record_function("forward"):
            cls_scores, mask_preds = model(preprocess(images))
        with record_function("match_and_loss"):
            gt = gt_of(*targets)
            losses = maskformer_loss(cls_scores, mask_preds, gt, draw=draw,
                                     rng=rng, **loss_kw)
        with record_function("backward"):
            (losses["total"] / accum_steps).backward()
        losses = {k: v.detach() for k, v in losses.items()}
        if report_dropped:
            losses["dropped_gt"] = gt.dropped.sum().float()
        return losses

    def train_step(state: TrainState, images: torch.Tensor,
                   *targets: torch.Tensor):
        with global_batch():
            return _train_step(state, images, *targets)

    def _train_step(state: TrainState, images: torch.Tensor,
                    *targets: torch.Tensor):
        model = state.model.train()
        b = images.shape[0]
        if b % accum_steps:
            raise ValueError(f"batch {b} does not split into "
                             f"{accum_steps} microbatches")
        for p in model.parameters():
            p.grad = None
        per_mb = []
        chunks = [t.chunk(accum_steps) for t in targets]
        # JAX's point keys: fold_in(PRNGKey(seed), step), and per
        # microbatch fold_in(., m) (JAX engine/train.py:88, :103)
        rng = jr.fold_in(jr.key(seed), state.step)
        for m, im in enumerate(images.chunk(accum_steps)):
            draw = mb_rng = None
            if num_points and point_draw:
                draw = global_draw(point_draw(state.step, m))
            elif num_points:
                mb_rng = rng if accum_steps == 1 else jr.fold_in(rng, m)
            per_mb.append(microbatch(model, im, [c[m] for c in chunks],
                                     draw, mb_rng))
        metrics = {k: torch.stack([m[k] for m in per_mb]).mean()
                   for k in per_mb[0]}
        metrics = all_reduce_metrics(metrics)
        with record_function("optimizer"):
            all_reduce_grads(model.parameters())
            metrics["grad_norm"] = state.optimizer.step()
        state.step += 1
        return state, metrics

    return train_step


def _loss_kw(num_classes, matcher, loss_at, compact_gt, num_points,
             oversample_ratio, importance_sample_ratio, points_dtype):
    """``maskformer_loss``'s keywords for a train step, checked."""
    if matcher not in ("auction", "host"):
        raise ValueError(
            f"matcher must be 'auction' or 'host', got {matcher!r}")
    if loss_at not in ("gt", "pred"):
        raise ValueError(f"loss_at must be 'gt' or 'pred', got {loss_at!r}")
    return dict(num_classes=num_classes, matcher=matcher, loss_at=loss_at,
                compact_gt=compact_gt or None, num_points=num_points,
                oversample_ratio=oversample_ratio,
                importance_sample_ratio=importance_sample_ratio,
                points_dtype=compute_dtype(points_dtype))


def make_train_step(num_classes: int, max_gt: int = 64,
                    matcher: str = "auction", loss_at: str = "gt",
                    accum_steps: int = 1, compact_gt: int = 32,
                    num_points: int = 0, oversample_ratio: float = 3.0,
                    importance_sample_ratio: float = 0.75,
                    points_dtype: str = "float32", seed: int = 0,
                    point_draw: Callable[[int, int], Draw] | None = None
                    ) -> Callable:
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

    ``num_points > 0`` trains on point-sampled matching costs and mask
    losses (``train.loss_points`` and its ``oversample_ratio``,
    ``importance_sample_ratio`` and ``points_dtype``).  Step ``s`` draws
    its points from JAX's key ``fold_in(PRNGKey(seed), s)``, microbatch
    ``m`` of several from ``fold_in(., m)``, so a resumed run draws what
    it would have; ``point_draw(s, m)``, when given, hands in the
    uniforms instead.

    The stages run inside ``torch.profiler.record_function`` ranges
    (``forward``, ``match_and_loss``, ``backward``, ``optimizer``), which
    ``profile_train.py`` reads."""
    return _step_fn(
        lambda sem_seg: semantic_to_instances(sem_seg, num_classes, max_gt),
        _loss_kw(num_classes, matcher, loss_at, compact_gt, num_points,
                 oversample_ratio, importance_sample_ratio, points_dtype),
        accum_steps, num_points, seed, point_draw, report_dropped=True)


def make_train_step_panoptic(
        num_classes: int, matcher: str = "auction", loss_at: str = "gt",
        compact_gt: int = 32, num_points: int = 0,
        oversample_ratio: float = 3.0, importance_sample_ratio: float = 0.75,
        points_dtype: str = "float32", seed: int = 0,
        point_draw: Callable[[int, int], Draw] | None = None) -> Callable:
    """The panoptic step (JAX ``make_train_step_panoptic``): ``train_step(
    state, images, labels, masks, valid) -> (state, metrics)`` with images
    [B, H, W, 3] RGB (float or uint8) and the padded segments of
    ``data.panoptic.panoptic_train_batches``: labels [B, G] int, masks
    [B, G, H, W] {0, 1} (any dtype; uint8 is the cheapest to copy) and
    valid [B, G] bool, on the model's device.  Things keep their instance
    identity, stuff is one segment per class; the segments are disjoint,
    so they travel as a slot map (``slot_map_from_masks``) into the
    semantic step's loss, matcher, ``compact_gt`` path, point branch and
    optimizer.  ``metrics`` as ``make_train_step``'s without
    ``dropped_gt``."""

    def gt_of(labels, masks, valid):
        valid = valid.bool()
        return GroundTruth(
            labels=labels.long(), valid=valid,
            dropped=torch.zeros(labels.shape[0], dtype=torch.long,
                                device=labels.device),
            slot_map=slot_map_from_masks(masks, valid))

    return _step_fn(
        gt_of, _loss_kw(num_classes, matcher, loss_at, compact_gt,
                        num_points, oversample_ratio,
                        importance_sample_ratio, points_dtype),
        1, num_points, seed, point_draw, report_dropped=False)


def make_train_step_fpn(loss_decode=(("ce", 1.0),),
                        dropout_draw: Callable | None = None) -> Callable:
    """The FPN family's step (JAX ``make_train_step_fpn``): ``train_step(
    state, images_u8, sem_seg) -> (state, metrics)`` with images [B, H, W,
    3] RGB and sem_seg [B, H, W] int (255 = ignore) on the model's device.

    The loss is ``build_pixel_loss(loss_decode)`` on the logits (the
    reference's configurable decode loss, decode_head.py:115-128), with
    ``acc_seg``; a cascade's stages each take it, their terms summed into
    ``total`` and reported as ``decode_<i>.loss_<name>``, ``acc_seg`` of
    the last.  ``metrics`` adds ``total`` and ``grad_norm``.

    Each ``Dropout`` keeps by flax's mask of step ``s``: the key of its
    module path under ``fold_in(PRNGKey(0), s)`` (the JAX step's, whatever
    the seed: JAX engine/train.py:166); ``dropout_draw(s)``, when given,
    hands in the uniforms instead (a ``draw(shape, device)``).  The stages
    run in ``record_function`` ranges ``forward``, ``pixel_loss``,
    ``backward`` and ``optimizer``."""
    pixel_loss = build_pixel_loss(loss_decode)

    def train_step(state: TrainState, images: torch.Tensor,
                   sem_seg: torch.Tensor):
        with global_batch():
            return _train_step(state, images, sem_seg)

    def _train_step(state: TrainState, images: torch.Tensor,
                    sem_seg: torch.Tensor):
        model = state.model.train()
        for p in model.parameters():
            p.grad = None
        drops = [(n, m) for n, m in model.named_modules()
                 if isinstance(m, Dropout)]
        rng = jr.fold_in(jr.key(0), state.step)
        for name, m in drops:
            if dropout_draw is not None:
                m.draw = global_draw(dropout_draw(state.step), m.batch_axis)
            else:
                m.key = dropout_key(rng, name)
        try:
            with record_function("forward"):
                logits = model(preprocess(images))
        finally:
            for _, m in drops:
                m.draw = m.key = None
        with record_function("pixel_loss"):
            # the global batch's logits and labels on every rank: the
            # losses' means, sorts and OHEM thresholds are the batch's
            sem_seg = gather_rows(sem_seg)
            if isinstance(logits, (list, tuple)):
                logits = [gather_rows(stage) for stage in logits]
            else:
                logits = gather_rows(logits)
            if isinstance(logits, (list, tuple)):
                total, metrics = torch.zeros((), device=images.device), {}
                for i, stage in enumerate(logits):
                    stage_total, stage_metrics = pixel_loss(stage, sem_seg)
                    total = total + stage_total
                    metrics.update({f"decode_{i}.{k}": v
                                    for k, v in stage_metrics.items()})
                last = logits[-1]
            else:
                total, metrics = pixel_loss(logits, sem_seg)
                last = logits
            metrics["acc_seg"] = pixel_accuracy(last.detach(), sem_seg)
        with record_function("backward"):
            total.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["total"] = total.detach()
        with record_function("optimizer"):
            all_reduce_grads(model.parameters())
            metrics["grad_norm"] = state.optimizer.step()
        state.step += 1
        return state, metrics

    return train_step


def is_fpn(cfg: Config) -> bool:
    """Whether ``cfg`` builds the FPN family (``model.kind`` 'fpn' or
    'cascade'), which trains on the pixel losses."""
    return cfg.model.kind in ("fpn", "cascade")


def is_panoptic(cfg: Config) -> bool:
    """Whether ``cfg`` trains and evaluates panoptic segmentation (the
    JAX CLIs' test: the dataset is COCO panoptic)."""
    return cfg.data.dataset == "coco_panoptic"


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
    """Build a model and its train step (the FPN family's where
    ``is_fpn(cfg)``, else the panoptic one where ``is_panoptic(cfg)``) from a preset (or Config) on ``device`` (the
    card unless ``device="cpu"``), in ``model.dtype``, with
    ``model.remat`` and ``train.packed_residuals`` as the config says (the
    parameters, gradients and AdamW moments stay float32).  Weights come from
    ``state_dict``, loaded strictly, or are JAX's ``model.init`` variables
    of ``PRNGKey(seed)`` (``engine/weights.py:init_weights_``, drawn on
    ``device``), ``seed`` defaulting to ``cfg.train.seed`` (JAX's train
    CLI's).  The
    optimizer runs at ``scaled_base_lr(cfg)``."""
    dev = resolve_device(device)
    cfg = get_config(config, overrides) if isinstance(config, str) else config
    t = cfg.train
    kw = dict(matcher=t.matcher, loss_at=t.loss_at, compact_gt=t.compact_gt,
              num_points=t.loss_points,
              oversample_ratio=t.loss_points_oversample,
              importance_sample_ratio=t.loss_points_importance,
              points_dtype=t.loss_points_dtype, seed=t.seed)
    if is_fpn(cfg):
        if t.accum_steps != 1:
            raise ValueError("the FPN family's step takes no accum_steps, "
                             "as in the JAX package")
        step_fn = make_train_step_fpn(t.loss_decode)
    elif is_panoptic(cfg):
        step_fn = make_train_step_panoptic(cfg.model.num_classes, **kw)
    else:
        step_fn = make_train_step(cfg.model.num_classes, max_gt=t.max_gt,
                                  accum_steps=t.accum_steps, **kw)
    model = build_model(cfg.model, packed_residuals=t.packed_residuals)
    model.to(dev)
    if state_dict is None:
        init_weights_(model, t.seed if seed is None else seed)
    else:
        model.load_state_dict(state_dict, strict=True)
    return Trainer(cfg, init_state(model, t, scaled_base_lr(cfg)), step_fn,
                   dev)


def train_steps(trainer: Trainer, batches: Iterable) -> list[dict]:
    """Take one step per batch (numpy arrays or tensors): ``(images_u8
    [B, H, W, 3], sem_seg [B, H, W])``, or for a panoptic trainer
    ``(images, labels, masks, valid)`` as ``panoptic_train_batches``
    yields them; returns each step's metrics as floats.  The steps run in
    full float32 whatever the caller's TF32 flags
    (``device.f32_precision``)."""
    out = []
    with f32_precision():
        for batch in batches:
            _, metrics = trainer.step_fn(
                trainer.state,
                *(torch.as_tensor(a, device=trainer.device) for a in batch))
            out.append({k: float(v) for k, v in metrics.items()})
    return out
