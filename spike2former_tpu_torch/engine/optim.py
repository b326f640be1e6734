"""AdamW with the reference recipe's parameter groups, global-norm
clipping and warmup-poly schedule (port of
``spike2former_tpu/engine/optim.py``: ``poly_warmup_schedule``,
``_param_labels``, ``_flat_adamw``, ``layerwise_decay_scales``).

Recipe (configs/Spike2Former/SDTv2_maskformer_DCNpixelDecoder_ade20k.py
:138-167): AdamW(lr 1e-3, betas (0.9, 0.999), weight decay 0.005), clip at
global norm 0.01, linear warmup from 1e-6 x over 1500 iterations then poly
(power 1) to 160k; backbone lr x0.1, query/level embeddings without weight
decay.  The update is the JAX package's own arithmetic:

* clip factor ``min(1, clip / max(|g|, 1e-16))`` (not
  ``clip_grad_norm_``'s ``clip / (|g| + 1e-6)``);
* the schedule is read at the count before the increment, so step 0 runs
  at ``base_lr * 1e-6``;
* decoupled decay ``u + wd * p``, the sum scaled by ``-lr * lr_mult``;
* with ``layer_decay_rate``, each parameter's ``lr_mult`` (after the
  backbone's x0.1) times its layer-wise decay scale.

Moments are updated with ``torch._foreach_*`` ops, a few launches per
group rather than per parameter.

Under tensor parallelism (``parallel/tp.py``) each rank updates its
shards, and the clip's global norm is the logical parameters': the
squares of the split gradients summed over the model group, each
replicated one counted once.
"""
from __future__ import annotations

import re
from typing import Callable, Iterable

import torch
import torch.distributed as dist

from ..parallel.tp import tp_sharded


def poly_warmup_schedule(base_lr: float = 1e-3, warmup_iters: int = 1500,
                         total_iters: int = 160_000,
                         warmup_start_factor: float = 1e-6,
                         power: float = 1.0, eta_min: float = 0.0
                         ) -> Callable[[int], float]:
    """Learning rate at ``step``: linear warmup, then poly decay."""

    def schedule(step: int) -> float:
        if step < warmup_iters:
            return base_lr * (warmup_start_factor
                              + (1 - warmup_start_factor) * step
                              / warmup_iters)
        frac = min(max((step - warmup_iters)
                       / max(total_iters - warmup_iters, 1), 0.0), 1.0)
        return (base_lr - eta_min) * (1.0 - frac) ** power + eta_min

    return schedule


def param_label(name: str) -> str:
    """Optimizer group of a parameter name: ``backbone`` (lr x
    ``backbone_lr_mult``), ``embed`` (no weight decay) or ``default``."""
    if "backbone" in name:
        return "backbone"
    if any(k in name for k in ("query_embed", "query_feat", "level_embed")):
        return "embed"
    return "default"


def layerwise_decay_scale(name: str, decay_rate: float = 0.9,
                          num_layers: int = 12) -> float:
    """Layer-wise lr decay of one parameter (mmseg's
    LearningRateDecayOptimizerConstructor,
    layer_decay_optimizer_constructor.py:104-207): ``decay_rate **
    (num_layers - depth)``.  The depth is read from the name as the JAX
    package reads it from the flax path: ``block{stage}_{i}`` is
    ``min(2 * stage + i, num_layers)``, ``down{k}``/``conv{k}`` is ``k``,
    anything else (the head) ``num_layers``, no decay.  The port's names
    are the flax paths joined by ``.``, less the folded ``BatchNorm_0``,
    which neither pattern can match."""
    m = re.search(r"block(\d)_(\d+)", name)
    if m:
        depth = min(2 * int(m.group(1)) + int(m.group(2)), num_layers)
    else:
        m = re.search(r"(down|conv)(\d)_?", name)
        depth = int(m.group(2)) if m else num_layers
    return decay_rate ** (num_layers - depth)


class AdamW:
    """AdamW over named parameters, updated in place by ``step``.

    Reads each parameter's ``.grad`` (a parameter without one takes a zero
    gradient, as JAX differentiates every leaf).  ``state_dict`` holds
    the count and the moments by parameter name; ``load_state_dict``
    takes them back onto the parameters' device."""

    def __init__(self, named_params: Iterable[tuple[str, torch.Tensor]],
                 base_lr: float = 1e-3, weight_decay: float = 0.005,
                 backbone_lr_mult: float = 0.1, clip_norm: float = 0.01,
                 warmup_iters: int = 1500, total_iters: int = 160_000,
                 layer_decay_rate: float | None = None,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.schedule = poly_warmup_schedule(base_lr, warmup_iters,
                                             total_iters)
        self.clip_norm, self.b1, self.b2, self.eps = clip_norm, b1, b2, eps
        setting = {"backbone": (backbone_lr_mult, weight_decay),
                   "embed": (1.0, 0.0), "default": (1.0, weight_decay)}
        groups: dict[tuple[float, float], list[tuple[str, torch.Tensor]]] = {}
        for name, p in named_params:
            lr_mult, wd = setting[param_label(name)]
            if layer_decay_rate is not None:
                lr_mult *= layerwise_decay_scale(name, layer_decay_rate)
            groups.setdefault((lr_mult, wd), []).append((name, p))
        self.groups = [([p for _, p in members], lr_mult, wd)
                       for (lr_mult, wd), members in groups.items()]
        self.names = [n for members in groups.values() for n, _ in members]
        self.params = [p for params, _, _ in self.groups for p in params]
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Clip, update the moments and the parameters; returns the global
        norm of the gradients before clipping."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        norms = torch.stack(torch._foreach_norm(grads))
        split = [tp_sharded(p) for p in self.params]
        if any(split):
            sq = norms.square()
            mask = torch.tensor(split, device=sq.device)
            shards = torch.where(mask, sq, 0.0).sum()
            group = next(p.tp_group for p, s in zip(self.params, split) if s)
            dist.all_reduce(shards, group=group)
            norm = torch.sqrt(shards + torch.where(mask, 0.0, sq).sum())
        else:
            norm = torch.linalg.vector_norm(norms)
        scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-16),
                            max=1.0)
        grads = torch._foreach_mul(grads, scale)
        lr = self.schedule(self.count)
        self.count += 1
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
        bc1, bc2 = 1.0 - b1 ** self.count, 1.0 - b2 ** self.count
        i = 0
        for params, lr_mult, wd in self.groups:
            mu, nu = self.mu[i:i + len(params)], self.nu[i:i + len(params)]
            i += len(params)
            denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
            torch._foreach_add_(denom, self.eps)
            u = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
            if wd:
                torch._foreach_add_(u, params, alpha=wd)
            torch._foreach_add_(params, u, alpha=-lr * lr_mult)
        return norm

    def state_dict(self) -> dict:
        """The count and, by parameter name, the moments (the live
        tensors, not copies)."""
        return {"count": self.count,
                "mu": dict(zip(self.names, self.mu)),
                "nu": dict(zip(self.names, self.nu))}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy a ``state_dict`` (from any device) into the moments, which
        must have the same names and shapes."""
        for key in ("mu", "nu"):
            if set(state[key]) != set(self.names):
                raise KeyError(f"optimizer {key} names differ: "
                               f"{sorted(set(state[key]) ^ set(self.names))}")
            for name, t in zip(self.names, getattr(self, key)):
                t.copy_(state[key][name])
        self.count = int(state["count"])
