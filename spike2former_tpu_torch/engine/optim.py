"""AdamW with the reference recipe's parameter groups, global-norm
clipping and warmup-poly schedule (port of
``spike2former_tpu/engine/optim.py``: ``poly_warmup_schedule``,
``_param_labels``, ``_flat_adamw``).

Recipe (configs/Spike2Former/SDTv2_maskformer_DCNpixelDecoder_ade20k.py
:138-167): AdamW(lr 1e-3, betas (0.9, 0.999), weight decay 0.005), clip at
global norm 0.01, linear warmup from 1e-6 x over 1500 iterations then poly
(power 1) to 160k; backbone lr x0.1, query/level embeddings without weight
decay.  The update is the JAX package's own arithmetic:

* clip factor ``min(1, clip / max(|g|, 1e-16))`` (not
  ``clip_grad_norm_``'s ``clip / (|g| + 1e-6)``);
* the schedule is read at the count before the increment, so step 0 runs
  at ``base_lr * 1e-6``;
* decoupled decay ``u + wd * p``, the sum scaled by ``-lr * lr_mult``.

Moments are updated with ``torch._foreach_*`` ops, a few launches per
group rather than per parameter.
"""
from __future__ import annotations

from typing import Callable, Iterable

import torch


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


class AdamW:
    """AdamW over named parameters, updated in place by ``step``.

    Reads each parameter's ``.grad`` (a parameter without one takes a zero
    gradient, as JAX differentiates every leaf); ``state_dict`` holds the
    count and the moments."""

    def __init__(self, named_params: Iterable[tuple[str, torch.Tensor]],
                 base_lr: float = 1e-3, weight_decay: float = 0.005,
                 backbone_lr_mult: float = 0.1, clip_norm: float = 0.01,
                 warmup_iters: int = 1500, total_iters: int = 160_000,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.schedule = poly_warmup_schedule(base_lr, warmup_iters,
                                             total_iters)
        self.clip_norm, self.b1, self.b2, self.eps = clip_norm, b1, b2, eps
        groups: dict[str, list[torch.Tensor]] = {}
        for name, p in named_params:
            groups.setdefault(param_label(name), []).append(p)
        setting = {"backbone": (backbone_lr_mult, weight_decay),
                   "embed": (1.0, 0.0), "default": (1.0, weight_decay)}
        self.groups = [(params, *setting[label])
                       for label, params in groups.items()]
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
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
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
        return {"count": self.count, "mu": self.mu, "nu": self.nu}
