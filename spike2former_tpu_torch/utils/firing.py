"""Firing-rate analysis (port of ``spike2former_tpu/utils/firing.py``):
per-site spike statistics of one forward, their average over an image
stream, and the mean over sites.

Every ``Spike`` site reports ``{path}/rate`` (``mean(y) * D``) and
``{path}/nonfire`` (``mean(y == 0)``) under the JAX package's flax path
names (``models/layers.py:observe_spikes``).  As in the JAX package, the
dict that ``firing_rates`` returns holds both kinds of keys, and
``energy_proxy`` averages over all of them.
"""
from __future__ import annotations

from typing import Iterable

import numpy as np
import torch
from torch import nn

from ..models.layers import observe_spikes


@torch.no_grad()
def firing_rates(model: nn.Module, images: torch.Tensor) -> dict[str, float]:
    """One forward of ``model`` (in its current train/eval mode) on
    normalized ``images`` [B, H, W, 3]; returns ``{site/rate: ...,
    site/nonfire: ...}`` as floats, in call order."""
    with observe_spikes(model) as stats:
        model(images)
    if not stats:
        return {}
    values = torch.stack(list(stats.values())).tolist()  # one host read
    return dict(zip(stats, values))


def accumulate_firing(model: nn.Module, image_iter: Iterable[torch.Tensor],
                      max_images: int = 200) -> dict[str, float]:
    """Per-site statistics averaged over the first ``max_images`` batches
    of ``image_iter`` (tools/cal_firing_num.py's mean over 200 val
    images)."""
    totals: dict[str, float] = {}
    n = 0
    for images in image_iter:
        for k, v in firing_rates(model, images).items():
            totals[k] = totals.get(k, 0.0) + v
        n += 1
        if n >= max_images:
            break
    return {k: v / max(n, 1) for k, v in totals.items()}


def energy_proxy(rates: dict[str, float]) -> float:
    """The mean of ``rates``' values: the spike-count energy proxy's
    aggregate.  Over a ``firing_rates`` dict that mean takes in the
    ``nonfire`` fractions as well, as the JAX package's does."""
    if not rates:
        return 0.0
    return float(np.mean(list(rates.values())))
