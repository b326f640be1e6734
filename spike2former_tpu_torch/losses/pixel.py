"""Per-pixel segmentation losses of the FPN heads (port of
``spike2former_tpu/losses/pixel.py``; reference mmseg decode_head.py
:292-340 and the mmseg loss zoo: accuracy, lovasz, tversky, boundary,
ohem cross-entropy, Hausdorff distance).

Logits ``[B, h, w, C]`` at any resolution are resized bilinearly to the
label map ``[B, H, W]`` (255 = ignore) first.  As in the JAX package,
ignored pixels are masked rather than removed, so every shape is static:
they contribute exactly zero to each reduction.  The Lovász losses sort
their errors with a stable sort (JAX's ``argsort``), so tied errors keep
the pixel order and the subgradient is JAX's.  ``jnp.abs`` has slope +1
at 0 where ``torch.abs`` has 0: the losses that differentiate an
absolute value take JAX's slope (``_abs``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.resize import resize_bilinear


def _abs(x: torch.Tensor) -> torch.Tensor:
    """``|x|`` with JAX's derivative at 0 (+1)."""
    return torch.where(x >= 0, x, -x)


def _to_labels(logits: torch.Tensor, sem_seg: torch.Tensor) -> torch.Tensor:
    """``logits`` in float32 at the label map's resolution."""
    if tuple(logits.shape[1:3]) != tuple(sem_seg.shape[1:3]):
        logits = resize_bilinear(logits, tuple(sem_seg.shape[1:3]))
    return logits.float()


def pixel_cross_entropy(logits: torch.Tensor, sem_seg: torch.Tensor,
                        ignore_index: int = 255) -> torch.Tensor:
    """Softmax CE averaged over the valid pixels."""
    logits = _to_labels(logits, sem_seg)
    valid = sem_seg != ignore_index
    labels = torch.where(valid, sem_seg, 0).long()
    logp = torch.log_softmax(logits, -1)
    nll = -logp.gather(-1, labels[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum() / valid.sum().clamp(min=1)


def pixel_accuracy(logits: torch.Tensor, sem_seg: torch.Tensor,
                   ignore_index: int = 255) -> torch.Tensor:
    """The share of valid pixels whose argmax class is the label's."""
    logits = _to_labels(logits, sem_seg)
    valid = sem_seg != ignore_index
    correct = (logits.argmax(-1) == sem_seg) & valid
    return correct.sum() / valid.sum().clamp(min=1)


# --- Lovász losses (mmseg/models/losses/lovasz_loss.py) ----------------------

def _lovasz_grad(gt_sorted: torch.Tensor) -> torch.Tensor:
    """Gradient of the Lovász extension with respect to the errors sorted
    in descending order; ``gt_sorted`` [..., P] the 0/1 foreground in that
    order."""
    gts = gt_sorted.sum(-1, keepdim=True)
    intersection = gts - gt_sorted.cumsum(-1)
    union = gts + (1.0 - gt_sorted).cumsum(-1)
    jaccard = 1.0 - intersection / union.clamp(min=1e-12)
    return torch.cat([jaccard[..., :1], jaccard[..., 1:] - jaccard[..., :-1]],
                     -1)


def _sorted_desc(values: torch.Tensor, *others: torch.Tensor):
    """``values`` and ``others`` gathered in the order of a stable
    descending sort of ``values`` along the last axis."""
    order = torch.sort(-values.detach(), dim=-1, stable=True).indices
    return [t.gather(-1, order) for t in (values, *others)]


def _lovasz_softmax_flat(probs: torch.Tensor, labels: torch.Tensor,
                         valid: torch.Tensor, classes: str = "present",
                         class_weight=None) -> torch.Tensor:
    """probs [P, C] softmax, labels [P] int, valid [P] bool."""
    num_classes = probs.shape[-1]
    vf = valid[None, :].to(probs.dtype)
    fg = F.one_hot(labels, num_classes).T.to(probs.dtype) * vf     # [C, P]
    errors = _abs(fg - probs.T) * vf          # ignored pixels: exactly 0
    errors_sorted, fg_sorted = _sorted_desc(errors, fg)
    per_class = (errors_sorted * _lovasz_grad(fg_sorted)).sum(-1)
    if class_weight is not None:
        per_class = per_class * torch.as_tensor(
            class_weight, dtype=per_class.dtype, device=per_class.device)
    if classes == "present":
        present = fg.sum(-1) > 0
        return (torch.where(present, per_class, torch.zeros_like(per_class))
                .sum() / present.sum().clamp(min=1))
    return per_class.mean()


def lovasz_softmax_loss(logits: torch.Tensor, sem_seg: torch.Tensor,
                        classes: str = "present", per_image: bool = False,
                        class_weight=None,
                        ignore_index: int = 255) -> torch.Tensor:
    """Multi-class Lovász-Softmax (lovasz_loss.py:129-170): over the
    whole batch, or the mean of each image's; classes averaged over those
    present (``'present'``) or all."""
    probs = torch.softmax(_to_labels(logits, sem_seg), -1)
    valid = sem_seg != ignore_index
    labels = torch.where(valid, sem_seg, 0).long()
    c = probs.shape[-1]
    if per_image:
        return torch.stack([
            _lovasz_softmax_flat(p.reshape(-1, c), lb.reshape(-1),
                                 v.reshape(-1), classes, class_weight)
            for p, lb, v in zip(probs, labels, valid)]).mean()
    return _lovasz_softmax_flat(probs.reshape(-1, c), labels.reshape(-1),
                                valid.reshape(-1), classes, class_weight)


def lovasz_hinge_loss(logits: torch.Tensor, labels: torch.Tensor,
                      per_image: bool = False,
                      ignore_index: int = 255) -> torch.Tensor:
    """Binary Lovász hinge (lovasz_loss.py:61-127): logits [B, H, W],
    labels [B, H, W] in {0, 1} (or ``ignore_index``); ignored pixels take
    an error of -1e9, which sorts last and ``relu`` zeroes."""
    valid = labels != ignore_index

    def flat(lg, lb, v):
        lb = torch.where(v, lb, 0).float()
        signs = 2.0 * lb - 1.0
        errors = torch.where(v, 1.0 - lg.float() * signs,
                             torch.full_like(signs, -1e9))
        errors_sorted, gt_sorted = _sorted_desc(errors, lb * v.float())
        return (torch.relu(errors_sorted) * _lovasz_grad(gt_sorted)).sum()

    if per_image:
        return torch.stack([flat(lg.reshape(-1), lb.reshape(-1),
                                 v.reshape(-1))
                            for lg, lb, v in zip(logits, labels, valid)]
                           ).mean()
    return flat(logits.reshape(-1), labels.reshape(-1), valid.reshape(-1))


# --- Tversky, boundary and OHEM losses ---------------------------------------

def tversky_loss(logits: torch.Tensor, sem_seg: torch.Tensor,
                 alpha: float = 0.3, beta: float = 0.7, smooth: float = 1.0,
                 class_weight=None, ignore_index: int = 255) -> torch.Tensor:
    """Per class ``1 - (TP + s) / (TP + a FP + b FN + s)`` over the valid
    pixels, summed over classes / C, averaged over the batch
    (tversky_loss.py:14-57, :100-121)."""
    logits = _to_labels(logits, sem_seg)
    b, c = logits.shape[0], logits.shape[-1]
    pred = torch.softmax(logits, -1).reshape(b, -1, c)
    onehot = F.one_hot(sem_seg.long().clamp(0, c - 1), c).reshape(
        b, -1, c).float()
    valid = (sem_seg != ignore_index).reshape(b, -1, 1).float()
    tp = (pred * onehot * valid).sum(1)
    fp = (pred * (1.0 - onehot) * valid).sum(1)
    fn = ((1.0 - pred) * onehot * valid).sum(1)
    per_class = 1.0 - (tp + smooth) / (tp + alpha * fp + beta * fn + smooth)
    if class_weight is not None:
        per_class = per_class * torch.as_tensor(
            class_weight, dtype=per_class.dtype, device=per_class.device)
    return (per_class.sum(-1) / c).mean()


def boundary_loss(bd_logits: torch.Tensor, bd_gt: torch.Tensor
                  ) -> torch.Tensor:
    """Class-balanced BCE-with-logits on a binary boundary map
    (boundary_loss.py:33-58): positives weighted by the negative share and
    the reverse, the mean over every pixel."""
    logit = bd_logits.reshape(-1).float()
    target = bd_gt.reshape(-1).float()
    pos, neg = target == 1.0, target == 0.0
    pos_num, neg_num = pos.sum(), neg.sum()
    total = (pos_num + neg_num).clamp(min=1)
    zero = torch.zeros_like(logit)
    weight = torch.where(pos, neg_num / total,
                         torch.where(neg, pos_num / total, zero))
    bce = (torch.relu(logit) - logit * target
           + torch.log1p(torch.exp(-_abs(logit))))
    return (weight * bce).mean()


def ohem_cross_entropy(logits: torch.Tensor, sem_seg: torch.Tensor,
                       thresh: float = 0.7, min_kept: int = 100000,
                       class_weight=None,
                       ignore_index: int = 255) -> torch.Tensor:
    """OHEM CE (ohem_cross_entropy_loss.py:53-95): the mean CE of the
    valid pixels whose label probability is below ``max(thresh, the
    min(min_kept, n_valid - 1)-th smallest label probability)``; ignored
    pixels take a probability of +inf, so they sort last."""
    logits = _to_labels(logits, sem_seg)
    c = logits.shape[-1]
    valid = (sem_seg != ignore_index).reshape(-1)
    labels = torch.where(valid, sem_seg.reshape(-1), 0).long()
    flat = logits.reshape(-1, c)
    nll = -torch.log_softmax(flat, -1).gather(-1, labels[:, None])[:, 0]
    if class_weight is not None:
        nll = nll * torch.as_tensor(class_weight, dtype=torch.float32,
                                    device=nll.device)[labels]
    with torch.no_grad():
        gt_prob = torch.softmax(flat, -1).gather(-1, labels[:, None])[:, 0]
        gt_prob = torch.where(valid, gt_prob,
                              torch.full_like(gt_prob, float("inf")))
        kth = (valid.sum() - 1).clamp(min=0).clamp(max=min_kept)
        threshold = torch.sort(gt_prob).values[kth].clamp(min=thresh)
        keep = valid & (gt_prob < threshold)
    return (torch.where(keep, nll, torch.zeros_like(nll)).sum()
            / keep.sum().clamp(min=1))


# --- Hausdorff distance loss (huasdorff_distance_loss.py) --------------------

def edt_sq(mask: torch.Tensor, chunk: int = 128) -> torch.Tensor:
    """Exact squared Euclidean distance transform of ``mask`` [..., H, W]
    (nonzero = foreground): per pixel the squared distance to the nearest
    zero pixel, 0 on the background; with no background in reach the
    value saturates (1e12), as JAX's does.

    JAX's two scans along H become a running max and a reversed running
    min of row indices (every value an integer below 2**24, so exact in
    float32): the distance in rows to the background above, then the
    smaller of it and the distance to the background below.  The
    horizontal pass is JAX's: ``D^2[i, j] = min_j' ((j - j')^2 + g[i,
    j']^2)`` over column chunks of ``chunk`` (a [..., H, W, chunk]
    temporary each)."""
    h, w = mask.shape[-2], mask.shape[-1]
    fg = mask != 0
    big = 1e12
    rows = torch.arange(h, dtype=torch.float32, device=mask.device)
    rows = rows.view(h, 1).expand(mask.shape)
    last_bg = torch.where(fg, torch.full_like(rows, -1e6 - 1.0), rows)
    gd = rows - torch.cummax(last_bg, -2).values
    next_bg = torch.where(fg, torch.full_like(rows, 1e6 + h), rows)
    next_bg = torch.flip(torch.cummin(torch.flip(next_bg, (-2,)), -2).values,
                         (-2,))
    g = torch.where(fg, torch.minimum(gd, next_bg - rows),
                    torch.zeros_like(gd))
    g2 = torch.clamp(g * g, max=big)
    cols = torch.arange(w, dtype=torch.float32, device=mask.device)
    out = torch.full_like(g2, big)
    for start in range(0, w, chunk):
        stop = min(start + chunk, w)
        dist2 = (cols[:, None] - cols[None, start:stop]) ** 2
        cand = g2[..., None, start:stop] + dist2
        out = torch.minimum(out, cand.min(-1).values)
    return out


def hausdorff_distance_loss(logits: torch.Tensor, sem_seg: torch.Tensor,
                            class_weight=None,
                            ignore_index: int = 255) -> torch.Tensor:
    """huasdorff_distance_loss.py:40-156 as the JAX package computes it:
    softmax, the label map zeroed at ignored pixels, the foreground
    distance maps of that map and of the argmax prediction (no gradient),
    and per class c >= 1 ``mean((p_c - label)^2 * (dtm_gt^2 +
    dtm_seg^2))``, summed / C."""
    soft = torch.softmax(_to_labels(logits, sem_seg), -1)
    c = soft.shape[-1]
    target = torch.where(sem_seg != ignore_index, sem_seg, 0)
    with torch.no_grad():
        dtm = edt_sq(target) + edt_sq(soft.argmax(-1))
    delta = (soft[..., 1:] - target.float()[..., None]) ** 2
    per_class = (delta * dtm[..., None]).mean((0, 1, 2))
    if class_weight is not None:
        per_class = per_class * torch.as_tensor(
            class_weight, dtype=per_class.dtype,
            device=per_class.device)[1:]
    return per_class.sum() / c


# --- the decode loss registry (decode_head.py:115-128) ------------------------

PIXEL_LOSSES = {
    "ce": pixel_cross_entropy,
    "lovasz": lovasz_softmax_loss,
    "tversky": tversky_loss,
    "ohem": ohem_cross_entropy,
    "hausdorff": hausdorff_distance_loss,
    # 'boundary' takes a binary boundary map, not a class map: a loss of a
    # separate head, not of a decode spec
}


def build_pixel_loss(spec):
    """``spec``: a sequence of ``(name, weight[, kwargs])``.  Returns
    ``fn(logits, sem_seg) -> (total, {loss_<name>: value})``."""
    parsed = []
    for item in spec:
        name, weight = item[0], float(item[1])
        kwargs = dict(item[2]) if len(item) > 2 else {}
        if name not in PIXEL_LOSSES:
            raise KeyError(
                f"unknown pixel loss {name!r}; have {sorted(PIXEL_LOSSES)}")
        parsed.append((name, weight, kwargs))

    def loss_fn(logits, sem_seg):
        total = torch.zeros((), device=logits.device)
        metrics = {}
        for name, weight, kwargs in parsed:
            value = PIXEL_LOSSES[name](logits, sem_seg, **kwargs)
            metrics[f"loss_{name}"] = value
            total = total + weight * value
        return total, metrics

    return loss_fn
