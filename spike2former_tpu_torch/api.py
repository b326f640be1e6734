"""Inference API (port of ``spike2former_tpu/api.py``: ``init_model``,
``inference_model``, the batch ``Inferencer``) and the training entry
points ``init_trainer`` / ``train_steps`` (``engine/train.py``).

Runs on the card unless ``device="cpu"`` is passed; with no card and no
device asked for, ``init_model`` and ``init_trainer`` raise.
``inference_model`` and ``train_steps`` compute in ``model.dtype``
(float32, or bfloat16 with the float32 parts that flax keeps), and
what is float32 runs in full float32 whatever the caller's TF32 flags
(``device.f32_precision``), which they leave as they found them.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
from PIL import Image

from .data.metainfo import DATASETS
from .data.transforms import load_image, test_pipeline
from .device import f32_precision, resolve_device
from .engine.checkpoint import restore_variables
from .engine.config import Config, build_model, get_config
from .engine.inference import postprocess_pred, whole_logits
from .engine.train import init_trainer, train_steps  # noqa: F401
from .engine.weights import init_weights_
from .evaluation.visualize import draw_sem_seg


@dataclass
class InferenceModel:
    cfg: Config
    model: torch.nn.Module
    device: torch.device

    @property
    def num_classes(self) -> int:
        return self.cfg.model.num_classes

    @property
    def classes(self) -> tuple:
        return DATASETS[self.cfg.data.dataset].classes


def init_model(config: str | Config, checkpoint: str | None = None,
               overrides: list[str] | None = None,
               device: str | torch.device | None = None,
               seed: int = 0,
               state_dict: dict[str, torch.Tensor] | None = None
               ) -> InferenceModel:
    """Build a model from a preset (or Config) on ``device``.  Weights come
    from ``checkpoint`` (a train checkpoint of the train CLI or a state
    dict saved by ``torch.save``, ``engine.checkpoint.restore_variables``)
    or from ``state_dict`` (e.g. ``engine.convert.from_jax_variables``),
    loaded strictly, or else are JAX's ``model.init`` variables of
    ``PRNGKey(seed)`` (``engine/weights.py:init_weights_``, drawn on
    ``device``; JAX's ``init_model`` draws from ``PRNGKey(0)``)."""
    if checkpoint is not None and state_dict is not None:
        raise ValueError("pass checkpoint or state_dict, not both")
    dev = resolve_device(device)
    cfg = get_config(config, overrides) if isinstance(config, str) else config
    model = build_model(cfg.model).to(dev)
    if checkpoint is not None:
        state_dict = restore_variables(checkpoint)
    if state_dict is None:
        init_weights_(model, seed)
    else:
        model.load_state_dict(state_dict, strict=True)
    return InferenceModel(cfg, model.eval(), dev)


def resize_and_pad(cfg: Config, img: np.ndarray
                   ) -> tuple[np.ndarray, tuple[int, int]]:
    """The eval transform of one RGB image: resize keeping the ratio to
    ``cfg.data.test_scale``, then pad to a multiple of
    ``cfg.data.size_divisor``.  Returns the padded [H, W, 3] image and the
    resized (h, w) inside it."""
    sample = test_pipeline({"image": img, "sem_seg": None, "meta": {}},
                           cfg.data.test_scale,
                           size_divisor=cfg.data.size_divisor)
    return sample["image"], sample["meta"]["img_shape"]


def inference_model(im: InferenceModel, image: str | np.ndarray
                    ) -> np.ndarray:
    """Whole-image inference on one image (path or RGB array): the class
    map at the original resolution, [H, W] int32."""
    img = load_image(image) if isinstance(image, str) else image
    padded, hw = resize_and_pad(im.cfg, img)
    x = torch.from_numpy(padded[None]).to(im.device)
    with f32_precision():
        logits = whole_logits(im.model, x)
        pred = postprocess_pred(logits, hw, img.shape[:2])
    return pred[0].cpu().numpy()


class Inferencer:
    """Batch inference (the JAX package's ``Inferencer``, mmseg's
    MMSegInferencer): one image or a list of them, as paths or RGB arrays,
    through ``inference_model``; with ``out_dir``, each prediction's
    palette overlay on its image goes to ``{out_dir}/{name}_pred.png``
    (``name`` the file's stem, or ``img_{i}`` for an array).  The
    arguments are ``init_model``'s: the card unless ``device="cpu"``."""

    def __init__(self, config: str | Config, checkpoint: str | None = None,
                 overrides: list[str] | None = None,
                 device: str | torch.device | None = None, seed: int = 0,
                 state_dict: dict[str, torch.Tensor] | None = None):
        self.im = init_model(config, checkpoint, overrides, device=device,
                             seed=seed, state_dict=state_dict)

    @property
    def classes(self) -> tuple:
        return self.im.classes

    def __call__(self, inputs, out_dir: str | None = None,
                 opacity: float = 0.5) -> dict:
        """Returns ``{'predictions': [[H, W] int32, ...],
        'visualization': [path, ...]}`` (no paths without ``out_dir``)."""
        items = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
        meta = DATASETS[self.im.cfg.data.dataset]
        palette = (np.asarray(meta.palette, np.uint8)
                   if meta.palette is not None else None)
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
        preds, paths = [], []
        for i, item in enumerate(items):
            img = load_image(item) if isinstance(item, str) else item
            pred = inference_model(self.im, img)
            preds.append(pred)
            if out_dir:
                name = (os.path.splitext(os.path.basename(item))[0]
                        if isinstance(item, str) else f"img_{i}")
                path = os.path.join(out_dir, f"{name}_pred.png")
                Image.fromarray(draw_sem_seg(img.astype(np.uint8), pred,
                                             palette=palette,
                                             alpha=opacity)).save(path)
                paths.append(path)
        return {"predictions": preds, "visualization": paths}
