"""End-to-end learning checks of the port (the toy checks of
``tests/test_learning.py``): the full pipeline (the model, the matcher,
the losses, AdamW) must fit a trivial two-class segmentation task, with
the JAX tests' steps, optimizer settings and thresholds.

The tiny model is the JAX test's (``Spike2Former`` at its module
defaults: ``norm_eval=True``, ``lazy_masks=False``), its weights JAX's
own initialisation (``init_state``'s ``PRNGKey(0)``) carried over by
``engine/convert.py:from_jax_variables``, so both packages start from the
same point.  As in JAX, the accuracy is the best over a late window of
steps and the loss criterion averages the last 20 steps: toy runs
oscillate near convergence.  ``norm_eval``'s check
(``test_learning.py:128``) is ``test_torch_train.py::
test_norm_eval_keeps_backbone_bns_frozen``.

Each check takes about a minute on the CPU, so all are in the slow tier
(``--runslow``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spike2former_tpu.models import Spike2Former as JaxSpike2Former
from spike2former_tpu_torch.engine.convert import from_jax_variables
from spike2former_tpu_torch.engine.optim import AdamW
from spike2former_tpu_torch.engine.train import TrainState, make_train_step
from spike2former_tpu_torch.models.segmentor import Spike2Former

TINY = dict(num_classes=2, embed_dim=(8, 16, 24, 32), backbone_heads=4, T=1,
            feat_channels=16, num_queries=4, num_decoder_layers=1,
            num_encoder_layers=1, depths_stage3=1, depths_stage4=1,
            dcn_group=4)


def _toy_task(b=2, hw=32):
    # left half = class 0 & dark, right half = class 1 & bright
    images = np.zeros((b, hw, hw, 3), np.float32)
    images[:, :, hw // 2:] = 220.0
    images[:, :, : hw // 2] = 30.0
    sem = np.zeros((b, hw, hw), np.int32)
    sem[:, :, hw // 2:] = 1
    return torch.from_numpy(images), torch.from_numpy(sem)


def _tiny_model():
    """The port's tiny model holding the JAX test model's initial
    weights."""
    images, _ = _toy_task()
    jm = JaxSpike2Former(**TINY)
    variables = jax.jit(lambda x: jm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
        x, True))(jnp.asarray(images.numpy()))
    model = Spike2Former(**TINY)
    model.load_state_dict(from_jax_variables(
        jax.tree_util.tree_map(np.asarray, variables)), strict=True)
    return model


def _fit(matcher="auction", steps=300, eval_window=(220, 260, 300),
         **step_kw):
    """Train the tiny model on the toy task; returns (model, loss trace,
    best late-window pixel accuracy)."""
    model = _tiny_model()
    assert model.backbone.norm_eval  # the reference training recipe
    images, sem = _toy_task()
    state = TrainState(model, AdamW(model.named_parameters(), base_lr=2e-3,
                                    warmup_iters=10, total_iters=400,
                                    clip_norm=1.0))
    step = make_train_step(num_classes=2, max_gt=4, matcher=matcher,
                           **step_kw)

    def accuracy():
        model.eval()
        try:
            with torch.no_grad():
                logits = model.predict_logits((images - 127.5) / 58.0)
        finally:
            model.train()
        return float((logits.argmax(-1) == sem).float().mean())

    losses, best_acc = [], 0.0
    for i in range(steps):
        _, metrics = step(state, images, sem)
        losses.append(float(metrics["total"]))
        if (i + 1) in eval_window:
            best_acc = max(best_acc, accuracy())
    return model, losses, best_acc


@pytest.mark.slow
def test_overfits_two_class_task():
    """``test_learning.py:71``: loss down to 0.35 of its start, toy pixel
    accuracy >= 0.90, and bucketed eval (bottom-right pad to a 2x bucket
    with ``valid_hw``) agreeing with the exact shape on >= 0.95 of the
    valid region."""
    model, losses, acc = _fit("auction")
    assert np.isfinite(losses[-1])
    late = float(np.mean(losses[-20:]))
    assert late < losses[0] * 0.35, (losses[0], late)
    assert acc >= 0.90, f"toy pixel accuracy {acc}"

    images, sem = _toy_task()
    b, hw = sem.shape[0], sem.shape[1]
    model.eval()
    with torch.no_grad():
        logits = model.predict_logits((images - 127.5) / 58.0)
        padded = torch.nn.functional.pad(images, (0, 0, 0, hw, 0, hw))
        logits_b = model.predict_logits(
            (padded - 127.5) / 58.0, torch.tensor([[hw, hw]] * b))
    pred_exact = logits.argmax(-1)
    pred_bucket = logits_b.argmax(-1)[:, :hw, :hw]
    agree = float((pred_exact == pred_bucket).float().mean())
    assert agree >= 0.95, f"bucketed-eval agreement {agree}"


@pytest.mark.slow
def test_auction_vs_hungarian_training_equivalence():
    """``test_learning.py:101``: the on-device auction and the exact host
    Hungarian both train the toy task to >= 0.88, their last-20 losses
    within 25% of each other."""
    _, loss_a, acc_a = _fit("auction", steps=220,
                            eval_window=(160, 190, 220))
    _, loss_h, acc_h = _fit("host", steps=220, eval_window=(160, 190, 220))
    assert acc_a >= 0.88, acc_a
    assert acc_h >= 0.88, acc_h
    la, lh = float(np.mean(loss_a[-20:])), float(np.mean(loss_h[-20:]))
    assert abs(la - lh) / max(lh, 1e-6) < 0.25, (la, lh)


@pytest.mark.slow
def test_point_sampled_losses_learn():
    """``test_learning.py:117``: the point-sampled recipe
    (``train.loss_points``, 128 points) fits the toy task, loss below half
    its start and accuracy >= 0.85."""
    _, losses, acc = _fit("auction", steps=220, eval_window=(160, 190, 220),
                          num_points=128, seed=0)
    late = float(np.mean(losses[-20:]))
    assert late < losses[0] * 0.5, (losses[0], late)
    assert acc >= 0.85, f"point-loss toy accuracy {acc}"
