"""``model.remat``: each backbone block and DCN encoder layer recomputed in
the backward (``layers.remat``, ``torch.utils.checkpoint``) changes no
number, and BN running statistics move once per step, not again in the
recomputation (flax's ``nn.remat`` keeps one update)."""
import numpy as np
import pytest
import torch

from spike2former_tpu_torch import api
from spike2former_tpu_torch.data.synthetic import synthetic_batch
from spike2former_tpu_torch.models import layers as tl
from spike2former_tpu_torch.ops import dcnv3

PRESET = "SDTv2_maskformer_DCNpixelDecoder_ade20k"
TINY = dict(num_classes=5, embed_dim=(8, 16, 24, 32), backbone_heads=4,
            feat_channels=16, num_queries=4, num_decoder_layers=1,
            num_encoder_layers=2, depths_stage3=1, depths_stage4=1,
            dcn_group=4)


def _trainer(remat, dtype="float32", norm_eval=True):
    opts = [f"model.{k}={v!r}".replace(" ", "") for k, v in TINY.items()]
    opts += ["train.warmup_iters=1", f"model.remat={remat}",
             f"model.dtype='{dtype}'", f"model.norm_eval={norm_eval}"]
    return api.init_trainer(PRESET, opts, device="cpu", seed=1)


def _step(tr):
    batch = synthetic_batch(np.random.default_rng(2), 2, (64, 64),
                            num_classes=4)
    metrics = api.train_steps(tr, [batch])[0]
    model = tr.state.model
    return (metrics, {k: p.grad.clone() for k, p in model.named_parameters()},
            {k: v.clone() for k, v in model.state_dict().items()})


@pytest.mark.parametrize("norm_eval", [True, False])
def test_remat_changes_no_number_of_a_train_step(norm_eval):
    """f32: metrics, gradients and parameters and BN statistics after one
    step bit-identical with ``remat`` on and off (with ``norm_eval`` off
    the backbone's BNs train too, inside the recomputed blocks)."""
    m0, g0, s0 = _step(_trainer(False, norm_eval=norm_eval))
    tr = _trainer(True, norm_eval=norm_eval)
    assert tr.state.model.backbone.remat
    m1, g1, s1 = _step(tr)
    assert m0 == m1
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k


def test_running_statistics_move_once_under_remat():
    """Under ``remat`` a DCN encoder layer's BN statistics move once:
    ``0.9 * before + 0.1 * batch``, as without it, and the recomputation
    launches the sampler's forward again (the kernel on the card: K1
    counts twice per DCN layer in a step)."""
    tr = _trainer(True)
    model = tr.state.model
    bn = model.head.pixel_decoder.encoder_0.dcn.dw_bn
    before = bn.mean.clone()
    seen = []
    calls = []
    real = dcnv3.dcnv3_sample

    class Spy:
        def __call__(self, *a):
            calls.append(torch.is_grad_enabled())
            return real(*a)

    orig_update = tl._update_running

    def spy_update(ra, batch):
        if ra is bn.mean:
            seen.append(batch.clone())
        orig_update(ra, batch)

    tl._update_running = spy_update
    dcnv3.dcnv3_sample = Spy()
    try:
        _step(tr)
    finally:
        tl._update_running = orig_update
        dcnv3.dcnv3_sample = real
    # the forward and the recomputation both reach the update; the
    # recomputation's is dropped
    assert len(seen) == 2 and torch.equal(seen[0], seen[1])
    torch.testing.assert_close(bn.mean, 0.9 * before + 0.1 * seen[0],
                               rtol=0, atol=0)
    # two DCN layers, each sampled in the forward and again in the backward
    assert len(calls) == 2 * TINY["num_encoder_layers"]


def test_remat_is_a_plain_call_without_gradients():
    tr = _trainer(True)
    model = tr.state.model.eval()
    x = torch.randn(1, 64, 64, 3)
    with torch.no_grad():
        a = model.predict_logits(x)
    model.backbone.remat = model.head.pixel_decoder.remat = False
    with torch.no_grad():
        b = model.predict_logits(x)
    assert torch.equal(a, b)


def test_remat_and_packed_residuals_at_bf16():
    """bf16: the two knobs together change no metric of a step."""
    m0, _, s0 = _step(_trainer(False, "bfloat16"))
    opts_tr = _trainer(True, "bfloat16")
    tl.set_packed_residuals(opts_tr.state.model, True)
    m1, _, s1 = _step(opts_tr)
    assert m0 == m1
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k
