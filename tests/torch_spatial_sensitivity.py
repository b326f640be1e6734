"""How far a full-width model's f32 logits move under another summation
order, beside how far row bands move them: the cascade preset
(``cascade_fpn_sdtv2_512x512_ade20k``, random weights from seed 0 as
``chip_smoke.py`` builds it) on ``chip_smoke``'s 512x512 image, in one
process with cuDNN on, with cuDNN off and in bf16, and in two row bands
of two gloo ranks sharing the card (``chip_smoke``'s (spatial families)
regime) in each of the three.

    python tests/torch_spatial_sensitivity.py

Needs the card.  Prints, for each form, one process against its own
rerun (bitwise), against the other forms, and each rank against it: the
largest difference, the share of the logits within 1e-3 and the share of
the pixels whose class agrees.  Imports no JAX.
"""
from __future__ import annotations

import os
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402

# the ranks are this script again, as ``--par-worker``
cs.__file__ = os.path.abspath(__file__)
CASCADE = "cascade_fpn_sdtv2_512x512_ade20k"


def forms(mesh_of) -> dict:
    """The cascade's logits in each form, over ``mesh_of(1)``'s bands."""
    img = cs.fam_images()[cs.FAM_HW]
    out = {}
    for tag, opts, cudnn in (("f32", [], True), ("f32 cuDNN off", [], False),
                             ("bf16", cs.BF16_OPTS, True)):
        torch.backends.cudnn.enabled = cudnn
        im = cs.drawn_model(CASCADE, overrides=opts, seed=0)
        out[tag] = cs.par_forward(im.model, img, mesh_of(1))["logits"]
        del im
    torch.backends.cudnn.enabled = True
    return out


cs.PAR_SETS["sensitivity"] = forms


def gap(a: torch.Tensor, b: torch.Tensor) -> str:
    d = (a.float() - b.float()).abs()
    agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    return (f"max {d.max().item():.4g}, within 1e-3 "
            f"{(d <= 1e-3).float().mean().item():.6f}, classes {agree:.6f}")


def main() -> int:
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = cs.par_launch("sensitivity", 2, tmp)
    one, again = forms(lambda _: None), forms(lambda _: None)
    for tag, want in one.items():
        print(f"{CASCADE} {tag}: one process against its rerun "
              f"{gap(again[tag], want)}")
        for other, got in one.items():
            if other != tag:
                print(f"  one process {other}: {gap(got, want)}")
        for i, r in enumerate(ranks):
            print(f"  rank {i} of 2 row bands: {gap(r[tag], want)}")
    print(f"took {time.perf_counter() - t:.1f}s")
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--par-worker"]:
        sys.exit(cs.par_worker(sys.argv[2:]))
    sys.exit(main())
