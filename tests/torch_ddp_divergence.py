"""Where a two-rank data-parallel forward first departs from the
one-process forward of the same global batch: the port's MaskFormer in
training mode, two gloo CPU processes of one row each against one
process taking both rows, every module's output recorded by a forward
hook.

    JAX_PLATFORMS=cpu python tests/torch_ddp_divergence.py [--widths mid]

``--widths tiny`` is ``test_torch_distributed.py``'s model, ``mid`` about
half the flagship's (embed (32, 64, 128, 192), 128 channels, 50 queries,
6 encoder and decoder layers), at 128x128 crops.  Prints the parameter
count and the training-mode BNs outside the frozen backbone (each runs 4
small collectives a step: two forward, two backward) of the flagship
(built, never run) and of the model run, then the first module whose
output differs by more than 1e-4, with the number of elements apart and
the largest difference of the module just before it.  Imports no JAX.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from spike2former_tpu_torch.data.synthetic import synthetic_batch  # noqa
from spike2former_tpu_torch.engine.config import (build_model,  # noqa
                                                  get_config)
from spike2former_tpu_torch.engine.train import init_trainer  # noqa: E402
from spike2former_tpu_torch.engine.weights import randomize_  # noqa: E402
from spike2former_tpu_torch.models.layers import (BatchNorm,  # noqa: E402
                                                  BNAndPad)
from spike2former_tpu_torch.models.segmentor import preprocess  # noqa
from spike2former_tpu_torch.parallel import (distributed_init,  # noqa
                                             free_port, global_batch,
                                             shard_batch, shutdown)

PRESET = "SDTv2_maskformer_DCNpixelDecoder_ade20k"
WIDTHS = {
    "tiny": ["model.num_classes=5", "model.embed_dim=(8,16,24,32)",
             "model.backbone_heads=4", "model.feat_channels=16",
             "model.num_queries=4", "model.num_decoder_layers=1",
             "model.num_encoder_layers=1", "model.depths_stage3=1",
             "model.depths_stage4=1", "model.dcn_group=4"],
    "mid": ["model.embed_dim=(32,64,128,192)", "model.feat_channels=128",
            "model.num_queries=50", "model.num_decoder_layers=6",
            "model.num_encoder_layers=6", "model.depths_stage3=2",
            "model.depths_stage4=1", "model.dcn_group=16"],
}
TOL = 1e-4


def outputs(widths: str, pid: int, pcount: int) -> dict[str, torch.Tensor]:
    """Every module's output (first call) of rank ``pid``'s rows of a
    seeded global batch of 2 at 128x128."""
    tr = init_trainer(PRESET, WIDTHS[widths], device="cpu")
    randomize_(tr.state.model, tr.cfg.train.seed)   # the tests' draw
    images, _ = synthetic_batch(np.random.default_rng(7), 2, (128, 128))
    images = shard_batch(images, pid, pcount)
    model, rec = tr.state.model.train(), {}

    def hook(name):
        def keep(module, args, out):
            if isinstance(out, torch.Tensor) and name not in rec:
                rec[name] = out.detach().clone()
        return keep

    for name, m in model.named_modules():
        m.register_forward_hook(hook(name))
    with global_batch(), torch.no_grad():
        model(preprocess(torch.from_numpy(images)))
    return rec


def join(parts: list[torch.Tensor], whole: torch.Tensor) -> torch.Tensor:
    """The ranks' outputs along the axis that holds the batch."""
    axis = 0 if whole.shape[0] == 2 * parts[0].shape[0] else 1
    return torch.cat(parts, axis)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--widths", choices=sorted(WIDTHS), default="mid")
    ap.add_argument("--rank", nargs=3, metavar=("COORD", "PID", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    torch.set_num_threads(2)
    if args.rank:
        coord, pid, out = args.rank
        distributed_init(coord, 2, int(pid), backend="gloo")
        try:
            torch.save(outputs(args.widths, int(pid), 2), out)
        finally:
            shutdown()
        return 0

    for name, opts in (("flagship", []),
                       (args.widths, WIDTHS[args.widths])):
        model = build_model(get_config(PRESET, opts).model)
        bns = [n for n, m in model.named_modules()
               if isinstance(m, (BatchNorm, BNAndPad))
               and not n.startswith("backbone.")]
        print(f"{name}: {sum(p.numel() for p in model.parameters())} "
              f"parameters, {len(bns)} training-mode BNs outside the "
              f"backbone")
    with tempfile.TemporaryDirectory() as tmp:
        coord = f"localhost:{free_port()}"
        outs = [os.path.join(tmp, f"rank{i}.pt") for i in (0, 1)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--widths",
             args.widths, "--rank", coord, str(i), outs[i]])
            for i in (0, 1)]
        if any(p.wait(timeout=1200) for p in procs):
            raise RuntimeError("a rank failed")
        ranks = [torch.load(o) for o in outs]
    single = outputs(args.widths, 0, 1)
    prev = None
    for name, whole in single.items():
        got = join([r[name] for r in ranks], whole)
        diff = (got.float() - whole.float()).abs()
        if float(diff.max()) > TOL:
            print(f"first module apart: {name} {tuple(whole.shape)}, "
                  f"{int((diff > TOL).sum())} of {diff.numel()} elements, "
                  f"max {float(diff.max()):.4g}; the module before it "
                  f"({prev[0]}) at most {prev[1]:.3g} apart")
            break
        prev = (name, float(diff.max()))
    else:
        print(f"every module's output within {TOL}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
