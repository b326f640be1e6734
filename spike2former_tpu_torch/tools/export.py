"""Deployment export (the port's counterpart of the JAX package's
``tools/export.py``, which writes StableHLO; mmseg's
pytorch2torchscript.py): ``torch.export.export`` of ``predict_logits`` at
``--batch-size`` x ``data.crop_size`` normalized images, saved with
``torch.export.save`` to ``--out`` and the graph's text to ``--out.txt``.

    python -m spike2former_tpu_torch.tools.export CONFIG \\
        [--checkpoint CKPT] [--out model.pt2] [--batch-size B] \\
        [--cfg-options KEY=VALUE ...] [--device cpu]

On the card each DCN layer's sampler is one call of the operator
``torch.ops.spike2former.dcnv3_sample`` (K1) in the graph; on the CPU it
is the plain version's operations.  Load with ``torch.export.load(out)
.module()`` on the same kind of device.  Runs on the card unless
``--device cpu``.
"""
from __future__ import annotations

import argparse
import os
import sys

import torch
from torch import nn

from ..api import init_model
from ..engine.config import get_config
from ..ops.dcnv3 import dcnv3_sample_op


class PredictLogits(nn.Module):
    """``model.predict_logits`` as a module's forward, for export."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.model.predict_logits(images)


def export_model(model: nn.Module, images: torch.Tensor
                 ) -> torch.export.ExportedProgram:
    """The exported program of ``model.predict_logits(images)``."""
    with torch.no_grad():
        return torch.export.export(PredictLogits(model).eval(), (images,))


def sampler_calls(program: torch.export.ExportedProgram) -> int:
    """Calls of K1's operator in ``program``'s graph."""
    return sum(1 for n in program.graph.nodes
               if n.op == "call_function"
               and n.target == dcnv3_sample_op._opoverload)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--out", default="model.pt2")
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--cfg-options", nargs="*", default=[])
    ap.add_argument("--device", default=None,
                    help="torch device; the card when left out")
    args = ap.parse_args(argv)

    cfg = get_config(args.config, args.cfg_options)
    im = init_model(cfg, args.checkpoint, device=args.device)
    x = torch.zeros((args.batch_size, *cfg.data.crop_size, 3),
                    device=im.device)
    program = export_model(im.model, x)
    torch.export.save(program, args.out)
    with open(args.out + ".txt", "w") as f:
        f.write(str(program.graph_module.code))
    print(f"exported {cfg.name} -> {args.out} "
          f"({os.path.getsize(args.out) / 1e6:.1f} MB, input "
          f"{tuple(x.shape)}, {sampler_calls(program)} calls of "
          f"spike2former::dcnv3_sample)")
    print(f"graph text -> {args.out}.txt")
    return 0


if __name__ == "__main__":
    sys.exit(main())
