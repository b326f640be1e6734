"""Publish a train checkpoint (the port's counterpart of the JAX package's
``tools/publish_model.py``; mmseg's tools/misc/publish_model.py): keep
the model's state dict (parameters and BN statistics), drop the
optimizer state and the step, and save it as ``OUT-{sha256[:8]}.pth``,
the hash taken over the tensors' bytes in key order.

    python -m spike2former_tpu_torch.tools.publish_model CONFIG CKPT OUT \\
        [--cfg-options KEY=VALUE ...]

The published file loads through ``api.init_model(CONFIG,
checkpoint=PATH)`` and the eval CLI's ``--checkpoint``; it is checked to
load strictly into ``CONFIG``'s model (on the CPU) before it is written.
"""
from __future__ import annotations

import argparse
import hashlib
import os
import sys

import torch

from ..engine.checkpoint import restore_variables
from ..engine.config import build_model, get_config


def content_hash(state_dict: dict[str, torch.Tensor]) -> str:
    """sha256 over the tensors' bytes, in key order."""
    digest = hashlib.sha256()
    for key in sorted(state_dict):
        t = state_dict[key].detach().cpu().contiguous()
        digest.update(key.encode())
        digest.update(t.numpy().tobytes())
    return digest.hexdigest()


def publish(config: str, checkpoint: str, out: str,
            overrides: list[str] | None = None) -> str:
    """Write the published file; returns its path."""
    sd = restore_variables(checkpoint)
    model = build_model(get_config(config, overrides).model)
    model.load_state_dict(sd, strict=True)
    stem = out[:-4] if out.endswith(".pth") else out.rstrip("/")
    path = os.path.abspath(f"{stem}-{content_hash(sd)[:8]}.pth")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(sd, path)
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config", help="preset the checkpoint was trained with")
    ap.add_argument("checkpoint", help="a train checkpoint (ckpt_N)")
    ap.add_argument("out", help="output path (hash suffix appended)")
    ap.add_argument("--cfg-options", nargs="*", default=[])
    args = ap.parse_args(argv)
    path = publish(args.config, args.checkpoint, args.out, args.cfg_options)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    n_params = sum(v.numel() for k, v in sd.items()
                   if not k.endswith((".mean", ".var")))
    print(f"published {path}  ({n_params / 1e6:.2f}M parameters and "
          f"statistics, sha256 {path[-12:-4]})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
