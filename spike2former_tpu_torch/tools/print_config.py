"""Print a preset's resolved config after ``--cfg-options`` (the port's
counterpart of the JAX package's ``tools/print_config.py``; mmseg's
tools/misc/print_config.py), or list the presets.

    python -m spike2former_tpu_torch.tools.print_config [CONFIG] \\
        [--cfg-options KEY=VALUE ...] [--json]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from ..engine.config import PRESETS, get_config


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config", nargs="?", default=None,
                    help="preset name; omit to list all presets")
    ap.add_argument("--cfg-options", nargs="*", default=[])
    ap.add_argument("--json", action="store_true",
                    help="machine-readable JSON instead of pretty text")
    args = ap.parse_args(argv)

    if args.config is None:
        for name in sorted(PRESETS):
            print(name)
        return 0
    tree = dataclasses.asdict(get_config(args.config, args.cfg_options))
    if args.json:
        print(json.dumps(tree, indent=2, default=str))
        return 0
    for section, values in tree.items():
        if not isinstance(values, dict):
            print(f"{section} = {values!r}")
            continue
        print(f"[{section}]")
        for k, v in values.items():
            print(f"  {k} = {v!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
