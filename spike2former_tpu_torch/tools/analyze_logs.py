"""Summarize a train run's scalar log (the port's counterpart of the JAX
package's ``tools/analyze_logs.py``; mmseg's analyze_logs.py as text):
per key its first, last and smallest value and the mean of the last
``--window`` records, and the seconds per step.

    python -m spike2former_tpu_torch.tools.analyze_logs \\
        WORK_DIR/scalars.jsonl [--keys total loss_cls ...] [--window 50]
"""
from __future__ import annotations

import argparse
import sys

from ..engine.logging import read_scalars


def summarize(recs: list[dict], keys, window: int = 50) -> list[str]:
    """The summary's lines for the records of a ``ScalarLogger`` file."""
    if not recs:
        return ["no records"]
    lines = [f"{len(recs)} records, steps "
             f"{recs[0]['step']}..{recs[-1]['step']}"]
    for key in keys:
        vals = [r[key] for r in recs if key in r]
        if not vals:
            continue
        w = vals[-window:]
        lines.append(f"{key:12s} first {vals[0]:8.4f}  last {vals[-1]:8.4f}"
                     f"  min {min(vals):8.4f}  avg(last {len(w)}) "
                     f"{sum(w) / len(w):8.4f}")
    if len(recs) >= 2:
        dt = (recs[-1]["time"] - recs[0]["time"]) / max(
            recs[-1]["step"] - recs[0]["step"], 1)
        lines.append(f"avg sec/step: {dt:.3f}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("log", help="scalars.jsonl path")
    ap.add_argument("--keys", nargs="*", default=["total", "loss_cls",
                                                  "loss_mask", "loss_dice"])
    ap.add_argument("--window", type=int, default=50)
    args = ap.parse_args(argv)
    for line in summarize(read_scalars(args.log), args.keys, args.window):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
