"""Render the learning run's report from its ``scalars.jsonl`` (port of
the repository's ``tools/make_learning_report.py``).

    python -m spike2former_tpu_torch.tools.make_learning_report \\
        [--work-dir work_dirs/learning_run_torch] \\
        [--out docs/LEARNING_TORCH.md] [--png docs/learning_curve_torch.png]

The markdown holds the train loss from the first logged step to the last,
the best val mIoU (percent, as ``evaluation/iou_metric.py`` reports it),
the median s/iter over the log records after the first five, the peak
device memory, the val mIoU trace, the train loss trace and the sha256 of
the newest ``ckpt_<step>`` file (``engine/checkpoint.py:save_state``;
``sha256sum`` of the file gives the same digest).  Every s/iter stands
beside the card's name and power limit, as ``learning_run`` recorded them
in ``work_dir/run_info.json``.  The loss and val curves go to ``--png``
where matplotlib is installed; without it the markdown is written alone
and the tool says so.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import shlex
import subprocess
import sys

from ..engine.checkpoint import latest_checkpoint
from ..engine.logging import read_scalars

RUN_INFO = "run_info.json"


def reproduce(info: dict) -> str:
    """The command that reproduces the run ``info`` describes."""
    return " ".join(["python -m spike2former_tpu_torch.tools.learning_run",
                     *(shlex.quote(a) for a in info.get("argv", []))])


def ckpt_hash(work_dir: str) -> tuple[str | None, str | None]:
    """(name, sha256 hex digest) of the newest ``ckpt_<step>`` file in
    ``work_dir``, or (None, None)."""
    path = latest_checkpoint(work_dir)
    if path is None:
        return None, None
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return os.path.basename(path), h.hexdigest()


def read_run_info(work_dir: str) -> dict:
    """What ``learning_run`` recorded of the run (the card, the peak
    memory, the options), or {}."""
    path = os.path.join(work_dir, RUN_INFO)
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def val_rows(val: list[dict]) -> str:
    """The val mIoU table's rows, as the JAX package's report writes
    them."""
    return "\n".join(f"| {r['step']} | {r['mIoU']:.2f} |" for r in val)


def median_sec_per_iter(train: list[dict]) -> float:
    """The median s/iter of the log records after the first five."""
    sec = [r["sec_per_iter"] for r in train if "sec_per_iter" in r][5:]
    return sorted(sec)[len(sec) // 2] if sec else float("nan")


def plot(train: list[dict], val: list[dict], png: str) -> bool:
    """Draw the loss and val curves into ``png``; False without
    matplotlib."""
    try:
        import matplotlib
    except ImportError:
        return False
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    # single-series charts: one axis each, no legend (titles name the
    # series), 2px line marks, recessive grid
    blue = "#3b6bd6"
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4))
    ax1.plot([r["step"] for r in train], [r["total"] for r in train],
             lw=2, color=blue)
    ax1.set_xlabel("step")
    ax1.set_ylabel("train loss (total)")
    ax1.set_title("training loss")
    ax2.plot([r["step"] for r in val], [r["mIoU"] for r in val],
             marker="o", markersize=5, lw=2, color=blue)
    ax2.set_xlabel("step")
    ax2.set_ylabel("val mIoU (%)")
    ax2.set_title("periodic val (whole inference + IoU)")
    for ax in (ax1, ax2):
        ax.grid(alpha=0.25, lw=0.6)
        for s in ("top", "right"):
            ax.spines[s].set_visible(False)
    fig.tight_layout()
    os.makedirs(os.path.dirname(png) or ".", exist_ok=True)
    fig.savefig(png, dpi=110)
    plt.close(fig)
    return True


def _commit() -> str:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], capture_output=True,
            text=True, cwd=os.path.dirname(os.path.abspath(__file__)))
    except OSError:
        return "not a git checkout"
    return out.stdout.strip() or "not a git checkout"


def render(work_dir: str, out: str, png: str | None) -> dict:
    """Write the report of ``work_dir`` to ``out`` (and the curves to
    ``png`` where matplotlib is installed).  Returns what it wrote:
    ``best``, ``val`` (the val records), ``ckpt``, ``sha256``, ``png``
    (the path, or None)."""
    recs = read_scalars(os.path.join(work_dir, "scalars.jsonl"))
    train = [r for r in recs if "total" in r]
    val = [r for r in recs if "mIoU" in r]
    info = read_run_info(work_dir)
    card = info.get("card", "card not recorded")
    drawn = bool(png) and plot(train, val, png)
    name, digest = ckpt_hash(work_dir)
    med = median_sec_per_iter(train)
    first = train[0]["total"] if train else float("nan")
    last = train[-1]["total"] if train else float("nan")
    best = max((r["mIoU"] for r in val), default=float("nan"))
    peak = info.get("peak_gib")
    peak_text = (f"{peak:.3f} GiB on {card}" if peak is not None
                 else "not measured")
    if drawn:
        rel = os.path.relpath(png, os.path.dirname(out) or ".")
        curve = f"![learning curve]({rel})"
    else:
        curve = ("(No curve: matplotlib is not installed where this report "
                 "was rendered.)")
    loss_rows = "\n".join(
        f"| {r['step']} | {r['total']:.4f} | "
        f"{r.get('sec_per_iter', float('nan')):.3f} |" for r in train)
    md = f"""# Trained-model evidence: the port's synthetic-dataset learning run

A run of the flagship Spike2Former config
(`SDTv2_maskformer_DCNpixelDecoder_ade20k`) through the port's train CLI
(`spike2former_tpu_torch/tools/train.py`): the full loop (threaded loader
and augmentations, auction matching, GT-resolution losses, periodic
whole-image val with the IoU metric, checkpoints) on the structured
synthetic ADE-layout set (`spike2former_tpu_torch/tools/make_synth_dataset.py`:
texture-keyed classes in an ADE20K-layout tree, {info.get("set", "?")}),
with weights drawn from `train.seed`.

Reproduce:

```bash
{reproduce(info)}
```

## Result (commit {_commit()})

| | |
|---|---|
| train loss (total) | {first:.3f} → {last:.3f} |
| best val mIoU (%) | **{best:.2f}** |
| median s/iter (incl. host data path) | {med:.3f} on {card} |
| peak device memory | {peak_text} |
| final checkpoint | `{name}` sha256 `{digest}` |

{curve}

## Val mIoU trace

| step | mIoU |
|---|---|
{val_rows(val)}

## Train loss trace

| step | total | s/iter on {card} |
|---|---|---|
{loss_rows}

Scalars: `{os.path.join(work_dir, "scalars.jsonl")}`; rendered val overlays
under `{os.path.join(work_dir, "vis")}/iter_*/`.
"""
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        f.write(md)
    return dict(best=best, val=val, ckpt=name, sha256=digest,
                png=png if drawn else None)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work-dir", default="work_dirs/learning_run_torch")
    ap.add_argument("--out", default="docs/LEARNING_TORCH.md")
    ap.add_argument("--png", default="docs/learning_curve_torch.png")
    args = ap.parse_args(argv)
    res = render(args.work_dir, args.out, args.png)
    drawn = (f"and {res['png']}" if res["png"] else
             "without a PNG (matplotlib is not installed)")
    print(f"wrote {args.out} {drawn} (best mIoU {res['best']:.2f}, "
          f"{len(res['val'])} val points)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
