"""Scalar logging (port of ``spike2former_tpu/engine/logging.py``; mmengine
LoggerHook + LocalVisBackend): one JSON record per line in
``work_dir/scalars.jsonl``, the format the repo's ``tools/analyze_logs.py``
reads."""
from __future__ import annotations

import json
import os
import time


class ScalarLogger:
    """Appends ``{"step", "time", **scalars}`` records to
    ``work_dir/filename``, flushed at each record."""

    def __init__(self, work_dir: str, filename: str = "scalars.jsonl"):
        os.makedirs(work_dir, exist_ok=True)
        self.path = os.path.join(work_dir, filename)
        self._f = open(self.path, "a")

    def log(self, step: int, **scalars: float) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def read_scalars(path: str) -> list[dict]:
    """The records of a ``ScalarLogger`` file, in order."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
