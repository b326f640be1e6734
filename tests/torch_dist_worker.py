"""One rank of the port's data-parallel train steps, for
``test_torch_distributed.py``:

    python tests/torch_dist_worker.py SPEC COORD PID NPROC OUT

joins a gloo process group of ``NPROC`` CPU processes at ``COORD``
(``host:port``), runs every case of ``SPEC`` (a ``torch.save``d list of
dicts: ``preset``, ``overrides``, optional ``state_dict``, ``batches``:
global batches as tuples of numpy arrays) on this rank's rows, and saves
each case's per-step metrics and final state dict to ``OUT``.  The
test's one-process reference calls ``run_cases`` with ``pcount=1``.
Imports no JAX.
"""
from __future__ import annotations

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from spike2former_tpu_torch.engine.train import (  # noqa: E402
    init_trainer, train_steps)
from spike2former_tpu_torch.parallel import (  # noqa: E402
    distributed_init, shard_batch, shutdown)


def run_cases(cases: list[dict], pid: int, pcount: int) -> list[dict]:
    """Each case's metrics (one dict of floats a step) and state dict
    after its steps, on rank ``pid``'s rows of each global batch."""
    out = []
    for case in cases:
        tr = init_trainer(case["preset"], case["overrides"], device="cpu",
                          state_dict=case.get("state_dict"))
        batches = [shard_batch(tuple(b), pid, pcount)
                   for b in case["batches"]]
        metrics = train_steps(tr, batches)
        state = {k: v.detach().clone()
                 for k, v in tr.state.model.state_dict().items()}
        grads = {k: p.grad.detach().clone()
                 for k, p in tr.state.model.named_parameters()
                 if p.grad is not None}
        out.append(dict(metrics=metrics, state=state, grads=grads))
    return out


def main(argv: list[str]) -> int:
    spec, coord, pid, nproc, out = argv
    torch.set_num_threads(2)
    pid, pcount = distributed_init(coord, int(nproc), int(pid),
                                   backend="gloo")
    try:
        cases = torch.load(spec, weights_only=False)
        torch.save(run_cases(cases, pid, pcount), out)
    finally:
        shutdown()
    print(f"rank {pid}/{pcount}: done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
