"""One rank of the port's tensor-parallel and spatially sharded runs, for
``test_torch_tp.py`` and ``test_torch_spatial.py``:

    python tests/torch_parallel_worker.py SPEC COORD PID NPROC OUT

joins a gloo process group of ``NPROC`` CPU processes at ``COORD``, runs
every case of ``SPEC`` (a ``torch.save``d list of dicts, ``run_case``)
and saves each case's result to ``OUT``.  The tests' one-process
references call ``run_case`` with no process group.  Imports no JAX.
"""
from __future__ import annotations

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from spike2former_tpu_torch import parallel  # noqa: E402
from spike2former_tpu_torch.engine import checkpoint  # noqa: E402
from spike2former_tpu_torch.engine.train import (  # noqa: E402
    init_trainer, train_steps)
from spike2former_tpu_torch.models.segmentor import Spike2Former  # noqa


def _model(case: dict) -> Spike2Former:
    m = Spike2Former(**case["model"])
    m.load_state_dict(case["state_dict"], strict=True)
    return m.eval()


def run_case(case: dict) -> dict:
    """One case on this rank.  ``kind``:

    * ``spatial``: ``Spike2Former(**model)`` with ``state_dict``,
      ``predict_logits`` of ``images`` [B, H, W, 3] inside
      ``spatial_sharding()`` over the world, the bands gathered ->
      ``logits``;
    * ``tp_forward``: the same model split by ``shard_params_tp`` over a
      model axis of the world -> ``logits`` of the whole batch;
    * ``tp_step``: ``init_trainer(preset, overrides, state_dict=)`` split
      over a model axis of ``model_axis`` (data axis the rest), steps on
      this data rank's rows of ``batches``, then ``save_state`` into
      ``ckpt_dir`` -> ``metrics`` and the gathered (logical) ``state``
      and ``grads``."""
    world = parallel.world()[1]

    def mesh_of(model_axis: int) -> parallel.Mesh:
        # one process: no group, no mesh
        return (parallel.make_mesh(model_axis) if world > 1
                else parallel.Mesh())

    kind = case["kind"]
    if kind == "spatial":
        mesh = mesh_of(1)
        model = _model(case)
        images = torch.from_numpy(case["images"])
        with torch.no_grad(), parallel.spatial_sharding(mesh):
            band = model.predict_logits(parallel.shard_rows(images))
            return dict(logits=parallel.gather_rows_h(band),
                        band_rows=band.shape[1])
    if kind == "tp_forward":
        mesh = mesh_of(world)
        model = parallel.shard_params_tp(_model(case), mesh)
        with torch.no_grad():
            logits = model.predict_logits(torch.from_numpy(case["images"]))
        return dict(logits=logits)
    if kind == "tp_step":
        mesh = mesh_of(case.get("model_axis", world))
        tr = init_trainer(case["preset"], case["overrides"], device="cpu",
                          state_dict=case["state_dict"])
        parallel.shard_params_tp(tr.state, mesh)
        batches = [parallel.shard_batch(tuple(b), mesh.data_rank,
                                        mesh.data_size)
                   for b in case["batches"]]
        metrics = train_steps(tr, batches)
        model = tr.state.model
        grads = {k: p.grad.detach().clone()
                 for k, p in model.named_parameters() if p.grad is not None}
        out = dict(metrics=metrics,
                   state=parallel.gather_params_tp(model.state_dict(), mesh),
                   grads=parallel.gather_params_tp(grads, mesh),
                   shard_shapes={k: tuple(v.shape)
                                 for k, v in model.state_dict().items()})
        if case.get("ckpt_dir"):
            checkpoint.save_state(case["ckpt_dir"], tr.state, len(batches),
                                  wait=True)
        return out
    raise ValueError(f"unknown case kind {kind!r}")


def main(argv: list[str]) -> int:
    spec, coord, pid, nproc, out = argv
    torch.set_num_threads(1)
    pid, pcount = parallel.distributed_init(coord, int(nproc), int(pid),
                                            backend="gloo")
    try:
        cases = torch.load(spec, weights_only=False)
        torch.save([run_case(c) for c in cases], out)
    finally:
        parallel.shutdown()
    print(f"rank {pid}/{pcount}: done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
