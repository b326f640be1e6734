"""One rank of the port's tensor-parallel and spatially sharded runs, for
``test_torch_tp.py``, ``test_torch_spatial.py`` and
``test_torch_spatial_families.py``:

    python tests/torch_parallel_worker.py SPEC COORD PID NPROC OUT

joins a gloo process group of ``NPROC`` CPU processes at ``COORD``, runs
every case of ``SPEC`` (a ``torch.save``d list of dicts, ``run_case``)
and saves each case's result to ``OUT``.  The tests' one-process
references call ``run_case`` with no process group.  Imports no JAX.
"""
from __future__ import annotations

import contextlib
import importlib
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from spike2former_tpu_torch import parallel  # noqa: E402
from spike2former_tpu_torch.engine import checkpoint  # noqa: E402
from spike2former_tpu_torch.engine.inference import (  # noqa: E402
    whole_panoptic)
from spike2former_tpu_torch.engine.train import (  # noqa: E402
    init_trainer, train_steps)
from spike2former_tpu_torch.models.segmentor import Spike2Former  # noqa


def _model(case: dict) -> torch.nn.Module:
    """``Spike2Former(**model)``; or with ``preset`` the model that
    ``engine/config.py`` builds for it under ``overrides``; or with
    ``module`` = (``module.Class`` under ``models/``, kwargs) that
    module; holding ``state_dict``, in eval mode."""
    if "preset" in case:
        from spike2former_tpu_torch.engine.config import (build_model,
                                                          get_config)
        m = build_model(get_config(case["preset"],
                                   case["overrides"]).model)
    elif "module" in case:
        path, kwargs = case["module"]
        mod, name = path.rsplit(".", 1)
        m = getattr(importlib.import_module(
            f"spike2former_tpu_torch.models.{mod}"), name)(**kwargs)
    else:
        m = Spike2Former(**case["model"])
    m.load_state_dict(case["state_dict"], strict=True)
    return m.eval()


def _hooked(model: torch.nn.Module, name: str | None, store: dict):
    """A forward hook on the submodule ``name`` keeping its last output in
    ``store['hooked']`` (a no-op context without a name)."""
    if name is None:
        return contextlib.nullcontext()

    def keep(_, __, out):
        store["hooked"] = out

    return model.get_submodule(name).register_forward_hook(keep)


def run_case(case: dict) -> dict:
    """One case on this rank.  ``kind``:

    * ``spatial``: the model of ``_model``, ``predict_logits`` of
      ``images`` [B, H, W, 3] (with ``valid_hw`` where given) inside
      ``spatial_sharding()`` over the world, each rank's band cut at the
      model's ``band_stride``, the bands gathered -> ``logits``,
      ``band_rows`` and, with ``hook`` (a submodule's name), that
      submodule's last output on this rank -> ``hooked``;
    * ``spatial_panoptic``: ``whole_panoptic`` of the uint8 ``images`` in
      bands, with ``num_things`` and ``object_mask_thr`` -> the gathered
      ``sem`` and ``inst``;
    * ``attn_mask``: ``mask2former_attn_mask`` of the band of
      ``mask_pred`` [B, nq, H, W] at the band of the level ``hw`` -> the
      gathered mask [B, 1, nq, h, w] (``mask``);
    * ``spatial_tokens``: the module of ``_model`` on the tokens of the
      band of each level of ``inputs`` ([T, B, h, w, C] each, and of
      ``pos`` where given) concatenated level by level, with the bands'
      shapes -> its output split into the levels, each gathered over the
      bands (``outputs``);
    * ``spatial_module``: the module of ``_model`` on the band of
      ``inputs`` ([T, B, H, W, C], or a list of such levels) -> its
      outputs flattened, each gathered over the bands (``outputs``), and
      their band heights (``band_rows``);
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
        valid_hw = case.get("valid_hw")
        if valid_hw is not None:
            valid_hw = torch.as_tensor(valid_hw)
        store: dict = {}
        with (torch.no_grad(), parallel.spatial_sharding(mesh),
              _hooked(model, case.get("hook"), store)):
            band = model.predict_logits(
                parallel.shard_rows(images, stride=model.band_stride),
                valid_hw)
            return dict(logits=parallel.gather_rows_h(band),
                        band_rows=band.shape[1], hooked=store.get("hooked"))
    if kind == "spatial_panoptic":
        mesh = mesh_of(1)
        model = _model(case)
        images = torch.from_numpy(case["images"])
        with parallel.spatial_sharding(mesh):
            sem, inst = whole_panoptic(
                model, parallel.shard_rows(images),
                num_things=case["num_things"],
                object_mask_thr=case["object_mask_thr"])
            return dict(sem=parallel.gather_rows_h(sem),
                        inst=parallel.gather_rows_h(inst))
    if kind == "attn_mask":
        from spike2former_tpu_torch.models.maskformer_head import \
            mask2former_attn_mask
        mesh = mesh_of(1)
        (h, w), size = case["hw"], mesh.data_size
        with parallel.spatial_sharding(mesh):
            band = parallel.shard_rows(torch.from_numpy(case["mask_pred"]),
                                       axis=2, stride=1)
            am = mask2former_attn_mask(band, (h // size, w))
            return dict(mask=parallel.gather_rows_h(
                am.unflatten(-1, (h // size, w)), 3))
    if kind == "spatial_tokens":
        mesh = mesh_of(1)
        model = _model(case)

        def tokens(maps):
            bands = [parallel.shard_rows(torch.from_numpy(m), axis=2,
                                         stride=1) for m in maps]
            return (torch.cat([b.flatten(2, 3) for b in bands], 2),
                    [tuple(b.shape[2:4]) for b in bands])

        with torch.no_grad(), parallel.spatial_sharding(mesh):
            x, shapes = tokens(case["inputs"])
            pos = tokens(case["pos"])[0] if case.get("pos") else None
            out = model(x, shapes, pos)
            levels = out.split([h * w for h, w in shapes], 2)
            return dict(outputs=[
                parallel.gather_rows_h(y.unflatten(2, hw), 2)
                for y, hw in zip(levels, shapes)])
    if kind == "spatial_module":
        mesh = mesh_of(1)
        model = _model(case)
        inputs = case["inputs"]

        def band(x):
            return parallel.shard_rows(torch.from_numpy(x), axis=2, stride=1)

        with torch.no_grad(), parallel.spatial_sharding(mesh):
            out = model([band(x) for x in inputs] if isinstance(inputs, list)
                        else band(inputs))
            flat = ([out[0], out[1], *out[2]] if isinstance(out, tuple)
                    else [out])
            return dict(outputs=[parallel.gather_rows_h(y, 2)
                                 for y in flat],
                        band_rows=[y.shape[2] for y in flat])
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
