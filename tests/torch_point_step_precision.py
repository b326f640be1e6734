"""Where the port's point-loss train step and JAX's part at the second
step of ``test_torch_point_sample.py::test_train_step_with_loss_points_matches_jax``
(a diagnostic, not a test).

    JAX_PLATFORMS=cpu python tests/torch_point_step_precision.py

It runs the test's two JAX steps in f32, and again with 64-bit JAX and the
model in f64 (a subprocess; the auction and the losses stay f32), and the
port's two steps in f32 and f64, each once on its own matching and once
handed JAX's (``pin_jax_matching``).  Per step it prints each run's
``grad_norm``, the largest gradient gap to the JAX f64 run as a fraction
of its largest gradient, the number of tied queries the port's auction
swapped, and whether every ``uncertain_point_coords`` selection equals
JAX's.
"""
import copy
import os
import pickle
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import conftest  # noqa: F401  (JAX on the CPU, highest matmul precision)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_point_sample as P
from spike2former_tpu_torch.engine.convert import from_jax_variables


def _grads(tree):
    return {k: v.double().numpy()
            for k, v in from_jax_variables({"params": tree}).items()}


def jax_run(f64: bool, out: str) -> None:
    """The JAX steps (f64: 64-bit JAX, the model in f64) into ``out``."""
    from spike2former_tpu.losses import criterion as jcrit
    from spike2former_tpu.models import Spike2Former as JaxModel
    jm, variables, _, batches = P.point_step_inputs()
    with pytest.MonkeyPatch.context() as mp:
        if f64:
            jax.config.update("jax_enable_x64", True)
            jm = JaxModel(T=1, compat=False, collapse_t=True,
                          dtype=jnp.float64,
                          **dict(P.TINY, lazy_masks=True, norm_eval=True))
            variables = jax.tree_util.tree_map(
                lambda a: np.asarray(a, np.float64), variables)
            auction = jcrit.auction_match

            def auction32(costs, *args, **kw):  # its loop is f32-only
                with jax.enable_x64(False):
                    return auction(costs.astype(jnp.float32), *args, **kw)
            mp.setattr(jcrit, "auction_match", auction32)
        rec = P.record_jax_point_step(mp)
        metrics, grads = P.jax_point_steps(jm, variables, batches,
                                           P.POINT_STEP_SEEDS["points"])
    with open(out, "wb") as f:
        pickle.dump(dict(metrics=metrics, grads=[_grads(g) for g in grads],
                         **rec), f)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--jax-f64":
        jax_run(True, sys.argv[2])
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        f64_out = os.path.join(tmp, "f64.pkl")
        child = subprocess.Popen([sys.executable, __file__, "--jax-f64",
                                  f64_out])
        jax_run(False, os.path.join(tmp, "f32.pkl"))
        if child.wait():
            return 1
        runs = {}
        for name in ("f32", "f64"):
            with open(os.path.join(tmp, f"{name}.pkl"), "rb") as f:
                runs[f"jax {name}"] = pickle.load(f)
    ref = runs["jax f64"]
    _, _, pm, batches = P.point_step_inputs()
    for dt in (torch.float32, torch.float64):
        for pinned in (False, True):
            with pytest.MonkeyPatch.context() as mp:
                prec = P.pin_jax_matching(mp, runs["jax f32"]["match"]) \
                    if pinned else {"coords": [], "swaps": None}
                if not pinned:
                    coords_fn = P.criterion.uncertain_point_coords

                    def coords(*args, **kw):
                        out = coords_fn(*args, **kw)
                        prec["coords"].append(out.detach().numpy())
                        return out
                    mp.setattr(P.criterion, "uncertain_point_coords",
                               coords)
                metrics, grads = P._port_point_steps(
                    copy.deepcopy(pm), batches, P.POINT_STEP_SEEDS["points"],
                    dt)
            runs[f"port {str(dt)[6:]}{' pinned' if pinned else ''}"] = dict(
                metrics=metrics, coords=prec["coords"], swaps=prec["swaps"],
                grads=[{k: v.double().numpy() for k, v in g.items()}
                       for g in grads])
    n = len(ref["coords"]) // len(batches)
    for s in range(len(batches)):
        top = max(np.abs(v).max() for v in ref["grads"][s].values())
        for name, r in runs.items():
            gap = max(np.abs(r["grads"][s][k] - w).max()
                      for k, w in ref["grads"][s].items()) / top
            same = all(np.array_equal(a, b) for a, b in zip(
                r["coords"][s * n:(s + 1) * n],
                runs["jax f32"]["coords"][s * n:(s + 1) * n]))
            print(f"step {s} {name:17s} grad_norm="
                  f"{r['metrics'][s]['grad_norm']!r} max|g - g_jax64|/top="
                  f"{gap:.3g} selections==jax32: {same}", flush=True)
    print(f"tied-query swaps of the port's f32 auction over both steps: "
          f"{runs['port float32 pinned']['swaps']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
