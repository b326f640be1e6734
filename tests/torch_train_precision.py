"""How far the JAX train step and the port's are from an f64 run of the
port's step, gradient by gradient (a diagnostic, not a test).

    JAX_PLATFORMS=cpu python tests/torch_train_precision.py \\
        [--compat] [--accum N] [--seeds 3 0 1] [--one-pass-bn]

For each weight seed it builds the tiny model pair of
``test_torch_train.py``, runs two JAX ``make_train_step`` steps (f32) and
the port's two steps in f32 and in f64 on the same batches, and prints per
step: the largest JAX gradient, the largest |JAX f32 - port f64|, the
largest |port f32 - port f64| and the largest ratio of that error to its
leaf's largest gradient (leaves above 1e-3 of the largest gradient), and
the three ``grad_norm``s.
``--one-pass-bn`` swaps the port's training-mode BN variance for flax's
one-pass ``max(0, E[x^2] - E[x]^2)``.  ``--jax-f64`` also runs the JAX step
with 64-bit JAX and the model in f64 (its losses stay f32) and prints its
``grad_norm`` and largest |JAX f64 - port f64|.
"""
import argparse
import copy
import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

import conftest  # noqa: F401  (JAX on the CPU, highest matmul precision)
import torch

import test_torch_train as T
from spike2former_tpu_torch.engine import train as ttrain
from spike2former_tpu_torch.engine.config import TrainConfig
from spike2former_tpu_torch.engine.convert import from_jax_variables
from spike2former_tpu_torch.models import layers
from torch_port_helpers import TINY, make_pair


def _one_pass_bn(self, x):
    if self.training:
        axes = tuple(range(x.dim() - 1))
        mean = x.mean(axes)
        var = torch.clamp((x * x).mean(axes) - mean * mean, min=0.0)
        layers._update_running(self.mean, mean)
        layers._update_running(self.var, var)
    else:
        mean, var = self.mean, self.var
    return (x - mean) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias


def _port(pm, batches, accum, dtype):
    model = copy.deepcopy(pm).to(dtype)
    orig = ttrain.preprocess
    ttrain.preprocess = lambda x: orig(x).to(dtype)
    try:
        state = ttrain.init_state(model, TrainConfig(warmup_iters=1))
        step = ttrain.make_train_step(T.NUM_CLASSES, accum_steps=accum)
        out = []
        for images, sem in batches:
            _, m = step(state, torch.from_numpy(images),
                        torch.from_numpy(sem).long())
            out.append((float(m["grad_norm"]),
                        {k: p.grad.double()
                         for k, p in model.named_parameters()}))
        return out
    finally:
        ttrain.preprocess = orig


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--compat", action="store_true")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--seeds", type=int, nargs="+", default=[3])
    ap.add_argument("--one-pass-bn", action="store_true")
    ap.add_argument("--jax-f64", action="store_true")
    args = ap.parse_args()
    if args.jax_f64:
        import jax
        jax.config.update("jax_enable_x64", True)
    if args.one_pass_bn:
        layers.BatchNorm.forward = _one_pass_bn
    batches = [T._batch(seed=0), T._batch(seed=1)]
    for seed in args.seeds:
        jm, variables, pm = make_pair(
            cfg=dict(TINY, lazy_masks=True, norm_eval=True),
            compat=args.compat, seed=seed)
        jmetrics, jgrads, _ = T._run_jax(jm, variables, batches, args.accum)
        if args.jax_f64:
            import jax
            import jax.numpy as jnp
            import numpy as np
            from spike2former_tpu.models import Spike2Former as JaxModel

            jm64 = JaxModel(T=1, compat=args.compat, collapse_t=True,
                            dtype=jnp.float64, **dict(
                                TINY, lazy_masks=True, norm_eval=True))
            v64 = jax.tree_util.tree_map(
                lambda a: np.asarray(a, np.float64), variables)
            j64 = T._run_jax(jm64, v64, batches, args.accum)
        p32 = _port(pm, batches, args.accum, torch.float32)
        p64 = _port(pm, batches, args.accum, torch.float64)
        for i, (jm_i, jg) in enumerate(zip(jmetrics, jgrads)):
            want = {k: v.double()
                    for k, v in from_jax_variables({"params": jg}).items()}
            g32, g64 = p32[i][1], p64[i][1]
            top = max(float(w.abs().max()) for w in want.values())
            e_jax = max(float((want[k] - g64[k]).abs().max()) for k in want)
            e_32 = max(float((g32[k] - g64[k]).abs().max()) for k in want)
            # leaves with a gradient above 1e-3 of the largest (biases that
            # feed a training-mode BN have a true gradient of 0)
            ratio = max(float((g32[k] - g64[k]).abs().max())
                        / float(g64[k].abs().max()) for k in want
                        if float(g64[k].abs().max()) > 1e-3 * top)
            if args.jax_f64:
                w64 = {k: v.double() for k, v in from_jax_variables(
                    {"params": j64[1][i]}).items()}
                e64 = max(float((w64[k] - g64[k]).abs().max())
                          for k in want)
                e3264 = max(float((w64[k] - want[k]).abs().max())
                            for k in want)
                print(f"  jax64: grad_norm={j64[0][i]['grad_norm']:.7g} "
                      f"max|jax64-port64|={e64:.3g} "
                      f"max|jax32-jax64|={e3264:.3g}", flush=True)
            print(f"compat={args.compat} accum={args.accum} seed={seed} "
                  f"step={i}: max|g_jax|={top:.4g} "
                  f"max|jax32-port64|={e_jax:.3g} "
                  f"max|port32-port64|={e_32:.3g} "
                  f"(worst leaf ratio {ratio:.3g}) grad_norm jax32="
                  f"{jm_i['grad_norm']:.7g} port32={p32[i][0]:.7g} "
                  f"port64={p64[i][0]:.7g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
