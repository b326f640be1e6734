"""Write ``tests/jax_init_digest.json``: a digest of the JAX package's
``model.init(PRNGKey(0))`` variables of the flagship at full width, with
the model options of ``chip_smoke.py``'s (init) phase (the learning
run's recipe: bf16, 30 classes), which holds the port's
``init_weights_(model, 0)``, drawn on the card, to it entry by entry.

Per port state_dict entry: its shape, the float64 sum and sum of squares
of its elements, and 16 elements (float32, at the flat indices
``sample_indices(numel)`` of the port's layout).  The variables come from
``tests/test_torch_init_exact.py:flax_tree`` (flax's ``model.init`` traced
once with ``Module.param`` recorded, each initializer then called on the
key ``model.init`` hands it; a 64x64 input, as the parameters' shapes do
not depend on it), converted by ``engine/convert.py:from_jax_variables``.

    JAX_PLATFORMS=cpu python tests/torch_init_digest.py
"""
import json
import os
import sys

import numpy as np

DIGEST = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "jax_init_digest.json")
PRESET = "SDTv2_maskformer_DCNpixelDecoder_ade20k"
MODEL_OPTS = ["model.dtype='bfloat16'", "model.num_classes=30"]
SEED = 0
SAMPLES = 16


def sample_indices(numel: int) -> np.ndarray:
    """The flat indices of an entry's sampled elements."""
    return np.unique(np.linspace(0, numel - 1, SAMPLES).round()
                     .astype(np.int64))


def digest(arr: np.ndarray) -> dict:
    flat = np.asarray(arr, np.float32).reshape(-1)
    x = flat.astype(np.float64)
    return dict(shape=list(arr.shape), sum=float(x.sum()),
                sumsq=float((x * x).sum()),
                samples=[float(v) for v in flat[sample_indices(flat.size)]])


def main() -> None:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import jax.numpy as jnp

    from spike2former_tpu.engine.config import build_model, get_config
    from spike2former_tpu_torch.engine.convert import from_jax_variables
    from test_torch_init_exact import flax_tree

    jm = build_model(get_config(PRESET, MODEL_OPTS).model)
    tree = flax_tree(jm, SEED, jnp.zeros((1, 64, 64, 3), jnp.float32), True)
    sd = from_jax_variables(tree)
    out = dict(preset=PRESET, model_options=MODEL_OPTS, seed=SEED,
               entries={k: digest(v.numpy()) for k, v in sorted(sd.items())})
    entries = out.pop("entries")
    with open(DIGEST, "w") as f:     # one line an entry
        f.write(json.dumps(out)[:-1] + ', "entries": {\n')
        f.write(",\n".join(f"{json.dumps(k)}: {json.dumps(v)}"
                            for k, v in entries.items()))
        f.write("}}\n")
    out["entries"] = entries
    print(f"{len(sd)} entries, "
          f"{sum(int(np.prod(e['shape'])) for e in out['entries'].values())}"
          f" elements -> {DIGEST}")


if __name__ == "__main__":
    main()
