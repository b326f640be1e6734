"""The port's firing-rate capture (``models/layers.py:observe_spikes``,
``utils/firing.py``, ``tools/cal_firing_num.py``) against the JAX
package's ``spikes`` collection, mirroring tests/test_firing_parity.py and
test_config_and_tools.py::test_firing_rates_api.

Every JAX ``Spike`` site is one ``Spike`` submodule of the port under
flax's name, so the key sets are equal.  Tolerances: each site's ``rate``
and ``nonfire`` within 1e-6 (f32 means of the same spikes; measured
6e-8), ``energy_proxy`` within 1e-6, the CLI's JSON within 1e-5 and its
CSV (6 decimals) within 1.5e-6.
"""
import csv
import importlib.util
import json
import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spike2former_tpu.utils.firing import _flatten
from spike2former_tpu.utils.firing import energy_proxy as jax_energy
from spike2former_tpu_torch.engine.convert import from_jax_variables
from spike2former_tpu_torch.models.layers import Spike, observe_spikes
from spike2former_tpu_torch.tools import cal_firing_num
from spike2former_tpu_torch.utils.firing import (accumulate_firing,
                                                 energy_proxy, firing_rates)

from torch_port_helpers import TINY, images, make_pair, write_ade_tree

FIRING_CFG = dict(TINY, eval_last_only=False)


_JITTED = {}


def jax_rates(jm, variables, x):
    """JAX's ``firing_rates`` (utils/firing.py:17-22), its forward
    jitted (once per model)."""
    if id(jm) not in _JITTED:
        _JITTED[id(jm)] = (jm, jax.jit(
            lambda v, a: jm.apply(v, a, mutable=["spikes"])))
    _, aux = _JITTED[id(jm)][1](variables, x)
    return {k: float(np.asarray(v[0] if isinstance(v, tuple) else v))
            for k, v in _flatten(aux["spikes"]).items()}


def jax_accumulate(jm, variables, xs):
    """JAX's ``accumulate_firing`` on ``jax_rates``."""
    totals = {}
    for x in xs:
        for k, v in jax_rates(jm, variables, x).items():
            totals[k] = totals.get(k, 0.0) + v
    return {k: v / len(xs) for k, v in totals.items()}


@pytest.fixture(scope="module", params=[False, True], ids=["fast", "compat"])
def pair(request):
    """T=2 without the time-step collapse and every decoder layer through
    the SDME sites, as the firing CLI runs the model."""
    return make_pair(FIRING_CFG, compat=request.param, T=2,
                     collapse_t=False, seed=5)


def test_firing_rates_match_jax(pair):
    jm, variables, pm = pair
    x = images((64, 64), seed=1)
    want = jax_rates(jm, variables, jnp.asarray(x))
    got = firing_rates(pm, torch.from_numpy(x))
    assert set(got) == set(want)
    assert len(want) > 60
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(energy_proxy(got), jax_energy(want), rtol=0,
                               atol=1e-6)


def test_every_spike_module_is_one_jax_site(pair):
    """No port ``Spike`` stands for two JAX sites or for none: one module
    per ``/rate`` key."""
    _, _, pm = pair
    got = firing_rates(pm, torch.from_numpy(images((64, 64))))
    sites = {n.replace(".", "/") for n, m in pm.named_modules()
             if isinstance(m, Spike)}
    assert {k.rsplit("/", 1)[0] for k in got} == sites
    assert len(got) == 2 * len(sites)


def test_accumulate_firing_matches_jax(pair):
    jm, variables, pm = pair
    xs = [images((64, 64), seed=s) for s in (2, 3)]
    want = jax_accumulate(jm, variables, [jnp.asarray(x) for x in xs])
    got = accumulate_firing(pm, (torch.from_numpy(x) for x in xs))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)


def test_observation_off_leaves_the_logits_bit_identical():
    """The forward with and without ``observe_spikes`` gives the same bits,
    and outside the block no site records anything."""
    _, _, pm = make_pair(TINY, seed=2)
    x = torch.from_numpy(images((64, 64), seed=4))
    with torch.no_grad():
        plain = pm.predict_logits(x)
        with observe_spikes(pm) as stats:
            observed = pm.predict_logits(x)
        after = pm.predict_logits(x)
    assert stats and torch.equal(plain, observed) and torch.equal(plain,
                                                                  after)


def test_nonfire_statistic_semantics():
    """The Monitor's second statistic: the fraction of exact zeros; a site
    called twice keeps its first call's values."""
    s = Spike()
    x = torch.tensor([[-1.0, 0.2, 0.9, 5.0]])  # q8: 0, 0.25, 1, 5 -> /8
    with observe_spikes(s) as stats:
        y = s(x)
        s(torch.full((1, 4), 8.0))
    want_y = np.round(np.clip([-1.0, 0.2, 0.9, 5.0], 0, 8)) / 8
    np.testing.assert_allclose(y.numpy()[0], want_y)
    assert set(stats) == {"/rate", "/nonfire"}
    np.testing.assert_allclose(float(stats["/rate"]), want_y.mean() * 8,
                               rtol=1e-6)
    np.testing.assert_allclose(float(stats["/nonfire"]),
                               (want_y == 0).mean(), rtol=1e-6)


def test_firing_rates_api():
    """test_config_and_tools.py::test_firing_rates_api on the port."""
    _, _, pm = make_pair(dict(TINY, num_decoder_layers=1), seed=0)
    rates = firing_rates(pm, torch.zeros(1, 32, 32, 3))
    assert len(rates) > 30
    assert all(np.isfinite(v) and v >= 0 for v in rates.values())
    nonfire = [v for k, v in rates.items() if k.endswith("nonfire")]
    assert nonfire and all(0.0 <= v <= 1.0 for v in nonfire)


def _jax_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_cal_firing_num", os.path.join(os.path.dirname(__file__), "..",
                                           "tools", "cal_firing_num.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ~65 s (the JAX CLI runs its model op by op): with --runslow; the default
# tier holds the statistics, their accumulation and the port CLI's files
@pytest.mark.slow
def test_cal_firing_num_cli_matches_jax(tmp_path, monkeypatch):
    """Both CLIs on the same seeded ADE tree (2 images) and weights, at
    T=2 (the shapes of the ``pair`` fixture, whose JAX ops are compiled
    by then): the same JSON keys within 1e-5 and the same CSV rows."""
    root = write_ade_tree(str(tmp_path / "ade"), n=2, seed=3)
    overrides = [f"model.{k}={v!r}".replace(" ", "")
                 for k, v in TINY.items()] + ["model.T=2",
                                              "data.crop_size=(64,64)"]
    jm, variables, pm = make_pair(FIRING_CFG, T=2, collapse_t=False, seed=6)

    from spike2former_tpu.engine import checkpoint as jckpt

    monkeypatch.setattr(jckpt, "restore_state",
                        lambda path, target: jax.tree_util.tree_map(
                            jnp.asarray, variables))
    jout = str(tmp_path / "jax_rates")
    monkeypatch.setattr(sys, "argv", [
        "cal_firing_num.py", "SDTv2_maskformer_DCNpixelDecoder_ade20k",
        "--checkpoint", "unused", "--data-root", root, "--num-images", "2",
        "--out", jout, "--cfg-options", *overrides])
    _jax_cli().main()

    sd_path = str(tmp_path / "weights.pt")
    torch.save(from_jax_variables(variables), sd_path)
    tout = str(tmp_path / "port_rates")
    assert cal_firing_num.main([
        "SDTv2_maskformer_DCNpixelDecoder_ade20k", "--checkpoint", sd_path,
        "--data-root", root, "--num-images", "2", "--out", tout,
        "--cfg-options", *overrides, "--device", "cpu"]) == 0

    with open(jout + ".json") as f:
        want = json.load(f)
    with open(tout + ".json") as f:
        got = json.load(f)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                   err_msg=k)
    rows = []
    for path in (jout + ".csv", tout + ".csv"):
        with open(path, newline="") as f:
            rows.append(list(csv.reader(f)))
    assert rows[0][0] == rows[1][0] == ["site", "firing_rate"]
    assert [r[0] for r in rows[0]] == [r[0] for r in rows[1]]
    np.testing.assert_allclose([float(r[1]) for r in rows[1][1:]],
                               [float(r[1]) for r in rows[0][1:]], rtol=0,
                               atol=1.5e-6)


def test_cal_firing_num_cli_writes_the_accumulated_rates(tmp_path):
    """The port CLI on a seeded ADE tree: JSON and CSV of JAX's format
    holding ``accumulate_firing`` of its centre crops, every JAX site
    among the keys."""
    from spike2former_tpu_torch.data.dataset import make_dataset
    from spike2former_tpu_torch.data.transforms import resize_keep_ratio
    from spike2former_tpu_torch.models.segmentor import preprocess

    root = write_ade_tree(str(tmp_path / "ade"), n=2, seed=3)
    overrides = [f"model.{k}={v!r}".replace(" ", "")
                 for k, v in TINY.items()] + ["data.crop_size=(64,64)"]
    _, variables, pm = make_pair(FIRING_CFG, collapse_t=False, seed=6)
    sd_path = str(tmp_path / "weights.pt")
    torch.save(from_jax_variables(variables), sd_path)
    out = str(tmp_path / "rates")
    assert cal_firing_num.main([
        "SDTv2_maskformer_DCNpixelDecoder_ade20k", "--checkpoint", sd_path,
        "--data-root", root, "--num-images", "2", "--out", out,
        "--cfg-options", *overrides, "--device", "cpu"]) == 0
    with open(out + ".json") as f:
        got = json.load(f)
    ds = make_dataset("ade20k", root, "val")
    xs = [preprocess(torch.from_numpy(cal_firing_num.center_crop(
        resize_keep_ratio(ds.load(i), 2048, 512)["image"], (64, 64))[None]))
        for i in range(2)]
    want = accumulate_firing(pm, xs)
    assert got == want and len(got) > 60
    with open(out + ".csv", newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["site", "firing_rate"]
    assert rows[1:] == [[k, f"{v:.6f}"] for k, v in sorted(got.items())]
