"""The port's data-parallel training (``spike2former_tpu_torch/parallel``)
in two gloo CPU processes at the tiny dims of ``tests/test_multihost.py``
(64x64 crops, global batch 4, two rows a rank, two steps).

* The loader's per-process shares of an epoch are disjoint and complete.
* For each step kind (the MaskFormer at GT resolution with the host
  matcher, the point-sampled one with the auction and a ``compact_gt``
  that one rank's rows overflow and the other's do not, the panoptic
  step, and the FPN step with CE, Lovász and OHEM pixel losses and head
  dropout), the two-rank step equals the one-process step on the
  concatenated batch: every metric within 2e-4 relative and the
  parameters' fingerprint (the sum of their absolute values, as JAX's
  ``test_two_process_train_step_bitwise_synchronized`` takes it) within
  2e-5 relative.  Single parameters are not held tighter: where a
  gradient is at the level of rounding noise (biases that feed a
  training-mode BN) Adam moves its parameter by up to the rate either
  way.  Across the ranks the metrics and the state are bitwise equal.
* The two-rank MaskFormer step is held to JAX's single-process
  ``make_train_step`` on the same global batch with the tolerances of
  ``test_torch_train.py``.
* The train CLI over two processes prints the ``distributed: process``
  line and the same loss on both at every logged iteration.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

from spike2former_tpu_torch.data.loader import TrainLoader
from spike2former_tpu_torch.parallel import free_port

from torch_dist_worker import run_cases
from torch_port_helpers import TINY, make_pair, write_ade_tree
from test_torch_train import _batch, _check_metrics, _check_state, _run_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")
TIMEOUT = 300  # seconds, for each subprocess
METRIC_RTOL, FINGERPRINT_RTOL = 2e-4, 2e-5

FLAGSHIP = "SDTv2_maskformer_DCNpixelDecoder_ade20k"
TINY_OPTS = [f"model.{k}={v!r}".replace(" ", "") for k, v in TINY.items()
             ] + ["train.warmup_iters=1"]
TINY_FPN = ["model.num_classes=5", "model.embed_dim=(8,16,24,32)",
            "model.backbone_heads=4", "model.depths_stage3=1",
            "model.depths_stage4=1", "model.neck_channels=16",
            "model.head_channels=8", "model.T=2", "train.warmup_iters=1"]


class _FakeDS:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def load(self, i):
        # the sample's identity in its (augmentation-proof) label map
        return {"image": np.full((40, 40, 3), i, np.uint8),
                "sem_seg": np.full((40, 40), i, np.uint8), "meta": {}}


def test_loader_shards_disjoint_and_complete():
    seen = []
    for pid in (0, 1):
        with TrainLoader(_FakeDS(8), batch_size=2, crop_size=(32, 32),
                         seed=7, num_workers=2, process_id=pid,
                         process_count=2) as loader:
            it = iter(loader)
            ids = []
            for _ in range(2):  # one epoch: 8 samples, 2 ranks of 2
                for s in next(it)[1]:
                    ids.append(int(np.bincount(s[s != 255]).argmax()))
        seen.append(ids)
    assert set(seen[0]).isdisjoint(seen[1])
    assert sorted(seen[0] + seen[1]) == list(range(8))


def test_distributed_init_one_process_twice_and_helpers():
    """One process: a group of one rank (a free local port), a second
    call returns it, the reductions stay off at world size 1, and the
    helpers' arithmetic."""
    from spike2former_tpu_torch import parallel

    assert parallel.world() == (0, 1)
    try:
        assert parallel.distributed_init(None, 1, 0,
                                         backend="gloo") == (0, 1)
        assert parallel.distributed_init("localhost:1", 4, 3) == (0, 1)
        with parallel.global_batch():
            assert not parallel.synced()
            x = torch.arange(4.0)
            assert parallel.global_sum(x) is x
            assert parallel.gather_rows(x) is x
        parallel.barrier()
    finally:
        parallel.shutdown()
    assert parallel.world() == (0, 1)
    batch = (np.arange(8).reshape(4, 2), np.arange(4))
    rows = parallel.shard_batch(batch, 1, 2)
    np.testing.assert_array_equal(rows[0], [[4, 5], [6, 7]])
    np.testing.assert_array_equal(rows[1], [2, 3])
    with pytest.raises(ValueError):
        parallel.shard_batch(np.arange(3), 0, 2)
    with pytest.raises(ValueError):
        parallel.distributed_init(None, 2, 0)
    mean, var = parallel.batch_moments(torch.tensor([[1.0], [3.0]]))
    assert mean.item() == 2.0 and var.item() == 1.0


def _panoptic_batch(seed, b=4, hw=(64, 64), g=6, num_classes=5):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (b, *hw, 3), dtype=np.uint8)
    blocks = rng.integers(0, g, (b, hw[0] // 16, hw[1] // 16))
    seg = np.kron(blocks, np.ones((16, 16), np.int64))
    masks = (seg[:, None] == np.arange(g)[None, :, None, None]).astype(
        np.uint8)
    valid = masks.reshape(b, g, -1).any(-1)
    labels = rng.integers(0, num_classes, (b, g)).astype(np.int32)
    return images, labels, masks, valid


def _point_batch(seed):
    """Four classes at most (the tiny model's 4 queries bid for them);
    rank 0's rows hold 3, so under ``compact_gt=3`` rank 0 alone would
    cut its GT axis, and the global batch does not."""
    images, sem = _batch(b=4, seed=seed, num_classes=4)
    sem[:2] = np.where(sem[:2] == 255, 255, np.minimum(sem[:2], 2))
    assert len(set(np.unique(sem[2:])) - {255}) == 4
    return images, sem


def _cases(state_dict):
    return [
        dict(name="maskformer_gt", preset=FLAGSHIP,
             overrides=TINY_OPTS + ["train.matcher='host'"],
             state_dict=state_dict,
             batches=[_batch(b=4, seed=0), _batch(b=4, seed=1)]),
        dict(name="maskformer_points", preset=FLAGSHIP,
             overrides=TINY_OPTS + ["train.loss_points=64",
                                    "train.compact_gt=3"],
             batches=[_point_batch(2), _point_batch(3)]),
        dict(name="panoptic", preset="SDTv2_maskformer_coco_panoptic",
             overrides=TINY_OPTS + ["train.matcher='host'",
                                    "model.num_things=2"],
             batches=[_panoptic_batch(4), _panoptic_batch(5)]),
        dict(name="fpn", preset="fpn_sdtv3_512x512_10M_ade20k",
             overrides=TINY_FPN + [
                 "train.loss_decode=(('ce',1.0),('lovasz',0.5),"
                 "('ohem',0.4,{'min_kept':64}))"],
             batches=[_batch(b=4, seed=6), _batch(b=4, seed=7)]),
    ]


CASE_NAMES = ["maskformer_gt", "maskformer_points", "panoptic", "fpn"]


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _communicate(procs):
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {i} failed:\n{out[-3000:]}"
    return outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(cases, one-process results, each rank's results, JAX's run of
    the MaskFormer case)."""
    tmp = tmp_path_factory.mktemp("ddp")
    jm, variables, pm = make_pair(cfg=dict(TINY, lazy_masks=True,
                                           norm_eval=True), seed=3)
    cases = _cases({k: v.clone() for k, v in pm.state_dict().items()})
    torch.save(cases, tmp / "spec.pt")
    coord = f"localhost:{free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(tmp / "spec.pt"), coord, str(i), "2",
         str(tmp / f"rank{i}.pt")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, env=_env(), text=True) for i in (0, 1)]
    try:
        single = run_cases(cases, 0, 1)
        jax_run = _run_jax(jm, variables, cases[0]["batches"], 1, "host", 32)
    finally:
        _communicate(procs)
    ranks = [torch.load(tmp / f"rank{i}.pt", weights_only=False)
             for i in (0, 1)]
    return cases, single, ranks, jax_run


def _fingerprint(state):
    return sum(float(v.double().abs().sum()) for v in state.values())


@pytest.mark.parametrize("case", CASE_NAMES)
def test_two_ranks_equal_one_process_on_the_global_batch(runs, case):
    cases, single, ranks, _ = runs
    i = CASE_NAMES.index(case)
    want, got = single[i], ranks[0][i]
    assert len(got["metrics"]) == len(cases[i]["batches"])
    for w, g in zip(want["metrics"], got["metrics"]):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=METRIC_RTOL,
                                       atol=1e-7, err_msg=k)
        assert np.isfinite(g["total"]) and g["total"] > 0
    assert set(got["state"]) == set(want["state"])
    np.testing.assert_allclose(_fingerprint(got["state"]),
                               _fingerprint(want["state"]),
                               rtol=FINGERPRINT_RTOL)


@pytest.mark.parametrize("case", CASE_NAMES)
def test_ranks_bitwise_equal(runs, case):
    _, _, ranks, _ = runs
    i = CASE_NAMES.index(case)
    a, b = ranks[0][i], ranks[1][i]
    assert a["metrics"] == b["metrics"]
    assert set(a["state"]) == set(b["state"])
    for k, v in a["state"].items():
        assert torch.equal(v, b["state"][k]), k


def test_two_rank_maskformer_step_matches_jax(runs):
    _, _, ranks, (want, wgrads, wstate) = runs
    got = ranks[0][0]
    _check_metrics(want, got["metrics"])
    _check_state(wstate, got["state"], wgrads[-1])


def test_train_cli_two_processes_log_the_same_loss(tmp_path):
    root = write_ade_tree(tmp_path / "ade", n=4, seed=0,
                          shapes=[(70, 80)] * 4, num_labels=4)
    coord = f"localhost:{free_port()}"
    cmd = [sys.executable, "-m", "spike2former_tpu_torch.tools.train",
           FLAGSHIP, "--device", "cpu", "--data-root", root,
           "--work-dir", str(tmp_path / "wd"), "--distributed",
           "--coordinator", coord, "--num-processes", "2",
           "--log-interval", "1", "--eval-images", "0",
           "--cfg-options", *TINY_OPTS, "data.crop_size=(64,64)",
           "data.batch_size=2", "data.num_workers=1",
           "train.total_iters=2", "train.checkpoint_interval=100",
           "train.val_interval=0"]
    procs = [subprocess.Popen(cmd + ["--process-id", str(i)], cwd=REPO,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=_env(),
                              text=True) for i in (0, 1)]
    outs = _communicate(procs)
    logged = []
    for i, out in enumerate(outs):
        assert f"distributed: process {i}/2, 2 global devices" in out, out
        logged.append([ln.split(" loss ")[1].split(" ")[0]
                       for ln in out.splitlines() if ln.startswith("iter ")])
    assert len(logged[0]) == 2 and logged[0] == logged[1], logged
    # rank 0 alone writes the checkpoint and the scalar log
    assert (tmp_path / "wd" / "ckpt_2").exists()
    assert (tmp_path / "wd" / "scalars.jsonl").exists()
