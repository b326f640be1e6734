#!/usr/bin/env python3
"""Drive the PyTorch port (``spike2former_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, each printing one flushed line with the seconds elapsed.  The
entry points draw JAX's own ``model.init`` variables of their seed when
given no weights (``engine/weights.py:init_weights_``, through JAX's
threefry streams, ``utils/jax_random.py``); at flax's init the flagship's
DCN branch is silent (its input and mask spikes are 0), so every phase that
holds a kernel on a model's calls builds it with the tests' draw
(``drawn_model``, ``drawn_trainer``: ``randomize_``, weights whose spikes
fire; the eval and firing CLIs through ``--checkpoint``, the NCCL train
CLI through a ``--resume``d step-0 checkpoint), except (burnin),
(learning) and (init), which run from flax's laws:

  (a) device: torch/CUDA versions, the card's name and power limit;
  (b) build: ``nvcc`` builds ``csrc/dcnv3_sample.cu`` (K1, forward),
      ``csrc/dcnv3_sample_bwd.cu`` (K2, backward),
      ``csrc/dcnv3_sample_grouped.cu`` (the grouped-layout forward, the
      counterpart of K3-K6) and ``csrc/dcnv3_sample_grouped_bwd.cu`` (its
      backward, K7) and ``csrc/threefry.cu`` (JAX's threefry2x32 draws)
      for sm_90a, the five side by side, (bf16 tiny)'s CPU side computed
      beside them on half the cores;
  (c) K1 against its plain PyTorch version at the flagship shapes (serve:
      N in {1, 2}, 32x44; train: N=6, 32x32; G=32, Cg=8, P=9, f32) and
      on a 64x128 map too large for one block's tile, for random
      (off-map), far (up to 10 px, out of the halo), zero-offset and
      integer-coordinate inputs; at the serve and train shapes its time
      with a warm and a cold L2, the plain time, an ``F.grid_sample``
      yardstick and the byte bound;
  (k2) K2 against its plain version at the flagship train shape (N=6,
      32x32) and on the 64x128 map, for the same four kinds of input;
      at the train shape its time with a warm and a cold L2, the plain
      time, the ``F.grid_sample`` backward yardstick and the byte bound;
  (grad) gradients to x, offset and mask through ``dcnv3_core`` at the
      flagship train shape and on the 64x128 map with offsets up to
      10 px, K1 forward and K2 backward, against autograd of the plain
      sampler on the same card tensors;
  (grouped) the grouped-layout kernels under their tile plans
      (``grouped_tile_plan``): the forward in both layouts (gchw for
      K3/K5/K6, ghwc for K4) and the backward (K7) against their plain
      versions and against K1/K2 on the same data, at the flagship's
      full-width shapes (serve: N=1, 32x44; train: N=6, 32x32; G=32,
      Cg=8, P=9) for random, far, off-map, zero-offset, integer and NaN
      coordinates, and at Cg 1-32 with G=4 on a 64x128 map (bands of rows
      with halos), an 8x2048 map (nothing staged from Cg=8 on) and a 9x13
      map (one backward band owns it: no zero-fill); autograd of both
      layouts at the train shape; at both flagship shapes their times
      with a warm and a cold L2 beside K1's and K2's on the same data, the
      plain times, the ``F.grid_sample`` yardsticks and the byte bounds.
      No model path calls them: their launch counts on the serve and
      train paths are read and reported (0);
  (d) the flagship SDTv2 MaskFormer at full width serves 3 requests through
      ``api.inference_model`` (K1 launch count 6 per request); K1 is held
      against the plain version at each of the 6 DCN calls of one request,
      and a tiny model's logits on the card against the CPU's;
  (e) median (and max) ms per request over 30 requests, and peak memory;
  (tf32) ``whole_logits`` on the three requests' images in full f32, with
      torch's default flags (TF32 on for cuDNN) and with TF32 on for both
      cuDNN and matmuls: the share of pixels whose class agrees with f32
      and the largest logit difference; the tiny model's card logits in
      each mode against the CPU's;
  (eval) the eval CLI's ``evaluate`` at full width on a seeded
      ADE20K-layout tree of three images (512x683, 683x512, 512x512) in
      whole mode bucketed to 128 with ``valid_hw``, whole mode exact (pad
      to 32) and slide mode (crop 512, stride 341): each mode's mIoU, ms
      per image and K1 launches per image and window, and the share of
      pixels on which bucketed and exact agree;
  (train) the flagship at full width, at the preset's defaults (the
      on-device auction matcher, ``compact_gt=32``), takes 2 warm-up and 5
      timed train steps through ``api.init_trainer`` / ``api.train_steps``
      at batch 6 and 512x512 crops of seeded synthetic images and
      piecewise-constant semantic maps (K1 and K2 launches 6 each per
      step), each step's ``repaired_gt`` printed; losses finite, the DCN
      offset and mask projections get non-zero gradients; then the same
      step with ``matcher='host'``, 1 warm-up and 3 timed;
  (auction) the cost batch of one flagship step ([42, 100, 32]): the
      card's assignment and ``repaired_gt`` equal the CPU's, each
      problem's total cost within G_valid * eps of scipy's optimum, a run
      capped at one iteration completed by the repair; iterations, host
      reads and ms per call;
  (overflow) one full-width step on a batch with a 36-class crop, which
      takes the full-width branch of ``compact_gt`` on the card; the
      losses at ``compact_gt=32`` against full width (rel 1e-6) on a
      normal batch and on that one;
  (small train) a tiny model's ``total`` loss over 3 steps on the card
      against the CPU's, with the auction and with the host matcher;
  (train cli) the train CLI (``tools.train.main``) at full width on a
      seeded ADE20K-layout tree (12 training images, the 3 val images of
      (eval)) at the preset's defaults: 10 iterations with a checkpoint
      and a val (3 images, an overlay each) every 5, keeping 1, then
      ``--resume`` to 14.  Every logged loss finite; K1 and K2 6 launches
      a train iteration, K1 6 a val image; exactly the files expected;
      each checkpoint, written in the background while the next steps
      update the state in place, equal to the state at its step, and the
      resumed state equal to the file it read, bit for bit; the eval
      CLI's ``--checkpoint best/ckpt_N`` prints the mIoU that the train
      CLI printed at N.  Printed: each log record's s/iter, the steady
      s/iter beside (train)'s step ms, the loader's batches/s alone, the
      step on the loader's batches from memory and under a live loader,
      a save's inline copy ms, write ms and MB;
  (reference) a tiny reference-format state dict
      (``tests/torch_golden.py``'s ``GoldenSpike2Former``) through
      ``load_reference_model`` onto the card, logits against the CPU's,
      and through the eval CLI's ``--torch-checkpoint`` on the card.

The bf16 model (``model.dtype='bfloat16'``) and the bf16 forms of K1 and
K2, run between the phases above:

  (bf16 kernels) K1 on bf16 features against its plain version at the
      serve and train shapes, K2 at the train shape, for the four kinds
      of coordinates: out and dvalue within one bf16 ulp, dpy/dpx/dmask
      within 1e-3 of their largest magnitude; warm and cold ms, plain ms,
      the ``F.grid_sample`` yardstick on bf16 (and its backward), the byte
      bounds, and the registers of the bf16 Cg=8 instantiations from the
      build log;
  (bf16 serve) the full-width flagship at bf16, with the f32 model's
      seeded weights, serves the three images of (serve): 6 bf16 K1
      launches a request, finite logits, class agreement and the largest
      logit gap against the f32 model, median request ms, peak memory;
  (bf16 train) batch 6 of 512x512 at the preset's defaults at bf16, then
      with ``model.remat=True`` and ``train.packed_residuals=True``: step
      ms and peak memory of each, bf16 K1/K2 launches (K1 12 a step under
      remat: the recomputation samples again), finite losses, the first
      step's losses equal across the two within 1e-5 relative;
  (bf16 tiny) the tiny model at bf16, card against CPU: class agreement
      >= 0.99 and the largest logit gap <= 0.064 at 64x64, and 3 train
      steps' ``total`` within 2e-2 relative.

Firing rates, TTA and the Inferencer, point-sampled losses and the other
SDTv2 MaskFormer presets, run between the phases above:

  (firing) ``tools/cal_firing_num.py`` at full width on a seeded ADE20K
      tree of four images (T=1 without the collapse, every decoder layer
      through the SDME sites, 512x512 centre crops): the site count, the
      energy proxy, the CLI's wall time and a warm forward's with the
      statistics, K1 6 launches an image; the tiny model's rates (T=2) on
      the card against the CPU's, within 1e-6, with the same keys;
  (tta) a full-width ``tta_logits`` request, flip x scales 0.75, 1.0,
      1.25 of a 512x512 image: ms and K1 launches (6 a variant); the tiny
      model's TTA card against CPU; ``api.Inferencer`` on two images,
      its overlays and K1 launches;
  (point train) the flagship step at ``train.loss_points=12544`` (batch
      6, 512x512, the preset's auction and ``compact_gt``) beside
      (train)'s GT-resolution step: wall and device ms (``torch.profiler``)
      and peak memory of each, K1 and K2 6 launches a step, finite
      losses; ``maskformer_loss`` with points on small inputs, card
      against CPU on the same uniforms: losses within 1e-5 relative,
      gradients within 1e-4 of the largest;
  (presets) seeded Cityscapes (1024x2048) and COCO-Stuff trees through
      the port's converters; the eval CLI on two images of each (the
      Cityscapes preset at its (2048, 1024) scale; the tests' draw as
      ``--checkpoint``), K1 6 launches an
      image; one Cityscapes train step at batch 2 and 512x1024 after a
      warm-up (K1 and K2 6 a step).

Every K1 and K2 call of one run of each of these paths is held to the
plain version on the same card tensors, and K1 and K2 are timed at the
Cityscapes shapes with their bounds.

The micro-batching ServingEngine, the tools and the SDTv3 family, run
between the phases above (f32, full width, seeded images and weights):

  (serving) the flagship through ``ServingEngine(max_batch=16,
      bucket=128)``: 64 requests of 512x683, 683x512, 512x512 and 384x512
      submitted by 4 threads at once (img/s, p50/p99, the histogram of
      micro-batch sizes, peak memory, K1 6 launches a micro-batch); the
      same traffic again with each request's logits held to its
      bucket-padded image served alone (N=1, the same ``valid_hw``,
      1e-3), its future's class map held to its own logits (its row of
      the batch its image, the map their argmax) and to the alone map
      up to ties (>= 0.99 of pixels equal or within twice the request's
      logit difference: random weights' class scores lie ~1e-6 apart),
      and every K1 call held to its plain version at each N it was
      handed; the same 64 one at a time (N=1; the micro-batched maps'
      strict agreement with these reported), and a loop of
      ``inference_model`` (img/s beside the engine's); K1 timed at the
      largest micro-batch.  Every future must resolve with a class map;
  (tools) ``tools/benchmark.py`` for 10 forwards and 3 train steps at
      batch 6 with ``--mfu``: FLOPs finite and positive, the MFU in
      (0, 1), the peak the card's own for f32; ``tools/export.py`` of the
      flagship at batch 1: 6 calls of K1's operator in the graph, the
      program saved, loaded back and run within 1e-6 of eager;
      ``ServingEngine.close()`` with requests queued fails them;
  (sdtv3), (sdtv3mae) ``SDTv3_b_Spike2former_ade20k_512x512`` and
      ``SDTv3MAE_Spike2former_ade20k_512x512``: 3 requests (K1 held at
      each DCN call), 3 train steps at batch 6 of 512x512 after a
      warm-up (finite losses, non-zero DCN gradients, K1 and K2 6 each,
      K2 held to plain), request and step ms, device ms and peak memory;
      the tiny model card vs CPU (1e-3); a reference-format state dict of
      the variant loaded strictly onto the card (logits vs CPU, 1e-3).

COCO panoptic, the Mask2Former head and the DAB-DETR decoder, run after
them (f32, full width, seeded data and weights):

  (panoptic) a seeded COCO-panoptic tree (3 val images of 480x640,
      640x480 and 427x640, 4 train images; things, stuff, a crowd and
      VOID in each): the eval CLI's ``evaluate_panoptic`` on
      ``SDTv2_maskformer_coco_panoptic`` (ms an image, K1 6 launches an
      image, maps at the original shapes) and its ``main`` (the PQ line);
      ``whole_panoptic`` of a tiny confident model on the card against the
      CPU (sem and inst equal on >= 0.99 of the pixels, some kept) and
      the merge on confident inputs equal to its CPU run;
      ``whole_panoptic`` alone on the padded images (ms, device ms); a
      host batch's time, the H2D copies of its masks in f32 and uint8, and
      the step on it from memory; the train CLI for 3 iterations at batch
      6 of 512x512 (s/iter, peak memory,
      K1 and K2 6 launches an iteration, finite losses, no val, the final
      checkpoint);
  (m2f), (dab) the flagship with ``model.masked_attention=True`` and with
      ``model.decoder='dab'``, each taking turns with a fresh flagship:
      9 requests each (3 passes over the 3 of (d)) and 3 train steps each
      at batch 6 of 512x512, a warm-up and 2 timed (K1 6 a request, K1
      and K2 6 a step, every captured call of one more request and one
      more step of the variant held to its plain version): request and
      step ms and peak memory of both, the variant step's device ms.

The FPN family (no DCN: K1 and K2 must read 0 launches on each of its
paths, each counted from 0 just before it), run last (f32, full width,
seeded data and weights):

  (fpn) ``fpn_sdtv3_512x512_19M_ade20k`` (SDTv3 backbone at embed (48,
      96, 192, 256), neck 256, head 128, 150 classes, T=4 over every
      step) serves the three images of (d) through
      ``api.inference_model``: median and max ms over 10 requests, peak
      memory; the tiny model (the same preset at tiny widths, T=2) on the
      card against the CPU: class agreement >= 0.99 and the largest logit
      gap, and 3 train steps' ``total`` within ``TRAIN_RTOL`` (the same
      dropout masks on both, from a CPU generator);
  (fpn train) the same preset at its own defaults (batch 6 of 512x512,
      the backbone's BN trained): 2 warm-up and 3 timed steps, step ms,
      peak memory, finite losses, non-zero neck and head gradients (a
      batch that does not fit is halved, and the peak that failed
      printed);
  (fpn family) ``fpn_msresnet104_512x512_ade20k`` and
      ``cascade_fpn_sdtv2_512x512_ade20k``: a request and a step each at
      full width (the cascade's per-stage losses printed); the eval CLI
      (``tools.test.main``) in whole and slide mode on (eval)'s three
      images and the train CLI for 2 iterations with a checkpoint and a
      val, then ``--resume`` to 3, with the 19M preset.

The bf16 forms of K3-K7 (run after (bf16 kernels)), the FPN family at
bf16, DDD17 and the deformable modules (run after the FPN phases):

  (grouped bf16) the grouped forward on bf16 features in both layouts,
      each JAX name with its column rounding (K3, K6 round the column
      weights to bf16; K4, K5 keep them f32), and the grouped backward
      (K7's bf16 form) under their plans against their plain versions
      (which round where the JAX kernels round): out and dfeat within one
      bf16 ulp, dpy/dpx/dmask within ``BF16_GRAD_RTOL``, at the flagship
      shapes for every kind of coordinates and at every Cg of
      ``CHANNELS`` on ``GROUPED_MAPS`` (random and NaN coordinates), and
      with 4 and 25 points at the serve shape and at every Cg on the
      9x13 map, every kind; autograd of the gchw form at the train
      shape; warm and cold ms, plain ms, the ``F.grid_sample`` yardstick
      on bf16, the byte bound, K3's bf16 form on 'random' and 'far'
      coordinates in turns with its f32 form on the same data, and the
      registers and spilled bytes of the bf16 Cg=8 instantiations (the
      forward's must spill nothing).  No model path calls them (their
      launches on every path read 0);
  (fpn bf16) ``fpn_sdtv3_512x512_19M_ade20k`` at ``model.dtype=bfloat16``
      beside the f32 preset (the same seeded weights): the three request
      images in turns, request ms and peak memory of each, bf16 against
      f32 class agreement and logit gap; a warm-up and 2 train steps at
      batch 6 of 512x512 of each in turns, step ms, peak memory, finite
      losses; K1/K2 0 launches; the tiny model at bf16 card vs CPU;
  (ddd17) the flagship preset with ``data.dataset=ddd17
      model.num_classes=6`` on a seeded DDD17 tree of 2-channel 200x352
      event frames written as ``.npy`` by the port's ``events``
      converter: the eval CLI whole (K1 6 a frame) and the train CLI for
      2 iterations (K1 and K2 6 an iteration);
  (deformable) the deformable encoder (6 layers, 256 channels, 8 heads,
      4 points over the /8, /16 and /32 maps of a 512x512 image) and the
      Transformer-encoder and FPN pixel decoders at the flagship head's
      widths, card against CPU on the same seeded weights and inputs.

Data-parallel training and the library modules of slice fifteen, run
last:

  (distributed) NCCL's all-reduce on one rank; the train CLI with
      ``--distributed --num-processes 1`` (NCCL) at full width, batch 6 of
      512x512, 3 iterations ``--resume``d from a step-0 checkpoint of the
      tests' draw: its first line, finite logged losses, K1 and
      K2 6 launches an iteration, each call held to its plain version,
      s/iter; then two ranks over gloo on the one card (this script run
      as ``--ddp-worker``), one row each of global batches of 2, against
      this process taking the whole batches, for the tiny model at 64x64
      (every metric within 2e-4 relative, the parameters' fingerprint
      within 2e-5) and the flagship at full width at 128x128 (the gap
      reported: one flipped q8 level moves its losses by percents); the
      ranks' metrics and parameters bitwise equal, K1/K2 6 launches a
      step on each rank;
  (library) on the card against a CPU copy with the same seeded weights
      and inputs: ``SpikeformerDecoderLayer`` (256 channels, 8 heads, 100
      queries, T=4, 64x64 keys), ``QueryProposal`` (150 classes, 100
      queries, 128x128), ``CycleBlock`` (dim 256), the three spiking RNNs,
      an ANN->SNN conversion at T=32 (calibration scales and outputs);
      whether the native image runtime builds here, and where it does, its
      decode and resize against PIL and ``F.interpolate``.

K1 with a first output row, after the bf16 kernels, and tensor
parallelism and row-sharded inference of slice sixteen, run last:

  (k1 rows) K1 in f32 and bf16 on each half of the output rows of the ADE
      32x32 and the Cityscapes 64x128 /16 maps (G=32, Cg=8; the second
      banded), the whole map as value and the first row a kernel
      argument, for 'random', 'far', 'zero' and 'integer' coordinates:
      within 2e-5 of the plain version in f32 and one bf16 ulp in bf16,
      and bitwise the whole map's launch's rows; each half's time (warm
      and cold L2), its byte bound (the value rows its taps touch, its
      coordinates and outputs), the ``F.grid_sample`` yardstick and the
      whole map's launch beside it;
  (jax random) run after (k1 rows): ``csrc/threefry.cu`` against its
      plain version on the card, bitwise: bits, uniforms and keep masks
      for a 0-d, an odd, a 3-d and the FPN-19M step's 50 M-element
      dropout shape, and blocks of one axis against the slice of the
      whole draw; threefry2x32's known-answer vectors and recorded
      ``jax.random`` / flax keys and draws; the kernel's mask and uniform
      times at 50 M elements beside ``torch.rand``, the plain version and
      the bound; the flagship's full-width ``init_weights_(seed=0)`` on
      the card, timed and held entry by entry to the digest of JAX's
      ``model.init(PRNGKey(0))`` (``tests/jax_init_digest.json``);
  (tp) two gloo ranks on the one card (this script as ``--par-worker``),
      model axis 2: the flagship at full width split (FFN hidden 1024 and
      2048, the mask-embed MLP) serves a 512x512 image in f32 and bf16
      and takes two train steps at 128x128, batch 2 (the second timed
      and compared), against this process unsplit; four ranks take the tiny model's DP2 x TP2 step (within
      2e-4 of one process);
  (spatial) the flagship at 512x512 and the Cityscapes preset at its
      whole 1024x2048 image, in f32 and bf16, in two row bands against
      this process; the tiny model at 64x64 in four (within 2e-5).  At
      full width the ranks are bitwise equal, >= 0.99 of the logits within
      1e-3 of one process and >= 0.99 of the pixels' classes equal, the
      worst element printed; K1 6 launches a rank and image (each f32
      call held to its plain version), ms and peak GiB of every rank
      beside one process's.
  (spatial families) two gloo ranks on the one card against this
      process, as (spatial): ``SDTV3_CITY`` at full width on its whole
      1024x2048 image in f32 and bf16; then, in one launch, the flagship's
      bucketed eval of a 683x512 image (``valid_hw``), its Mask2Former
      and DAB-DETR forms, the panoptic preset (its merge, on confident
      weights) and SDTv3-MAE at 512x512, and the FPN family's 19M preset
      in bf16, MS-ResNet-18 (bands at /32) and the cascade in bf16 at
      512x512.
      The ranks bitwise equal, >= 0.99 of the logits within 1e-3 of one
      process and >= 0.99 of the classes (panoptic: of ``sem`` and
      ``inst``) equal; K1 6 launches a rank and image on every MaskFormer
      path, each call held to its plain version (bf16: within one ulp);
      ms and peak GiB a rank beside one process's.

The repository's training tools and flax's initial weights, run last
(bf16, seeded data, flax's laws: each tool's own start):

  (burnin) ``tools/burnin.py``'s port at full width (the module's
      defaults, 150 classes, 512x512, batch 4): 24 steps, a checkpoint
      every 6, a simulated crash at 15 (the newest checkpoint, ckpt_12,
      restored into a fresh state and held to its file bit for bit, then
      steps 13-24), a val every 12: every logged loss finite, its JSON
      line, bf16 K1 and K2 6 launches a step run (27) and K1 6 a val
      forward (2), s a step and peak memory, the largest share of non-zero
      DCN mask spikes in a call; the first step's K1 and K2 calls and the
      first val forward's held to their plain versions (zeros: the DCN
      branch is silent) and again on their grids (``hold_on_grid``);
  (learning) ``tools/learning_run.sh``'s port on a generated set of 16
      train and 4 val images at 512x512 for 10 iterations (val every 5,
      a checkpoint at 10) and its report: the report's val rows equal to
      ``scalars.jsonl``'s mIoU records, its sha256 that of ckpt_10, bf16
      K1 and K2 6 launches an iteration and K1 6 a val image, the calls
      held as (burnin)'s;
  (init) the flagship at full width from ``api.init_trainer`` without
      weights with the learning run's recipe (bf16, batch 8, 512x512, 30
      classes): its init's threefry launches (one an entry of a random
      law), its variables JAX's ``model.init(PRNGKey(0))`` entry by entry
      (``tests/jax_init_digest.json``), the laws' constants exactly, the std of the
      five largest random entries within 2% of their laws'; 10 steps, 6
      bf16 K1 and K2 launches each a step, finite losses; the share of
      non-zero DCN mask spikes per layer at steps 1 and 10; the first
      step's K1 and K2 calls held as (burnin)'s.

It then prints the ``kernels`` JSON line, the ``nvidia-smi`` name and power
limit, and as its last line ``{"ok": true, "device": {...}}``.  Any failed
phase raises, so the script exits non-zero and prints no result; it also
exits non-zero when no CUDA device is available.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import hashlib
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from PIL import Image

from spike2former_tpu_torch import api, parallel
from spike2former_tpu_torch.data.dataset import make_dataset
from spike2former_tpu_torch.data.loader import TrainLoader
from spike2former_tpu_torch.data.panoptic import PanopticDataset
from spike2former_tpu_torch.data.transforms import test_pipeline
from spike2former_tpu_torch.data.synthetic import (ADE_LIKE_SHAPES,
                                                    CITYSCAPES_SHAPE,
                                                    COCO_LIKE_SHAPES,
                                                    confident_merge_inputs,
                                                    synthetic_batch,
                                                    write_ade_tree,
                                                    write_cityscapes_tree,
                                                    write_coco_panoptic_tree,
                                                    write_coco_stuff_tree,
                                                    write_ddd17_tree)
from spike2former_tpu_torch.device import f32_precision
from spike2former_tpu_torch.engine import checkpoint
from spike2former_tpu_torch.engine.checkpoint import load_reference_model
from spike2former_tpu_torch.engine.config import (TestConfig, build_model,
                                                  get_config)
from spike2former_tpu_torch.engine.train import Trainer
from spike2former_tpu_torch.engine.logging import read_scalars
from spike2former_tpu_torch.engine.inference import (bucket_hw,
                                                      postprocess_pred,
                                                      whole_panoptic,
                                                      slide_origins,
                                                      whole_logits)
from spike2former_tpu_torch.engine.weights import (init_laws, init_weights_,
                                                   randomize_)
from spike2former_tpu_torch.evaluation.tta import (panoptic_inference,
                                                   tta_logits)
from spike2former_tpu_torch.losses import criterion
from spike2former_tpu_torch.losses import matcher
from spike2former_tpu_torch.losses.matcher import BIG_COST, auction_match
from spike2former_tpu_torch.models.segmentor import Spike2Former, preprocess
from spike2former_tpu_torch.ops import cuda_build, dcnv3, dcnv3_grouped
from spike2former_tpu_torch.ops.resize import resize_bilinear
from spike2former_tpu_torch import serving
from spike2former_tpu_torch.profile_train import STAGES, sync_sites
from spike2former_tpu_torch.serving import ServingEngine
from spike2former_tpu_torch.tools import (benchmark, burnin,
                                          cal_firing_num,
                                          dataset_converters, export,
                                          learning_run)
from spike2former_tpu_torch.tools import test as eval_cli
from spike2former_tpu_torch.tools import train as train_cli
from spike2former_tpu_torch.utils.firing import energy_proxy, firing_rates
from spike2former_tpu_torch.utils.flops import peak_tflops
from spike2former_tpu_torch.utils import jax_random as jr

PRESET = "SDTv2_maskformer_DCNpixelDecoder_ade20k"
KERNEL_TOL = 2e-5     # f32 sampler against its plain version
# K2 against its plain version: tests/test_dcnv3.py's backward tolerance;
# the kernel's atomics sum dvalue in a varying order
BWD_ATOL, BWD_RTOL = 3e-4, 1e-3
MODEL_TOL = 1e-3      # tiny-model logits, card against CPU
# tiny-model ``total`` loss after 3 train steps, card against CPU: the
# end-to-end tolerance of the inference check
TRAIN_RTOL = 1e-3
WARMUP_STEPS, TIMED_STEPS = 2, 5
HOST_WARMUP_STEPS, HOST_TIMED_STEPS = 1, 3
EVAL_PASSES = 3               # timed passes over the eval tree per mode
AUCTION_EPS = 0.02            # auction_match's eps: the optimality bound
# the auction's chunk schedules timed against each other: (first, most)
# iterations between reads of the loop condition
AUCTION_CHUNKS = ((4, 512), (8, 8), (16, 16), (4, 16))
COMPACT_RTOL = 1e-6           # compact_gt losses against full width
FIRING_TOL = 1e-6   # a site's rate, card against CPU (f32 means of spikes)
POINT_WARMUP, POINT_TIMED = 1, 3       # the loss_points steps
CS_WARMUP, CS_TIMED = 1, 3             # the Cityscapes steps
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12     # H100 SXM f32, outside the tensor cores
REQUEST_SHAPES = ((512, 683), (683, 512), (512, 512))
FLUSH_BYTES = 128 * 2 ** 20   # more than the H100's 50 MB L2
TINY = dict(num_classes=5, embed_dim=(8, 16, 24, 32), backbone_heads=4,
            feat_channels=16, num_queries=4, num_decoder_layers=1,
            num_encoder_layers=1, depths_stage3=1, depths_stage4=1,
            dcn_group=4)

T0 = time.perf_counter()



def drawn_model(config, *, overrides=None, seed: int = 0, **kw
                ) -> api.InferenceModel:
    """``api.init_model`` with the tests' draw (``randomize_`` from
    ``seed``, made on the CPU and handed in as its state dict) in place
    of the entry point's own init: weights whose spikes fire, so every
    kernel this script holds sees non-zero inputs.  (init), (burnin) and
    (learning) run from the entry points' own init instead."""
    cfg = get_config(config, overrides) if isinstance(config, str) else config
    sd = randomize_(build_model(cfg.model), seed).state_dict()
    return api.init_model(cfg, seed=seed, state_dict=sd, **kw)


def drawn_trainer(config, overrides=None, *, seed: int | None = None,
                  **kw) -> Trainer:
    """``api.init_trainer`` with the tests' draw (as ``drawn_model``),
    from ``seed`` or the config's ``train.seed``."""
    cfg = get_config(config, overrides) if isinstance(config, str) else config
    seed = cfg.train.seed if seed is None else seed
    sd = randomize_(build_model(
        cfg.model, packed_residuals=cfg.train.packed_residuals),
        seed).state_dict()
    return api.init_trainer(cfg, seed=seed, state_dict=sd, **kw)


def drawn_checkpoint(path: str, preset: str = PRESET) -> str:
    """Save the tests' draw (seed 0) of ``preset``'s model as a state dict
    at ``path``, for the eval and firing CLIs' ``--checkpoint``; returns
    ``path``."""
    torch.save(randomize_(build_model(get_config(preset).model))
               .state_dict(), path)
    return path

def log(phase: str, msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f}s] {phase}: {msg}", flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def cuda_ms(fn, iters: int = 100, warmup: int = 5, cold: bool = False
            ) -> float:
    """Mean device ms of ``fn`` over ``iters`` calls.  A spin kernel holds
    the device first, so the host enqueues every call before the timed
    work starts and the events time device work, not the host's per-call
    cost.  ``cold``: a 128 MB buffer is written before each call, and only
    the calls are timed, so each finds its inputs in device memory, not in
    L2."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if not cold:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200_000_000)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    buf = torch.empty(FLUSH_BYTES // 4, device="cuda")
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(200_000_000)
    for i, (start, end) in enumerate(events):
        buf.fill_(float(i))
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def median_ms(fn, reps: int = 5) -> float:
    """Median over ``reps`` runs of ``cuda_ms``."""
    return statistics.median(cuda_ms(fn) for _ in range(reps))


def host_ms(fn, iters: int = 100) -> float:
    """Mean wall ms per call, host overhead included, as the main path
    pays it."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / iters


def grid_sample_yardstick(value, py, px, mask):
    """The same function by ``F.grid_sample``: timed only, never called by
    the port."""
    n, h, w, c = value.shape
    _, howo, g, p = py.shape
    cg = c // g
    feat = value.view(n, h, w, g, cg).permute(0, 3, 4, 1, 2).reshape(
        n * g, cg, h, w)
    grid = torch.stack(((px + 0.5) / w * 2 - 1, (py + 0.5) / h * 2 - 1), -1)
    grid = grid.permute(0, 2, 1, 3, 4).reshape(n * g, howo, p, 2)
    s = F.grid_sample(feat, grid, mode="bilinear", padding_mode="zeros",
                      align_corners=False)              # [n*g, cg, howo, p]
    m = mask.permute(0, 2, 1, 3).reshape(n * g, 1, howo, p)
    out = (s * m).sum(-1)
    return out.view(n, g, cg, howo).permute(0, 3, 1, 2).reshape(n, howo, c)


def sampler_inputs(n, h, w, g, cg, p, kind, gen, device="cuda"):
    """value [N, H, W, G*Cg] and [N, HoWo, G, P] coordinates and mask
    around each output pixel's 3x3 grid.  ``kind``: 'random' offsets
    (3 px standard deviation: some taps leave the map), 'far' offsets
    (uniform in +-10 px: most taps leave a band's halo), 'zero' offsets
    (every coordinate an exact integer, one-hot centre mask: the
    identity), 'integer' offsets (exact integer coordinates, random
    mask)."""
    value = torch.randn((n, h, w, g * cg), generator=gen)
    k = int(round(p ** 0.5))
    ii, jj = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    kx, ky = torch.meshgrid(torch.arange(k), torch.arange(k), indexing="ij")
    by = (ii.reshape(-1, 1) + ky.reshape(1, -1) - k // 2).float()
    bx = (jj.reshape(-1, 1) + kx.reshape(1, -1) - k // 2).float()
    shape = (n, h * w, g, p)
    by = by[None, :, None].expand(shape)
    bx = bx[None, :, None].expand(shape)
    mask = torch.rand(shape, generator=gen)
    if kind == "random":
        py = by + 3 * torch.randn(shape, generator=gen)
        px = bx + 3 * torch.randn(shape, generator=gen)
    elif kind == "far":
        py = by + 20 * torch.rand(shape, generator=gen) - 10
        px = bx + 20 * torch.rand(shape, generator=gen) - 10
    elif kind == "integer":
        py = by + torch.randint(-3, 4, shape, generator=gen).float()
        px = bx + torch.randint(-3, 4, shape, generator=gen).float()
    elif kind == "zero":
        py, px = by.clone(), bx.clone()
        mask = torch.zeros(shape)
        mask[..., p // 2] = 1.0
    else:
        raise ValueError(kind)
    return tuple(t.contiguous().to(device) for t in (value, py, px, mask))


def sampler_bytes(value, py, out_elems):
    return 4 * (value.numel() + 3 * py.numel() + out_elems)


# the flagship's /16 maps of a request (N=1, 2 at 32x44) and of a train
# step (N=6 at 32x32), and a 64x128 map (a 1024x2048 image's), on which no
# group fits one block of K2 and both kernels run bands with halos
KERNEL_SHAPES = ((1, 32, 44), (2, 32, 44), (6, 32, 32), (1, 64, 128))
# coordinates 3 px off their grid, up to 10 px off (most taps leave a
# band's halo), zero offsets (exact integers, the identity), integer offsets
KINDS = ("random", "far", "zero", "integer")
CHANNELS = (1, 2, 4, 8, 16, 32)    # the kernels' channels a group


def phase_kernel(gen) -> dict:
    """(c): K1 against plain on ``KERNEL_SHAPES`` for each of ``KINDS``;
    its time with a warm and a cold L2 beside the grouped forward's on the
    same data, the plain time, the yardstick and the byte bound."""
    g, cg, p = 32, 8, 9
    worst = 0.0
    rec = {}
    for n, h, w in KERNEL_SHAPES:
        plan = dcnv3.tile_plan(n, h, w, h * w, g, cg, p, backward=False)
        log("kernel", f"N={n} {h}x{w}: tile plan {plan}, "
            f"{plan.smem_bytes(w, cg, p, backward=False)} bytes of shared "
            "memory a block")
        for kind in KINDS:
            value, py, px, mask = sampler_inputs(n, h, w, g, cg, p, kind, gen)
            got = dcnv3.dcnv3_sample(value, py, px, mask)
            torch.cuda.synchronize()
            want = dcnv3.dcnv3_sample_reference(value, py, px, mask)
            err = (got - want).abs().max().item()
            check(bool(torch.isfinite(got).all()), f"non-finite kernel out "
                  f"({kind}, N={n} {h}x{w})")
            check(err <= KERNEL_TOL, f"kernel vs plain {err:.3g} > "
                  f"{KERNEL_TOL} ({kind}, N={n} {h}x{w})")
            if kind == "zero":
                ident = (got - value.reshape(got.shape)).abs().max().item()
                check(ident <= KERNEL_TOL, f"identity case off by {ident:.3g}")
            worst = max(worst, err)
            log("kernel", f"N={n} {h}x{w} G={g} Cg={cg} P={p} {kind}: "
                f"max|kernel-plain|={err:.3g}")
        if h * w <= 32 * 44:
            rec[n] = k1_timing(n, h, w, gen)
    rec["max_abs_err"] = worst
    return rec


def k1_timing(n, h, w, gen, tag: str = "kernel") -> dict:
    """K1's time on random coordinates at N x h x w (G=32, Cg=8, P=9)
    with a warm and a cold L2, the plain time, the ``F.grid_sample``
    yardstick and the byte and operation bounds."""
    g, cg, p = 32, 8, 9
    value, py, px, mask = sampler_inputs(n, h, w, g, cg, p, "random", gen)
    lib_err = (grid_sample_yardstick(value, py, px, mask)
               - dcnv3.dcnv3_sample_reference(value, py, px, mask)
               ).abs().max().item()
    out_elems = n * h * w * g * cg
    bytes_ = sampler_bytes(value, py, out_elems)
    flops = n * h * w * g * p * (4 * cg * 2 + 16)

    def k1():
        return dcnv3.dcnv3_sample(value, py, px, mask)

    t = dict(
        ms=median_ms(k1),
        cold_ms=cuda_ms(k1, cold=True),
        plain_ms=cuda_ms(lambda: dcnv3.dcnv3_sample_reference(
            value, py, px, mask), iters=20),
        library_ms=cuda_ms(lambda: grid_sample_yardstick(
            value, py, px, mask), iters=20),
        bytes_ms=bytes_ / HBM_BYTES_PER_S * 1e3,
        ops_ms=flops / F32_FLOPS_PER_S * 1e3,
        wall_ms=host_ms(k1))
    log(tag, f"K1 N={n} {h}x{w} timing: kernel_ms={t['ms']:.5f} "
        f"cold_l2_ms={t['cold_ms']:.5f} plain_ms={t['plain_ms']:.5f} "
        f"library_ms={t['library_ms']:.5f} "
        f"(grid_sample max|diff|={lib_err:.3g}) "
        f"byte_bound_us={t['bytes_ms'] * 1e3:.3f} "
        f"op_bound_us={t['ops_ms'] * 1e3:.3f} "
        f"wrapper_wall_ms={t['wall_ms']:.5f}")
    return t


def phase_serve(im) -> dict:
    """(d) and (e): three flagship requests through the user entry point."""
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
            for hw in REQUEST_SHAPES]

    zero_launches()
    preds = [api.inference_model(im, img) for img in imgs]
    torch.cuda.synchronize()
    launches = dcnv3.dcnv3_sample.launches
    grouped = grouped_launches()
    grouped_bf16 = grouped_bf16_launches()
    log("serve", f"3 requests served; dcnv3_sample launches={launches}, "
        f"grouped forward/backward launches={grouped} (bf16 "
        f"{grouped_bf16})")
    check(launches == 6 * len(imgs),
          f"expected {6 * len(imgs)} DCN kernel launches, got {launches}")
    for img, pred in zip(imgs, preds):
        check(pred.shape == img.shape[:2] and pred.dtype == np.int32,
              f"pred {pred.shape} {pred.dtype} for image {img.shape}")
        check(0 <= pred.min() and pred.max() < im.num_classes,
              "class ids out of range")
        log("serve", f"image {img.shape[:2]} -> classes in use "
            f"{len(np.unique(pred))}")

    # logits of one request are finite and of the expected shape
    x = torch.zeros((1, 512, 704, 3), dtype=torch.uint8, device="cuda")
    x[:, :, :683] = torch.from_numpy(imgs[0]).cuda()
    logits = whole_logits(im.model, x)
    check(tuple(logits.shape) == (1, 512, 704, im.num_classes)
          and bool(torch.isfinite(logits).all()), "bad logits")

    # the kernel against its plain version at each DCN call of a request
    real = dcnv3.dcnv3_sample
    calls = []

    def capture(value, py, px, mask):
        out = real(value, py, px, mask)
        calls.append((value.clone(), py.clone(), px.clone(), mask.clone(),
                      out.clone()))
        return out

    dcnv3.dcnv3_sample = capture
    try:
        api.inference_model(im, imgs[0])
    finally:
        dcnv3.dcnv3_sample = real
    check(len(calls) == 6, f"captured {len(calls)} DCN calls, expected 6")
    worst = 0.0
    for i, (value, py, px, mask, out) in enumerate(calls):
        err = (out - dcnv3.dcnv3_sample_reference(value, py, px, mask)
               ).abs().max().item()
        live = (mask != 0).float().mean().item()
        log("serve", f"DCN call {i}: value {tuple(value.shape)} "
            f"max|kernel-plain|={err:.3g} mask nonzero={live:.3f}")
        check(err <= KERNEL_TOL, f"DCN call {i}: {err:.3g} > {KERNEL_TOL}")
        worst = max(worst, err)

    # (e) timing after warm-up
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(10):
        for img in imgs:
            torch.cuda.synchronize()
            t = time.perf_counter()
            api.inference_model(im, img)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
    return dict(launches=launches, grouped=grouped,
                grouped_bf16=grouped_bf16, max_abs_err=worst,
                request_ms=statistics.median(times), max_ms=max(times),
                n=len(times),
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)


def phase_small_reference() -> float:
    """A tiny model's logits on the card (kernel path) against the same
    model on the CPU (plain path) at 64x64, in f32 as the entry points
    run it (this calls below them)."""
    cpu = randomize_(Spike2Former(T=1, **TINY), seed=1)
    gpu = copy.deepcopy(cpu).cuda()
    x = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (1, 64, 64, 3)).astype(np.float32))
    with torch.inference_mode(), f32_precision():
        want = cpu.predict_logits(x)
        got = gpu.predict_logits(x.cuda()).cpu()
    err = (got - want).abs().max().item()
    check(torch.allclose(got, want, atol=MODEL_TOL, rtol=MODEL_TOL),
          f"tiny model card vs CPU: max|diff|={err:.3g}")
    return err


def phase_backward_kernel(gen) -> dict:
    """(k2): K2 against plain at the flagship train shape (/16 of a 512
    crop, batch 6) and on the 64x128 map, for each of ``KINDS``; its time
    at the train shape with a warm and a cold L2."""
    g, cg, p = 32, 8, 9
    worst = 0.0
    for n, h, w in ((6, 32, 32), (1, 64, 128)):
        plan = dcnv3.tile_plan(n, h, w, h * w, g, cg, p, backward=True)
        log("k2", f"N={n} {h}x{w}: tile plan {plan}, "
            f"{plan.smem_bytes(w, cg, p, backward=True)} bytes of shared "
            f"memory a block, {n * g // plan.groups * plan.bands} blocks, "
            f"whole map {plan.whole(h)}")
        for kind in KINDS:
            value, py, px, mask = sampler_inputs(n, h, w, g, cg, p, kind,
                                                 gen)
            dout = torch.randn((n, h * w, g * cg), generator=gen).cuda()
            got = dcnv3.dcnv3_sample_backward(value, py, px, mask, dout)
            torch.cuda.synchronize()
            want = dcnv3.dcnv3_sample_backward_reference(value, py, px,
                                                         mask, dout)
            errs = []
            for name, gv, wv in zip(("dvalue", "dpy", "dpx", "dmask"), got,
                                    want):
                check(bool(torch.isfinite(gv).all()),
                      f"non-finite K2 {name} ({kind}, {h}x{w})")
                check(torch.allclose(gv, wv, atol=BWD_ATOL, rtol=BWD_RTOL),
                      f"K2 {name} vs plain beyond atol {BWD_ATOL} rtol "
                      f"{BWD_RTOL} ({kind}, {h}x{w}): "
                      f"{(gv - wv).abs().max().item():.3g}")
                errs.append((gv - wv).abs().max().item())
                worst = max(worst, errs[-1])
            log("k2", f"N={n} {h}x{w} G={g} Cg={cg} P={p} {kind}: "
                f"max|kernel-plain| dvalue={errs[0]:.3g} dpy={errs[1]:.3g} "
                f"dpx={errs[2]:.3g} dmask={errs[3]:.3g}")

    return dict(k2_timing(6, 32, 32, gen), max_abs_err=worst)


def k2_timing(n, h, w, gen, tag: str = "k2") -> dict:
    """K2's time on random coordinates at N x h x w (G=32, Cg=8, P=9)
    with a warm and a cold L2, the plain time, the ``F.grid_sample``
    backward yardstick and the byte and operation bounds."""
    g, cg, p = 32, 8, 9
    value, py, px, mask = sampler_inputs(n, h, w, g, cg, p, "random", gen)
    dout = torch.randn((n, h * w, g * cg), generator=gen).cuda()
    # the yardstick: F.grid_sample's backward and the weighted sum's,
    # through autograd on a graph built once
    ins = [t.clone().requires_grad_() for t in (value, py, px, mask)]
    lib_out = grid_sample_yardstick(*ins)
    lib_grads = torch.autograd.grad(lib_out, ins, dout, retain_graph=True)
    want = dcnv3.dcnv3_sample_backward_reference(value, py, px, mask, dout)
    lib_err = " ".join(f"{name}={(a - b).abs().max().item():.3g}"
                       for name, a, b in zip(("dvalue", "dpy", "dpx",
                                              "dmask"), lib_grads, want))
    coords = py.numel()
    bytes_ = 4 * (2 * value.numel() + 6 * coords + dout.numel())
    flops = coords * (4 * 4 * cg + 40)
    def k2():
        return dcnv3.dcnv3_sample_backward(value, py, px, mask, dout)

    t = dict(
        ms=median_ms(k2),
        cold_ms=cuda_ms(k2, cold=True),
        plain_ms=cuda_ms(lambda: dcnv3.dcnv3_sample_backward_reference(
            value, py, px, mask, dout), iters=10),
        library_ms=cuda_ms(lambda: torch.autograd.grad(
            lib_out, ins, dout, retain_graph=True), iters=20),
        bytes_ms=bytes_ / HBM_BYTES_PER_S * 1e3,
        ops_ms=flops / F32_FLOPS_PER_S * 1e3,
        wall_ms=host_ms(k2))
    log(tag, f"K2 N={n} {h}x{w} timing: kernel_ms={t['ms']:.5f} "
        f"cold_l2_ms={t['cold_ms']:.5f} "
        f"library/kernel={t['library_ms'] / t['ms']:.2f} "
        f"plain_ms={t['plain_ms']:.5f} library_ms={t['library_ms']:.5f} "
        f"(grid_sample backward max|diff| {lib_err}) "
        f"bytes={bytes_} byte_bound_us={t['bytes_ms'] * 1e3:.3f} "
        f"op_bound_us={t['ops_ms'] * 1e3:.3f} "
        f"wrapper_wall_ms={t['wall_ms']:.5f}")
    return t


def phase_core_autograd(gen) -> float:
    """(grad): gradients to x, offset and mask through ``dcnv3_core`` at
    the flagship train shape, through K1 and K2, against autograd of the
    plain sampler on the same card tensors.  This holds the wiring of the
    autograd function: the order of its inputs, dpy against dpx, and the
    sign of the coordinate gradient.  On the 64x128 map, with offsets
    uniform in +-10 px, K2 runs bands with halos and spills."""
    g, cg, p = 32, 8, 9
    worst = 0.0
    for n, h, w, kind in ((6, 32, 32, "random"), (6, 32, 32, "zero"),
                          (1, 64, 128, "far")):
        x = torch.randn((n, h, w, g * cg), generator=gen).cuda()
        shape = (n, h, w, g * p * 2)
        offset = {"random": lambda: 3 * torch.randn(shape, generator=gen),
                  "zero": lambda: torch.zeros(shape),
                  "far": lambda: 20 * torch.rand(shape, generator=gen) - 10,
                  }[kind]().cuda()
        mask = torch.rand((n, h, w, g * p), generator=gen).cuda()
        dout = torch.randn((n, h, w, g * cg), generator=gen).cuda()
        fwd, bwd = (dcnv3.dcnv3_sample.launches,
                    dcnv3.dcnv3_sample_backward.launches)
        grads = []
        kernel = dcnv3.dcnv3_sample
        for sampler in (kernel, dcnv3.dcnv3_sample_reference):
            ins = [t.clone().requires_grad_() for t in (x, offset, mask)]
            dcnv3.dcnv3_sample = sampler
            try:
                out = dcnv3.dcnv3_core(*ins, group=g, group_channels=cg)
            finally:
                dcnv3.dcnv3_sample = kernel
            grads.append(torch.autograd.grad(out, ins, dout))
        check(dcnv3.dcnv3_sample.launches == fwd + 1
              and dcnv3.dcnv3_sample_backward.launches == bwd + 1,
              f"dcnv3_core autograd ({kind}) did not run K1 and K2 once")
        errs = []
        for name, gv, wv in zip(("x", "offset", "mask"), *grads):
            errs.append((gv - wv).abs().max().item())
            check(torch.allclose(gv, wv, atol=BWD_ATOL, rtol=BWD_RTOL),
                  f"dcnv3_core d{name} ({kind}) kernel vs plain beyond atol "
                  f"{BWD_ATOL} rtol {BWD_RTOL}: {errs[-1]:.3g}")
            check(wv.abs().max().item() > 0, f"d{name} ({kind}) is all 0")
        worst = max(worst, *errs)
        log("grad", f"dcnv3_core x {tuple(x.shape)} {kind} offsets: "
            f"max|kernel-plain| dx={errs[0]:.3g} doffset={errs[1]:.3g} "
            f"dmask={errs[2]:.3g}")
    return worst


# the grouped-layout sampler (K3-K7) at the shapes the flagship's DCN
# layers would hand it: a request's and a train step's /16 map
GROUPED_SHAPES = (("serve", 1, 32, 44), ("train", 6, 32, 32))
GROUPED_FORWARD = {  # JAX name -> (K number, output layout)
    "dcnv3_sample_pallas_t": ("K3", "gchw"),
    "dcnv3_sample_pallas": ("K4", "ghwc"),
    "dcnv3_sample_pallas_t4": ("K5", "gchw"),
    "dcnv3_sample_pallas_tg": ("K6", "gchw"),
}
GROUPED_BACKWARD = "dcnv3_sample_pallas_t_bwd"   # K7
# each TPU kernel's wrapper line in spike2former_tpu/ops/pallas/dcnv3_kernel.py
TPU_LINE = {"dcnv3_sample_pallas_t5": 440, "dcnv3_sample_pallas_t5_bwd": 773,
            "dcnv3_sample_pallas_t": 125, "dcnv3_sample_pallas": 197,
            "dcnv3_sample_pallas_t4": 307, "dcnv3_sample_pallas_tg": 566,
            "dcnv3_sample_pallas_t_bwd": 954}


def to_grouped(value, py, px, mask, dout=None):
    """K1's layout -> the grouped one: value [N, H, W, G*Cg] -> feat
    [N, G, H, W*Cg]; [N, HoWo, G, P] -> [N, G, P, HoWo]; dout
    [N, HoWo, G*Cg] -> [N, G, Cg, HoWo]."""
    n, h, w, c = value.shape
    _, howo, g, p = py.shape
    cg = c // g
    feat = value.view(n, h, w, g, cg).permute(0, 3, 1, 2, 4).reshape(
        n, g, h, w * cg)
    out = [feat] + [t.permute(0, 2, 3, 1) for t in (py, px, mask)]
    if dout is not None:
        out.append(dout.view(n, howo, g, cg).permute(0, 2, 3, 1))
    return [t.contiguous() for t in out]


def grouped_yardstick(feat, py, px, mask, *, num_points, h_in, w_in, group,
                      group_channels, out_layout):
    """The grouped forward by ``F.grid_sample`` over [N*G, Cg, H, W] and
    the mask-weighted sum over P, which gives [N, G, Cg, HoWo] directly:
    timed only, never called by the port."""
    n, howo = feat.shape[0], py.shape[-1]
    ng, cg = n * group, group_channels
    x = feat.view(ng, h_in, w_in, cg).permute(0, 3, 1, 2)
    grid = torch.stack(((px + 0.5) / w_in * 2 - 1,
                        (py + 0.5) / h_in * 2 - 1), -1)
    s = F.grid_sample(x, grid.view(ng, num_points, howo, 2),
                      mode="bilinear", padding_mode="zeros",
                      align_corners=False)              # [NG, Cg, P, HoWo]
    out = (s * mask.view(ng, 1, num_points, howo)).sum(2).view(
        n, group, cg, howo)
    return out if out_layout == "gchw" else out.transpose(2, 3).contiguous()


def grouped_launches() -> tuple[int, int]:
    return (dcnv3_grouped.dcnv3_sample_grouped.launches,
            dcnv3_grouped.dcnv3_sample_grouped_backward.launches)


def grouped_bf16_launches() -> tuple[int, int]:
    return (dcnv3_grouped.dcnv3_sample_grouped.bf16_launches,
            dcnv3_grouped.dcnv3_sample_grouped_backward.bf16_launches)


def zero_launches() -> None:
    """Set every kernel's launch count to 0."""
    for k in (dcnv3.dcnv3_sample, dcnv3.dcnv3_sample_backward):
        k.launches = k.bf16_launches = 0
    for k in (dcnv3_grouped.dcnv3_sample_grouped,
              dcnv3_grouped.dcnv3_sample_grouped_backward):
        k.launches = k.bf16_launches = 0
    jr.threefry_kernel.launches = 0


def read_launches() -> dict:
    return dict(k1=dcnv3.dcnv3_sample.launches,
                k2=dcnv3.dcnv3_sample_backward.launches,
                k1_bf16=dcnv3.dcnv3_sample.bf16_launches,
                k2_bf16=dcnv3.dcnv3_sample_backward.bf16_launches,
                grouped=grouped_launches(),
                grouped_bf16=grouped_bf16_launches(),
                threefry=jr.threefry_kernel.launches)


def drawn_entries(model: torch.nn.Module) -> int:
    """The threefry launches of ``init_weights_(model)`` on the card: one
    for each entry of a random law (a uniform, or the uniforms of a
    normal), none for a constant."""
    return sum(law.kind != "constant" for law in init_laws(model).values())


# the grouped kernels' checks: the flagship shapes at Cg=8 for every kind
# of coordinates; G=4 at every Cg on a map staged in bands of rows with
# halos (64x128), one too wide to stage at Cg >= 8 (8x2048) and one that a
# single backward band owns whole (9x13)
GROUPED_KINDS = ("random", "far", "offmap", "zero", "integer", "nan")
GROUPED_MAPS = ((1, 64, 128), (1, 8, 2048), (2, 9, 13))
GROUPED_MAP_KINDS = ("random", "offmap", "zero", "nan")


def grouped_inputs(n, h, w, g, cg, kind, gen, device="cuda", p=9):
    """``sampler_inputs`` of ``p`` points and a dout [N, HoWo, G*Cg] in
    K1's layout, and the points that the kernels drop, for ``KINDS`` and
    'offmap' (coordinates spread over and 4 px off the map) and 'nan'
    ('random' with every 7th py and every 11th px NaN)."""
    base = {"offmap": "far", "nan": "random"}.get(kind, kind)
    value, py, px, mask = sampler_inputs(n, h, w, g, cg, p, base, gen,
                                         device)
    if kind == "offmap":
        py = (torch.rand(py.shape, generator=gen) * (h + 8) - 4).to(device)
        px = (torch.rand(px.shape, generator=gen) * (w + 8) - 4).to(device)
    if kind == "nan":
        py.view(-1)[::7] = float("nan")
        px.view(-1)[::11] = float("nan")
    dout = torch.randn((n, h * w, g * cg), generator=gen).to(device)
    return (value, py, px, mask, dout), py.isnan() | px.isnan()


def plain_dropping(value, py, px, mask, dout, dropped):
    """The plain forward and backward (K1's layout) with the dropped
    points taken out: mask 0 and coordinates 0 there, and zero coordinate
    and mask gradients (the plain versions index with the coordinates, so
    they take no NaN)."""
    keep = ~dropped
    py0, px0 = (torch.where(keep, t, 0.0) for t in (py, px))
    m0 = mask * keep
    out = dcnv3.dcnv3_sample_reference(value, py0, px0, m0)
    dvalue, *dc = dcnv3.dcnv3_sample_backward_reference(value, py0, px0, m0,
                                                        dout)
    return out, (dvalue, *(t * keep for t in dc))


def check_grouped(n, h, w, g, cg, kind, gen) -> dict:
    """The grouped forward in both layouts and the grouped backward on
    one case, each against the plain version and K1/K2 on the same data;
    returns the largest differences by JAX name."""
    flat, dropped = grouped_inputs(n, h, w, g, cg, kind, gen)
    want, want_b = plain_dropping(*flat, dropped)
    k1 = dcnv3.dcnv3_sample(*flat[:4]).view(n, h * w, g, cg)
    k2 = to_grouped(*dcnv3.dcnv3_sample_backward(*flat))
    feat, py, px, mask, dout = to_grouped(*flat)
    static = dict(num_points=9, h_in=h, w_in=w, group=g, group_channels=cg)
    case = f"N={n} {h}x{w} G={g} Cg={cg} {kind}"
    errs = {}
    for name, (k, layout) in GROUPED_FORWARD.items():
        got = dcnv3_grouped.JAX_COUNTERPARTS[name](feat, py, px, mask,
                                                   **static)
        torch.cuda.synchronize()
        order = (0, 2, 3, 1) if layout == "gchw" else (0, 2, 1, 3)
        check(bool(torch.isfinite(got).all()), f"non-finite {k} ({case})")
        e_plain = (got - want.view(n, h * w, g, cg).permute(order)
                   ).abs().max().item()
        e_k1 = (got - k1.permute(order)).abs().max().item()
        check(e_plain <= KERNEL_TOL and e_k1 <= KERNEL_TOL,
              f"{k} ({layout}) vs plain {e_plain:.3g}, vs K1 {e_k1:.3g} > "
              f"{KERNEL_TOL} ({case})")
        errs[name] = max(e_plain, e_k1)
    got = dcnv3_grouped.dcnv3_sample_grouped_backward(feat, py, px, mask,
                                                      dout, **static)
    torch.cuda.synchronize()
    errs[GROUPED_BACKWARD] = 0.0
    for ref, other in ((to_grouped(*want_b), "plain"), (k2, "K2")):
        for gname, gv, wv in zip(("dfeat", "dpy", "dpx", "dmask"), got, ref):
            check(bool(torch.isfinite(gv).all()),
                  f"non-finite K7 {gname} ({case})")
            err = (gv - wv).abs().max().item()
            check(torch.allclose(gv, wv, atol=BWD_ATOL, rtol=BWD_RTOL),
                  f"K7 {gname} vs {other} beyond atol {BWD_ATOL} rtol "
                  f"{BWD_RTOL} ({case}): {err:.3g}")
            errs[GROUPED_BACKWARD] = max(errs[GROUPED_BACKWARD], err)
    return errs


def phase_grouped(gen) -> dict:
    """(grouped): the grouped-layout forward kernel in both layouts (the
    counterparts of K3, K4, K5 and K6) and its backward kernel (K7) under
    their plans, each against its plain version and against K1/K2 on the
    same data; autograd of both layouts at the train shape; the timings
    at both flagship shapes, warm and cold, beside K1's and K2's."""
    g, cg, p = 32, 8, 9
    fwd = dcnv3_grouped.JAX_COUNTERPARTS
    bwd = dcnv3_grouped.dcnv3_sample_grouped_backward
    errs = {name: 0.0 for name in (*GROUPED_FORWARD, GROUPED_BACKWARD)}

    def record(e):
        for name, err in e.items():
            errs[name] = max(errs[name], err)

    for shape, n, h, w in GROUPED_SHAPES:
        for kind in GROUPED_KINDS:
            record(check_grouped(n, h, w, g, cg, kind, gen))
        plans = [dcnv3_grouped.grouped_tile_plan(n, h, w, h * w, g, cg,
                                                 backward=b)
                 for b in (False, True)]
        log("grouped", f"{shape} N={n} {h}x{w} G={g} Cg={cg}, kinds "
            f"{GROUPED_KINDS}: plans forward {plans[0]}, backward "
            f"{plans[1]}; max|kernel-ref| so far {errs}")
    for n, h, w in GROUPED_MAPS:
        for c in CHANNELS:
            for kind in GROUPED_MAP_KINDS:
                record(check_grouped(n, h, w, 4, c, kind, gen))
        log("grouped", f"N={n} {h}x{w} G=4 Cg {CHANNELS}, kinds "
            f"{GROUPED_MAP_KINDS}: max|kernel-ref| so far {errs}")

    times = {}
    for shape, n, h, w in GROUPED_SHAPES:
        howo = h * w
        static = dict(num_points=p, h_in=h, w_in=w, group=g,
                      group_channels=cg)
        flat = sampler_inputs(n, h, w, g, cg, p, "random", gen)
        dout_flat = torch.randn((n, howo, g * cg), generator=gen).cuda()
        ins = to_grouped(*flat)
        feat, py = ins[:2]
        dout = to_grouped(*flat, dout_flat)[4]
        if shape == "train":
            # autograd of both layouts against the plain version's
            for name in ("dcnv3_sample_pallas_t", "dcnv3_sample_pallas"):
                k, layout = GROUPED_FORWARD[name]
                before = grouped_launches()
                cot = torch.randn((n, g, cg, howo), generator=gen).cuda()
                if layout == "ghwc":
                    cot = cot.transpose(2, 3).contiguous()
                grads = []
                for fn in (dcnv3_grouped.dcnv3_sample_grouped,
                           dcnv3_grouped.dcnv3_sample_grouped_reference):
                    leaves = [t.clone().requires_grad_() for t in ins]
                    out = fn(*leaves, **static, out_layout=layout)
                    grads.append(torch.autograd.grad(out, leaves, cot))
                check(grouped_launches() == (before[0] + 1, before[1] + 1),
                      f"{layout} autograd did not run the grouped kernels "
                      "once each")
                line = []
                for gname, gv, wv in zip(("dfeat", "dpy", "dpx", "dmask"),
                                         *grads):
                    err = (gv - wv).abs().max().item()
                    check(torch.allclose(gv, wv, atol=BWD_ATOL,
                                         rtol=BWD_RTOL),
                          f"{layout} autograd {gname} kernel vs plain "
                          f"beyond atol {BWD_ATOL} rtol {BWD_RTOL}: "
                          f"{err:.3g}")
                    check(wv.abs().max().item() > 0, f"{gname} is all 0")
                    errs[name] = max(errs[name], err)
                    line.append(f"{gname} {err:.3g}")
                log("grouped", f"autograd {k} {layout} {shape} N={n}: "
                    "max|kernel-plain| " + ", ".join(line))

        # K1 and K2 on the same data, warm and cold
        def k1():
            return dcnv3.dcnv3_sample(*flat)

        def k2():
            return dcnv3.dcnv3_sample_backward(*flat, dout_flat)

        times["K1", shape] = dict(ms=median_ms(k1),
                                  cold_ms=cuda_ms(k1, cold=True))
        times["K2", shape] = dict(ms=median_ms(k2),
                                  cold_ms=cuda_ms(k2, cold=True))
        out_elems = n * g * cg * howo
        for name, (k, layout) in GROUPED_FORWARD.items():
            def kernel():
                return fwd[name](*ins, **static)

            t = dict(
                ms=median_ms(kernel),
                cold_ms=cuda_ms(kernel, cold=True),
                plain_ms=cuda_ms(lambda: dcnv3_grouped
                                 .dcnv3_sample_grouped_reference(
                                     *ins, **static, out_layout=layout),
                                 iters=20),
                library_ms=cuda_ms(lambda: grouped_yardstick(
                    *ins, **static, out_layout=layout), iters=20),
                bytes_ms=sampler_bytes(feat, py, out_elems)
                / HBM_BYTES_PER_S * 1e3,
                ops_ms=n * howo * g * p * (4 * cg * 2 + 16)
                / F32_FLOPS_PER_S * 1e3)
            times[name, shape] = t
            lib_err = (grouped_yardstick(*ins, **static, out_layout=layout)
                       - dcnv3_grouped.dcnv3_sample_grouped_reference(
                           *ins, **static, out_layout=layout)
                       ).abs().max().item()
            k1t = times["K1", shape]
            log("grouped", f"{k} {name} {layout} {shape} N={n} timing: "
                f"kernel_ms={t['ms']:.5f} cold_l2_ms={t['cold_ms']:.5f} "
                f"K1_ms={k1t['ms']:.5f} (cold {k1t['cold_ms']:.5f}) "
                f"kernel/K1 {t['ms'] / k1t['ms']:.3f} (cold "
                f"{t['cold_ms'] / k1t['cold_ms']:.3f}) "
                f"plain_ms={t['plain_ms']:.5f} "
                f"library_ms={t['library_ms']:.5f} "
                f"(grid_sample max|diff|={lib_err:.3g}) "
                f"byte_bound_us={t['bytes_ms'] * 1e3:.3f} "
                f"op_bound_us={t['ops_ms'] * 1e3:.3f} share of bound "
                f"{t['bytes_ms'] / t['ms']:.3f}")
        lib_ins = [t.clone().requires_grad_() for t in ins]
        lib_out = grouped_yardstick(*lib_ins, **static, out_layout="gchw")

        def kernel():
            return bwd(*ins, dout, **static)

        t = dict(
            ms=median_ms(kernel),
            cold_ms=cuda_ms(kernel, cold=True),
            plain_ms=cuda_ms(lambda: dcnv3_grouped
                             .dcnv3_sample_grouped_backward_reference(
                                 *ins, dout, **static), iters=10),
            library_ms=cuda_ms(lambda: torch.autograd.grad(
                lib_out, lib_ins, dout, retain_graph=True), iters=20),
            bytes_ms=4 * (2 * feat.numel() + 6 * py.numel() + dout.numel())
            / HBM_BYTES_PER_S * 1e3,
            ops_ms=py.numel() * (4 * 4 * cg + 40) / F32_FLOPS_PER_S * 1e3)
        times[GROUPED_BACKWARD, shape] = t
        k2t = times["K2", shape]
        log("grouped", f"K7 {GROUPED_BACKWARD} {shape} N={n} timing: "
            f"kernel_ms={t['ms']:.5f} cold_l2_ms={t['cold_ms']:.5f} "
            f"K2_ms={k2t['ms']:.5f} (cold {k2t['cold_ms']:.5f}) "
            f"kernel/K2 {t['ms'] / k2t['ms']:.3f} (cold "
            f"{t['cold_ms'] / k2t['cold_ms']:.3f}) "
            f"plain_ms={t['plain_ms']:.5f} "
            f"library_ms={t['library_ms']:.5f} "
            f"byte_bound_us={t['bytes_ms'] * 1e3:.3f} "
            f"op_bound_us={t['ops_ms'] * 1e3:.3f} share of bound "
            f"{t['bytes_ms'] / t['ms']:.3f}")
    return dict(errs=errs, times=times)


# the bf16 forms' checks: the flagship shapes for every kind of
# coordinates, and every Cg on the maps of GROUPED_MAPS; 2x2 and 5x5
# points (the forward sorts up to 9 points' taps, more take its any-P
# walk) at the serve shape and at every Cg on the last map, every kind
GROUPED_BF16_MAP_KINDS = ("random", "nan")
GROUPED_BF16_POINTS = (4, 25)
# the bf16 forward's instantiations at Cg = 8 in its build log (the
# backward's carry the feature type in their name)
GROUPED_BF16_FWD_MARKER = "grouped_bf16_kernelILi8E"


def round_columns(name: str) -> bool:
    """Whether the JAX kernel ``name``'s bf16 form rounds its column
    weights (K3, K6) or keeps them f32 (K4, K5)."""
    return dcnv3_grouped.JAX_COUNTERPARTS[name].keywords.get(
        "round_columns", False)


def check_grouped_bf16(n, h, w, g, cg, kind, gen, p: int = 9) -> dict:
    """The bf16 grouped forward in both layouts (each JAX name with its
    column rounding) and the bf16 grouped backward on one case of ``p``
    points against their plain versions (the dropped points taken out of
    the plain inputs): out and dfeat within one bf16 ulp, dpy/dpx/dmask
    within ``BF16_GRAD_RTOL`` of their largest magnitude; returns the
    largest differences by JAX name."""
    flat, dropped = grouped_inputs(n, h, w, g, cg, kind, gen, p=p)
    value, py, px, mask, dout = flat
    keep = ~dropped
    feat, gy, gx, gm, gd = to_grouped(value.bfloat16(), py, px, mask,
                                      dout.bfloat16())
    _, py0, px0, m0 = to_grouped(value, *(torch.where(keep, t, 0.0)
                                          for t in (py, px)), mask * keep)
    keep_g = to_grouped(value, keep.float(), keep.float(), keep.float())[1]
    static = dict(num_points=p, h_in=h, w_in=w, group=g, group_channels=cg)
    case = f"N={n} {h}x{w} G={g} Cg={cg} P={p} {kind}"
    errs = {}
    for name, (k, layout) in GROUPED_FORWARD.items():
        got = dcnv3_grouped.JAX_COUNTERPARTS[name](feat, gy, gx, gm,
                                                   **static)
        torch.cuda.synchronize()
        want = dcnv3_grouped.dcnv3_sample_grouped_reference(
            feat, py0, px0, m0, **static, out_layout=layout,
            round_columns=round_columns(name))
        check(got.dtype == torch.bfloat16
              and bool(torch.isfinite(got).all()),
              f"bf16 {k} out ({case})")
        check(within_one_bf16_ulp(got, want),
              f"bf16 {k} ({layout}) beyond one ulp of plain ({case})")
        errs[name] = (got.float() - want.float()).abs().max().item()
    got = dcnv3_grouped.dcnv3_sample_grouped_backward(feat, gy, gx, gm, gd,
                                                      **static)
    torch.cuda.synchronize()
    want = dcnv3_grouped.dcnv3_sample_grouped_backward_reference(
        feat, py0, px0, m0, gd, **static)
    check(got[0].dtype == torch.bfloat16
          and within_one_bf16_ulp(got[0], want[0]),
          f"bf16 K7 dfeat beyond one ulp of plain ({case})")
    errs[GROUPED_BACKWARD] = (got[0].float() - want[0].float()).abs().max(
    ).item()
    for gname, gv, wv in zip(("dpy", "dpx", "dmask"), got[1:], want[1:]):
        wv = wv * keep_g
        err = (gv - wv).abs().max().item()
        check(bool(torch.isfinite(gv).all())
              and err <= BF16_GRAD_RTOL * wv.abs().max().item(),
              f"bf16 K7 {gname} off by {err:.3g} ({case})")
        errs[GROUPED_BACKWARD] = max(errs[GROUPED_BACKWARD], err)
    return errs


def phase_grouped_bf16(gen) -> dict:
    """(grouped bf16): the bf16 forms of K3-K6 (the grouped forward in
    both layouts, with and without the column rounding) and of K7 under
    their plans against their plain versions, at the flagship's /16 maps
    for every kind of coordinates and at every Cg of ``CHANNELS`` on
    ``GROUPED_MAPS``, and at ``GROUPED_BF16_POINTS`` points; autograd of
    the gchw form at the train shape; the times at both flagship shapes,
    warm and cold, the plain times, the ``F.grid_sample`` yardsticks on
    bf16, the byte bounds, the forward on 'far' coordinates too and the
    f32 forward on the same data beside it; the registers and spills of
    the bf16 Cg=8 instantiations (the forward's must not spill)."""
    g, cg, p = 32, 8, 9
    fwd = dcnv3_grouped.JAX_COUNTERPARTS
    bwd = dcnv3_grouped.dcnv3_sample_grouped_backward
    errs = {name: 0.0 for name in (*GROUPED_FORWARD, GROUPED_BACKWARD)}
    launched = (fwd["dcnv3_sample_pallas_t"].func.bf16_launches,
                bwd.bf16_launches)

    def record(e):
        for name, err in e.items():
            errs[name] = max(errs[name], err)

    for shape, n, h, w in GROUPED_SHAPES:
        for kind in GROUPED_KINDS:
            record(check_grouped_bf16(n, h, w, g, cg, kind, gen))
        log("grouped bf16", f"{shape} N={n} {h}x{w} G={g} Cg={cg}, kinds "
            f"{GROUPED_KINDS}: max|kernel-plain| so far {errs}")
    for n, h, w in GROUPED_MAPS:
        for c in CHANNELS:
            for kind in GROUPED_BF16_MAP_KINDS:
                record(check_grouped_bf16(n, h, w, 4, c, kind, gen))
        log("grouped bf16", f"N={n} {h}x{w} G=4 Cg {CHANNELS}, kinds "
            f"{GROUPED_BF16_MAP_KINDS}: max|kernel-plain| so far {errs}")
    _, n, h, w = GROUPED_SHAPES[0]
    for pts in GROUPED_BF16_POINTS:
        for kind in GROUPED_KINDS:
            record(check_grouped_bf16(n, h, w, g, cg, kind, gen, pts))
            for c in CHANNELS:
                record(check_grouped_bf16(*GROUPED_MAPS[-1], 4, c, kind, gen,
                                          pts))
        log("grouped bf16", f"P={pts}: serve N={n} {h}x{w} G={g} Cg={cg} "
            f"and N={GROUPED_MAPS[-1][0]} {GROUPED_MAPS[-1][1]}x"
            f"{GROUPED_MAPS[-1][2]} G=4 Cg {CHANNELS}, kinds "
            f"{GROUPED_KINDS}: max|kernel-plain| so far {errs}")

    times = {}
    for shape, n, h, w in GROUPED_SHAPES:
        howo = h * w
        static = dict(num_points=p, h_in=h, w_in=w, group=g,
                      group_channels=cg)
        flat = sampler_inputs(n, h, w, g, cg, p, "random", gen)
        dout_flat = torch.randn((n, howo, g * cg), generator=gen).cuda()
        feat, py, px, mask, dout = to_grouped(
            flat[0].bfloat16(), *flat[1:], dout_flat.bfloat16())
        ins = [feat, py, px, mask]
        lib = [feat, py.bfloat16(), px.bfloat16(), mask.bfloat16()]
        if shape == "train":
            before = (fwd["dcnv3_sample_pallas_t"].func.bf16_launches,
                      bwd.bf16_launches)
            cot = torch.randn((n, g, cg, howo), generator=gen).cuda()
            cot = cot.bfloat16()
            leaves = [t.clone().requires_grad_() for t in ins]
            out = fwd["dcnv3_sample_pallas_t"](*leaves, **static)
            got = torch.autograd.grad(out, leaves, cot)
            check((fwd["dcnv3_sample_pallas_t"].func.bf16_launches,
                   bwd.bf16_launches) == (before[0] + 1, before[1] + 1),
                  "bf16 gchw autograd did not run the bf16 kernels once "
                  "each")
            want = dcnv3_grouped.dcnv3_sample_grouped_backward_reference(
                *ins, cot, **static)
            check(within_one_bf16_ulp(got[0], want[0]),
                  "bf16 autograd dfeat beyond one ulp of plain")
            line = []
            for gname, gv, wv in zip(("dpy", "dpx", "dmask"), got[1:],
                                     want[1:]):
                err = (gv - wv).abs().max().item()
                check(err <= BF16_GRAD_RTOL * wv.abs().max().item(),
                      f"bf16 autograd {gname} off by {err:.3g}")
                line.append(f"{gname} {err:.3g}")
            log("grouped bf16", f"autograd K3 gchw {shape} N={n}: "
                "max|kernel-plain| " + ", ".join(line))
        out_elems = n * g * cg * howo
        for name, (k, layout) in GROUPED_FORWARD.items():
            rc = round_columns(name)

            def kernel():
                return fwd[name](*ins, **static)

            t = dict(
                ms=median_ms(kernel),
                cold_ms=cuda_ms(kernel, cold=True),
                plain_ms=cuda_ms(lambda: dcnv3_grouped
                                 .dcnv3_sample_grouped_reference(
                                     *ins, **static, out_layout=layout,
                                     round_columns=rc), iters=10),
                library_ms=cuda_ms(lambda: grouped_yardstick(
                    *lib, **static, out_layout=layout), iters=20),
                bytes_ms=(2 * feat.numel() + 12 * py.numel()
                          + 2 * out_elems) / HBM_BYTES_PER_S * 1e3,
                ops_ms=n * howo * g * p * (4 * cg * 2 + 16)
                / F32_FLOPS_PER_S * 1e3)
            times[name, shape] = t
            log("grouped bf16", f"{k} {name} {layout} round_columns={rc} "
                f"{shape} N={n} timing: kernel_ms={t['ms']:.5f} "
                f"cold_l2_ms={t['cold_ms']:.5f} plain_ms="
                f"{t['plain_ms']:.5f} library_ms={t['library_ms']:.5f} "
                f"byte_bound_us={t['bytes_ms'] * 1e3:.3f} "
                f"op_bound_us={t['ops_ms'] * 1e3:.3f} share of bound "
                f"{t['bytes_ms'] / t['ms']:.3f} library/kernel "
                f"{t['library_ms'] / t['ms']:.2f}")
        # K3's bf16 form on 'random' and 'far' coordinates beside the f32
        # form on the same data (the features in f32), in turns
        for kind in ("random", "far"):
            data = flat if kind == "random" else sampler_inputs(
                n, h, w, g, cg, p, kind, gen)
            f32_ins = to_grouped(*data)
            half = [f32_ins[0].bfloat16(), *f32_ins[1:]]
            k3 = fwd["dcnv3_sample_pallas_t"]
            pair = [median_ms(lambda: k3(*f32_ins, **static)),
                    median_ms(lambda: k3(*half, **static)),
                    median_ms(lambda: k3(*half, **static)),
                    median_ms(lambda: k3(*f32_ins, **static))]
            f32_ms = (pair[0] + pair[3]) / 2
            bf16_ms = (pair[1] + pair[2]) / 2
            times["K3 bf16/f32", shape, kind] = dict(
                bf16_ms=bf16_ms, f32_ms=f32_ms)
            log("grouped bf16", f"K3 {shape} N={n} {kind}: bf16 form "
                f"{pair[1]:.5f}, {pair[2]:.5f} ms; f32 form {pair[0]:.5f}, "
                f"{pair[3]:.5f} ms (f32, bf16, bf16, f32); bf16/f32 "
                f"{bf16_ms / f32_ms:.3f}")
        lib_ins = [t.clone().requires_grad_() for t in lib]
        lib_out = grouped_yardstick(*lib_ins, **static, out_layout="gchw")

        def kernel():
            return bwd(*ins, dout, **static)

        t = dict(
            ms=median_ms(kernel),
            cold_ms=cuda_ms(kernel, cold=True),
            plain_ms=cuda_ms(lambda: dcnv3_grouped
                             .dcnv3_sample_grouped_backward_reference(
                                 *ins, dout, **static), iters=10),
            library_ms=cuda_ms(lambda: torch.autograd.grad(
                lib_out, lib_ins, dout, retain_graph=True), iters=20),
            bytes_ms=(2 * (2 * feat.numel() + dout.numel())
                      + 24 * py.numel()) / HBM_BYTES_PER_S * 1e3,
            ops_ms=py.numel() * (4 * 4 * cg + 40) / F32_FLOPS_PER_S * 1e3)
        times[GROUPED_BACKWARD, shape] = t
        log("grouped bf16", f"K7 {GROUPED_BACKWARD} {shape} N={n} timing: "
            f"kernel_ms={t['ms']:.5f} cold_l2_ms={t['cold_ms']:.5f} "
            f"plain_ms={t['plain_ms']:.5f} "
            f"library_ms={t['library_ms']:.5f} "
            f"byte_bound_us={t['bytes_ms'] * 1e3:.3f} "
            f"op_bound_us={t['ops_ms'] * 1e3:.3f} share of bound "
            f"{t['bytes_ms'] / t['ms']:.3f}")
    regs = registers(dcnv3.GROUPED_SOURCE, GROUPED_BF16_FWD_MARKER)
    check(len(regs) == 4 and all(spill == 0 for _, spill in regs),
          f"bf16 Cg=8 grouped forward: {registers_text(regs)}")
    log("grouped bf16", f"{dcnv3.GROUPED_SOURCE} bf16 Cg=8: "
        f"{registers_text(regs)}")
    bwd_regs = registers(dcnv3.GROUPED_BWD_SOURCE, "13__nv_bfloat16Li8E")
    log("grouped bf16", f"{dcnv3.GROUPED_BWD_SOURCE} bf16 Cg=8: "
        f"{registers_text(bwd_regs)}")
    launched = (fwd["dcnv3_sample_pallas_t"].func.bf16_launches
                - launched[0], bwd.bf16_launches - launched[1])
    log("grouped bf16", f"bf16 launches in this phase (checks and timing, "
        f"not a main path): forward {launched[0]}, backward {launched[1]}")
    return dict(errs=errs, times=times)


@contextlib.contextmanager
def tf32(matmul: bool, cudnn: bool):
    """Set the TF32 flags of matmuls and cuDNN for a block, then restore
    them."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = matmul
    torch.backends.cudnn.allow_tf32 = cudnn
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def phase_tf32(im) -> dict:
    """(tf32): what TF32 does to the flagship's logits and class maps.
    ``whole_logits``, which sets no precision itself, runs on the three
    serve images in full f32, with torch's default flags (TF32 on for
    cuDNN only) and with TF32 on for both; each is held to f32 by the
    share of pixels whose class agrees and the largest logit difference.
    The tiny model's card logits in each mode are held to the CPU's."""
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
            for hw in REQUEST_SHAPES]
    modes = {"f32": (False, False), "default": (False, True),
             "tf32": (True, True)}
    res = {}
    for img in imgs:
        padded, hw = api.resize_and_pad(im.cfg, img)
        x = torch.from_numpy(padded[None]).cuda()
        out = {}
        for mode, flags in modes.items():
            with tf32(*flags):
                logits = whole_logits(im.model, x)
            out[mode] = logits, postprocess_pred(logits, hw, img.shape[:2])
        for mode in ("default", "tf32"):
            agree = (out[mode][1] == out["f32"][1]).float().mean().item()
            diff = (out[mode][0] - out["f32"][0]).abs().max().item()
            res.setdefault(mode, []).append((agree, diff))
            log("tf32", f"image {img.shape[:2]} {mode} vs f32: class "
                f"agreement {agree:.6f}, max|logit diff|={diff:.6g} "
                f"(max|logit| {out['f32'][0].abs().max().item():.6g}, "
                f"classes in use {len(out['f32'][1].unique())})")
    cpu = randomize_(Spike2Former(T=1, **TINY), seed=1)
    gpu = copy.deepcopy(cpu).cuda()
    x = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (1, 64, 64, 3)).astype(np.float32))
    with torch.inference_mode():
        want = cpu.predict_logits(x)
        for mode, flags in modes.items():
            with tf32(*flags):
                got = gpu.predict_logits(x.cuda()).cpu()
            diff = (got - want).abs().max().item()
            res["tiny_" + mode] = diff
            log("tf32", f"tiny model 64x64 card ({mode}) vs CPU: "
                f"max|logit diff|={diff:.6g} (tol {MODEL_TOL})")
    return res


# the eval modes of ``cfg.test``: whole bucketed with ``valid_hw`` (the
# preset's default), whole exact (pad to 32), slide
EVAL_MODES = {"whole_bucketed": TestConfig(mode="whole", bucket=128),
              "whole_exact": TestConfig(mode="whole", bucket=0),
              "slide": TestConfig(mode="slide", crop_size=(512, 512),
                                  stride=(341, 341))}


def phase_eval(im) -> dict:
    """(eval): the eval CLI's ``evaluate`` at full width on a seeded
    ADE20K-layout tree of the three request shapes, in each mode of
    ``EVAL_MODES``: a warm-up pass, then ``EVAL_PASSES`` timed passes with
    the launch counts set to 0 just before them."""
    out = {}
    with tempfile.TemporaryDirectory() as root:
        write_ade_tree(root, REQUEST_SHAPES, seed=0)
        ds = make_dataset("ade20k", root, "val")
        for mode, test_cfg in EVAL_MODES.items():
            cfg = copy.deepcopy(im.cfg)
            cfg.test = test_cfg
            m = api.InferenceModel(cfg, im.model, im.device)
            eval_cli.evaluate(m, ds)
            torch.cuda.synchronize()
            zero_launches()
            passes = []
            for _ in range(EVAL_PASSES):
                t = time.perf_counter()
                res = eval_cli.evaluate(m, ds)
                torch.cuda.synchronize()
                passes.append((time.perf_counter() - t) * 1e3
                              / res["images"])
            launches = read_launches()
            ms = statistics.median(passes)
            # one forward an image in whole mode; in slide mode one a
            # chunk of windows (all of an image's fit one chunk here)
            windows = [len(slide_origins(-(-h // 32) * 32, -(-w // 32) * 32,
                                         (512, 512), (341, 341)))
                       for h, w in REQUEST_SHAPES]
            forwards = res["images"] * EVAL_PASSES
            check(res["images"] == len(REQUEST_SHAPES), f"{mode}: images")
            check(launches["k1"] == 6 * forwards,
                  f"{mode}: expected {6 * forwards} K1 launches, got "
                  f"{launches['k1']}")
            for pred, hw in zip(res["preds"], REQUEST_SHAPES):
                check(pred.shape == hw and pred.min() >= 0
                      and pred.max() < im.num_classes,
                      f"{mode}: pred {pred.shape} for {hw}")
            check(np.isfinite(res["mIoU"]), f"{mode}: mIoU {res['mIoU']}")
            per_window = (f", {launches['k1'] / EVAL_PASSES / sum(windows):g}"
                          f" per window "
                          f"({sum(windows)} windows)" if mode == "slide"
                          else "")
            log("eval", f"{mode}: images {res['images']} mIoU "
                f"{res['mIoU']:.4f} mAcc {res['mAcc']:.4f} aAcc "
                f"{res['aAcc']:.4f}; {ms:.3f} ms per image (median of "
                f"{EVAL_PASSES} passes: {[round(x, 3) for x in passes]}); "
                f"K1 launches {launches['k1']} over {EVAL_PASSES} passes "
                f"({launches['k1'] / forwards:g} per image{per_window}), "
                f"grouped {launches['grouped']}")
            out[mode] = dict(res, ms=ms, launches=launches)
    agree = (sum(int((a == b).sum()) for a, b in zip(
        out["whole_bucketed"]["preds"], out["whole_exact"]["preds"]))
        / sum(h * w for h, w in REQUEST_SHAPES))
    log("eval", f"share of pixels on which bucketed and exact agree: "
        f"{agree:.6f}")
    out["agree"] = agree
    return out


@contextlib.contextmanager
def capture_auction(store: list):
    """Record the cost batch of each ``auction_match`` call the criterion
    makes."""
    real = criterion.auction_match

    def spy(costs, **kw):
        store.append(costs.detach().clone())
        return real(costs, **kw)

    criterion.auction_match = spy
    try:
        yield store
    finally:
        criterion.auction_match = real


def timed_steps(tr, batches, warmup: int, tag: str,
                k1_per_step: int = 6) -> dict:
    """Take one step per batch through ``api.train_steps``; the launch
    counts are set to 0 just before and read just after (K1
    ``k1_per_step`` a step, K2 6)."""
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    times, metrics = [], []
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = api.train_steps(tr, [batch])[0]
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        metrics.append(m)
        log("train", f"{tag} step {i}{' (warm-up)' if i < warmup else ''}: "
            f"{times[-1]:.1f} ms total={m['total']:.6g} "
            f"grad_norm={m['grad_norm']:.6g} "
            f"dropped_gt={m.get('dropped_gt', 0):g} "
            f"repaired_gt={m['repaired_gt']:g}")
    launches = read_launches()
    steps = len(batches)
    log("train", f"{tag}: {steps} steps, dcnv3_sample launches="
        f"{launches['k1']} ({launches['k1'] / steps:g} per step), "
        f"dcnv3_sample_bwd launches={launches['k2']} "
        f"({launches['k2'] / steps:g} per step), grouped forward/backward "
        f"launches={launches['grouped']}")
    check(launches["k1"] == k1_per_step * steps
          and launches["k2"] == 6 * steps,
          f"{tag}: expected {k1_per_step} K1 and 6 K2 launches per step, "
          f"got {launches['k1']}, {launches['k2']} over {steps} steps")
    for m in metrics:
        bad = [k for k, v in m.items() if not np.isfinite(v)]
        check(not bad, f"{tag}: non-finite train metrics {bad}")
    for name, p in tr.state.model.named_parameters():
        if ".dcn.offset_conv." in name or ".dcn.mask_conv." in name:
            check(p.grad is not None and p.grad.abs().max().item() > 0,
                  f"{tag}: no gradient reaches {name}")
    timed = times[warmup:]
    return dict(launches=launches, step_ms=statistics.median(timed),
                max_ms=max(timed), n=len(timed), first=metrics[0],
                repaired=[m["repaired_gt"] for m in metrics],
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)


def phase_train() -> dict:
    """(train): full-width flagship train steps through the entry points
    at the preset's defaults (auction, ``compact_gt=32``).  Returns the
    trainer too, and the cost batch of its first step."""
    t = time.perf_counter()
    tr = drawn_trainer(PRESET, seed=0)
    check((tr.cfg.train.matcher, tr.cfg.train.compact_gt) == ("auction", 32),
          f"preset trains with {tr.cfg.train.matcher}, "
          f"compact_gt={tr.cfg.train.compact_gt}")
    log("train", f"flagship trainer built at full width in "
        f"{time.perf_counter() - t:.1f}s (matcher "
        f"{tr.cfg.train.matcher}, compact_gt {tr.cfg.train.compact_gt})")
    b, hw = tr.cfg.data.batch_size, tuple(tr.cfg.data.crop_size)
    rng = np.random.default_rng(0)
    batches = [synthetic_batch(rng, b, hw)
               for _ in range(WARMUP_STEPS + TIMED_STEPS)]
    n_cls = [len(np.unique(s[s != 255])) for s in batches[0][1]]
    log("train", f"batch {b} at {hw}: classes per crop {n_cls}")
    costs = []
    with capture_auction(costs):
        api.train_steps(tr, batches[:1])
    check(len(costs) == 1 and tuple(costs[0].shape) == (42, 100, 32),
          f"auction cost batches {[tuple(c.shape) for c in costs]}")
    res = timed_steps(tr, batches, WARMUP_STEPS, "auction")
    batch = [torch.as_tensor(a, device="cuda") for a in batches[-1]]
    with f32_precision():
        busy = device_busy_ms(lambda: tr.step_fn(tr.state, *batch))
    log("train", f"auction: device_busy_ms={busy:.3f} in one step")
    return dict(res, trainer=tr, costs=costs[0], batches=batches,
                busy_ms=busy)


def phase_host_train() -> dict:
    """(train): the same step with ``matcher='host'``, fewer steps."""
    tr = drawn_trainer(PRESET, ["train.matcher='host'"], seed=0)
    rng = np.random.default_rng(0)
    b, hw = tr.cfg.data.batch_size, tuple(tr.cfg.data.crop_size)
    batches = [synthetic_batch(rng, b, hw)
               for _ in range(HOST_WARMUP_STEPS + HOST_TIMED_STEPS)]
    return timed_steps(tr, batches, HOST_WARMUP_STEPS, "host")


def phase_auction(costs: torch.Tensor) -> dict:
    """(auction): the cost batch of one flagship train step on the card
    against the CPU, against scipy's optimum, and capped."""
    from scipy.optimize import linear_sum_assignment

    got, stats = auction_match(costs, with_stats=True)
    want, want_stats = auction_match(costs.cpu(), with_stats=True)
    check(torch.equal(got.cpu(), want), "auction card vs CPU assignment")
    check(int(stats.repaired) == int(want_stats.repaired) == 0,
          f"repaired_gt card {int(stats.repaired)} CPU "
          f"{int(want_stats.repaired)}")
    c = costs.double().cpu().numpy()
    m = got.cpu().numpy()
    worst = 0.0
    for i in range(len(c)):
        valid = ~(c[i] >= BIG_COST * 0.5).all(0)
        cols = np.flatnonzero(valid)
        r, k = linear_sum_assignment(c[i][:, cols].T)
        opt = c[i][:, cols].T[r, k].sum()
        total = c[i][m[i, cols], cols].sum()
        check(len(set(m[i, cols])) == len(cols) and (m[i, cols] >= 0).all(),
              f"problem {i}: incomplete assignment")
        excess = total - opt
        check(excess <= len(cols) * AUCTION_EPS + 1e-4,
              f"problem {i}: {excess:.4g} over the optimum")
        worst = max(worst, excess / (len(cols) * AUCTION_EPS))
    capped, capped_stats = auction_match(costs, num_iters=1,
                                         with_stats=True)
    check(int(capped_stats.repaired) > 0, "a run capped at 1 iteration "
          "needed no repair")
    cm = capped.cpu().numpy()
    for i in range(len(c)):
        cols = np.flatnonzero(~(c[i] >= BIG_COST * 0.5).all(0))
        check((cm[i, cols] >= 0).all() and len(set(cm[i, cols])) == len(cols),
              f"capped problem {i}: the repair left it incomplete")
    check(torch.equal(capped.cpu(), auction_match(costs.cpu(), num_iters=1)),
          "capped auction card vs CPU")
    sites = sync_sites(lambda: auction_match(costs))
    ms = host_ms(lambda: auction_match(costs), iters=20)
    schedules = {}
    saved = matcher.CHUNKS
    try:
        # four rounds, every other one in reverse order, so drift shows
        for chunks in 2 * (AUCTION_CHUNKS + AUCTION_CHUNKS[::-1]):
            matcher.CHUNKS = chunks
            m_s, st = auction_match(costs, with_stats=True)
            check(torch.equal(m_s, got), f"chunks {chunks}: assignment")
            row = schedules.setdefault(f"{chunks[0]}-{chunks[1]}",
                                       dict(syncs=st.syncs, ms=[]))
            row["ms"].append(host_ms(lambda: auction_match(costs), iters=20))
    finally:
        matcher.CHUNKS = saved
    res = dict(iterations=int(stats.iterations), syncs=stats.syncs,
               sites=dict(sites), ms=ms, worst=worst,
               capped_repaired=int(capped_stats.repaired),
               chunks=matcher.CHUNKS, schedules=schedules)
    log("auction", f"[{', '.join(map(str, costs.shape))}] card == CPU; "
        f"{res['iterations']} iterations, {res['syncs']} host reads of the "
        f"loop condition (synchronizations seen by "
        f"torch.cuda.set_sync_debug_mode: {dict(sites)}); {ms:.3f} ms per "
        f"call; worst "
        f"excess over scipy {worst:.4f} of G_valid*eps; capped at 1 "
        f"iteration: repaired_gt={res['capped_repaired']}, complete")
    log("auction", "chunk schedules (first-most: host reads, median ms "
        "per call of four rounds [each round]; the default is "
        f"{matcher.CHUNKS}): " + "; ".join(
            f"{k}: {v['syncs']} reads, {statistics.median(v['ms']):.3f} ms ["
            + ", ".join(f"{t:.3f}" for t in v["ms"]) + "]"
            for k, v in schedules.items()))
    return res


def phase_overflow(tr, batch) -> dict:
    """(overflow): one step on a batch with a crop of 33-36 classes, which
    takes ``compact_gt``'s full-width branch, and the losses at
    ``compact_gt=32`` against full width on a normal batch and on it."""
    rng = np.random.default_rng(7)
    images, sem = batch
    images, sem = images.copy(), sem.copy()
    im1, sem1 = synthetic_batch(rng, 1, sem.shape[1:], classes=(36, 36))
    images[0], sem[0] = im1[0], sem1[0]
    n_cls = len(np.unique(sem[0][sem[0] != 255]))
    check(n_cls > 32, f"the overflow crop holds {n_cls} classes")
    widths = []
    with capture_auction(widths):
        zero_launches()
        m = api.train_steps(tr, [(images, sem)])[0]
        torch.cuda.synchronize()
        launches = read_launches()
    check([tuple(c.shape) for c in widths] == [(42, 100, 64)],
          f"overflow step matched {[tuple(c.shape) for c in widths]}")
    check(launches["k1"] == 6 and launches["k2"] == 6,
          f"overflow step launches {launches}")
    check(np.isfinite(m["total"]), "overflow step loss")
    log("overflow", f"step on a batch with a {n_cls}-class crop: cost batch "
        f"[42, 100, 64] (full width), total={m['total']:.6g} repaired_gt="
        f"{m['repaired_gt']:g}, K1 {launches['k1']} K2 {launches['k2']}")
    model = tr.state.model.train()
    ncls, max_gt = tr.cfg.model.num_classes, tr.cfg.train.max_gt
    worst = 0.0
    for name, (ims, sems) in (("normal", batch), ("overflow", (images, sem))):
        with torch.no_grad(), f32_precision():
            cls, masks = model(preprocess(torch.as_tensor(ims,
                                                          device=tr.device)))
            gt = criterion.semantic_to_instances(
                torch.as_tensor(sems, device=tr.device), ncls, max_gt)
            kw = dict(num_classes=ncls, matcher="auction", loss_at="gt")
            small = criterion.maskformer_loss(cls, masks, gt, compact_gt=32,
                                              **kw)
            full = criterion.maskformer_loss(cls, masks, gt, **kw)
        rel = max(abs(float(small[k]) - float(full[k]))
                  / max(abs(float(full[k])), 1e-30) for k in full
                  if k != "repaired_gt")
        check(rel <= COMPACT_RTOL, f"{name} batch: compact_gt=32 vs full "
              f"width rel {rel:.3g} > {COMPACT_RTOL}")
        worst = max(worst, rel)
        log("overflow", f"{name} batch: losses at compact_gt=32 vs full "
            f"width max rel diff {rel:.3g} (total {float(full['total']):.6g}"
            f", valid slots past 32: {bool(gt.valid[:, 32:].any())})")
    return dict(launches=launches, rel=worst)


def phase_small_train() -> dict:
    """A tiny model's 3 train steps on the card against the CPU, with the
    preset's auction matcher and with the host matcher: the relative
    difference of each step's ``total`` loss.  The maps hold 4 classes
    for the 4 queries: the auction assumes no more valid slots than
    queries."""
    out = {}
    for matcher in ("auction", "host"):
        opts = [f"model.{k}={v!r}".replace(" ", "") for k, v in TINY.items()]
        opts += ["train.warmup_iters=1", f"train.matcher='{matcher}'"]
        rng = np.random.default_rng(1)
        batches = [synthetic_batch(rng, 2, (64, 64), num_classes=4)
                   for _ in range(3)]
        totals = []
        for dev in ("cpu", "cuda"):
            tr = drawn_trainer(PRESET, opts, device=dev, seed=1)
            totals.append([m["total"] for m in api.train_steps(tr, batches)])
        rel = max(abs(a - b) / abs(b) for a, b in zip(totals[1], totals[0]))
        log("train", f"tiny {matcher} totals CPU {totals[0]} card "
            f"{totals[1]}")
        check(rel <= TRAIN_RTOL, f"tiny {matcher} train card vs CPU rel diff "
              f"{rel:.3g}")
        out[matcher] = rel
    return out


# --- the bf16 model (model.dtype='bfloat16') and the bf16 forms of K1, K2 ---

BF16_OPTS = ["model.dtype='bfloat16'"]
BF16_GRAD_RTOL = 1e-3   # dpy/dpx/dmask of bf16 K2: of the largest magnitude
# bf16 model against f32 (tiny, 64x64, card against CPU): the JAX
# package's own bf16-against-f32 logit gap on the tiny model, and the
# train tolerance of tests/test_torch_bf16_model.py
BF16_LOGIT_GAP, BF16_AGREEMENT, BF16_TRAIN_RTOL = 0.064, 0.99, 2e-2
KNOB_RTOL = 1e-5        # remat + packed residuals against neither
BF16_WARMUP, BF16_TIMED = 1, 3


def within_one_bf16_ulp(got, want) -> bool:
    """Each element of ``got`` within one bf16 ulp of ``want``'s (the ulp
    of max(|want|, 1e-2)): two f32 sums in other orders, each rounded
    once to bf16."""
    scale = want.float().abs().clamp(min=1e-2)
    ulp = torch.exp2(torch.floor(torch.log2(scale)) - 7)
    return bool(((got.float() - want.float()).abs() <= ulp).all())


def registers(source: str, marker: str) -> list[tuple[int, int]]:
    """(registers, bytes of spill stores) of each kernel of ``source``
    whose mangled name holds ``marker`` (``-Xptxas -v`` in the build
    log)."""
    lines = (cuda_build.library_path(source).parent / "build.log"
             ).read_text().splitlines()
    out, name, spill = [], None, 0
    for line in lines:
        if "Compiling entry function" in line:
            name, spill = line.split("'")[1], 0
        elif "bytes spill stores" in line and name:
            spill = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif "Used" in line and "registers" in line and name:
            if marker in name:
                out.append((int(line.split("Used")[1].split()[0]), spill))
            name = None
    return out


def registers_text(regs: list[tuple[int, int]]) -> str:
    return ", ".join(f"{r} registers/{s} bytes spilled" for r, s in regs)


def phase_bf16_kernels(gen) -> dict:
    """(bf16 kernels): K1 on bf16 features against its plain version at
    the serve and train shapes, K2 at the train shape, for each of
    ``KINDS``: out and dvalue within one bf16 ulp, dpy/dpx/dmask within
    ``BF16_GRAD_RTOL``; their times with a warm and a cold L2, the plain
    times, the ``F.grid_sample`` yardsticks on bf16 and the byte bounds."""
    g, cg, p = 32, 8, 9
    worst = {"k1_err": 0.0, "k2_err": 0.0}
    rec = {}
    for n, h, w in ((1, 32, 44), (6, 32, 32)):
        for kind in KINDS:
            value, py, px, mask = sampler_inputs(n, h, w, g, cg, p, kind, gen)
            value = value.bfloat16()
            got = dcnv3.dcnv3_sample(value, py, px, mask)
            torch.cuda.synchronize()
            want = dcnv3.dcnv3_sample_reference(value, py, px, mask)
            check(got.dtype == torch.bfloat16 and bool(
                torch.isfinite(got).all()), f"bf16 K1 out ({kind}, N={n})")
            check(within_one_bf16_ulp(got, want), f"bf16 K1 beyond one ulp "
                  f"of plain ({kind}, N={n} {h}x{w})")
            err = (got.float() - want.float()).abs().max().item()
            worst["k1_err"] = max(worst["k1_err"], err)
            line = f"N={n} {h}x{w} {kind}: K1 max|kernel-plain|={err:.3g}"
            if n == 6:
                dout = torch.randn((n, h * w, g * cg), generator=gen).cuda()
                dout = dout.bfloat16()
                gk = dcnv3.dcnv3_sample_backward(value, py, px, mask, dout)
                torch.cuda.synchronize()
                gw = dcnv3.dcnv3_sample_backward_reference(value, py, px,
                                                           mask, dout)
                check(gk[0].dtype == torch.bfloat16
                      and within_one_bf16_ulp(gk[0], gw[0]),
                      f"bf16 K2 dvalue beyond one ulp ({kind})")
                errs = [(gk[0].float() - gw[0].float()).abs().max().item()]
                for name, a, b in zip(("dpy", "dpx", "dmask"), gk[1:],
                                      gw[1:]):
                    e = (a - b).abs().max().item()
                    check(bool(torch.isfinite(a).all()) and e <= BF16_GRAD_RTOL
                          * b.abs().max().item(),
                          f"bf16 K2 {name} off by {e:.3g} ({kind})")
                    errs.append(e)
                worst["k2_err"] = max(worst["k2_err"], *errs)
                line += (" K2 max|kernel-plain| dvalue={:.3g} dpy={:.3g} "
                         "dpx={:.3g} dmask={:.3g}".format(*errs))
            log("bf16 kernels", line)
        value, py, px, mask = sampler_inputs(n, h, w, g, cg, p, "random", gen)
        value = value.bfloat16()
        coords = py.numel()
        out_elems = n * h * w * g * cg
        lib = [value, py.bfloat16(), px.bfloat16(), mask.bfloat16()]

        def k1():
            return dcnv3.dcnv3_sample(value, py, px, mask)

        t = dict(ms=median_ms(k1), cold_ms=cuda_ms(k1, cold=True),
                 plain_ms=cuda_ms(lambda: dcnv3.dcnv3_sample_reference(
                     value, py, px, mask), iters=20),
                 library_ms=cuda_ms(lambda: grid_sample_yardstick(*lib),
                                    iters=20),
                 bytes_ms=(2 * value.numel() + 12 * coords + 2 * out_elems)
                 / HBM_BYTES_PER_S * 1e3,
                 ops_ms=coords * (4 * cg * 2 + 16) / F32_FLOPS_PER_S * 1e3)
        rec["k1", n] = t
        log("bf16 kernels", f"K1 N={n} {h}x{w} timing: kernel_ms="
            f"{t['ms']:.5f} cold_l2_ms={t['cold_ms']:.5f} plain_ms="
            f"{t['plain_ms']:.5f} library_ms={t['library_ms']:.5f} "
            f"byte_bound_us={t['bytes_ms'] * 1e3:.3f} "
            f"op_bound_us={t['ops_ms'] * 1e3:.3f}")
        if n != 6:
            continue
        dout = torch.randn((n, h * w, g * cg), generator=gen).cuda().bfloat16()
        ins = [a.clone().requires_grad_() for a in lib]
        lib_out = grid_sample_yardstick(*ins)

        def k2():
            return dcnv3.dcnv3_sample_backward(value, py, px, mask, dout)

        t = dict(ms=median_ms(k2), cold_ms=cuda_ms(k2, cold=True),
                 plain_ms=cuda_ms(
                     lambda: dcnv3.dcnv3_sample_backward_reference(
                         value, py, px, mask, dout), iters=10),
                 library_ms=cuda_ms(lambda: torch.autograd.grad(
                     lib_out, ins, dout, retain_graph=True), iters=20),
                 bytes_ms=(2 * (2 * value.numel() + dout.numel())
                           + 24 * coords) / HBM_BYTES_PER_S * 1e3,
                 ops_ms=coords * (4 * 4 * cg + 40) / F32_FLOPS_PER_S * 1e3)
        rec["k2", n] = t
        log("bf16 kernels", f"K2 N={n} {h}x{w} timing: kernel_ms="
            f"{t['ms']:.5f} cold_l2_ms={t['cold_ms']:.5f} plain_ms="
            f"{t['plain_ms']:.5f} library_ms={t['library_ms']:.5f} "
            f"byte_bound_us={t['bytes_ms'] * 1e3:.3f} "
            f"op_bound_us={t['ops_ms'] * 1e3:.3f}")
    for src, marker in ((dcnv3.SOURCE, "13__nv_bfloat16Li8E"),
                        (dcnv3.BWD_SOURCE, "13__nv_bfloat16Li8E")):
        log("bf16 kernels", f"{src} bf16 Cg=8: "
            f"{registers_text(registers(src, marker))}")
    rec.update(worst)
    return rec


def compare_logits(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """(class agreement, largest |logit gap|) of two logit maps."""
    agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    return agree, (a.float() - b.float()).abs().max().item()


def phase_bf16_serve(im32) -> dict:
    """(bf16 serve): the flagship at ``model.dtype='bfloat16'``, with the
    seeded weights of the f32 model ``im32``, serves the three images of
    (serve): K1's bf16 form 6 times a request, finite logits, the class
    agreement and largest logit gap against the f32 model, the median
    request ms and the peak memory."""
    im = drawn_model(PRESET, overrides=BF16_OPTS, seed=0)
    check(all(torch.equal(a, b) for a, b in zip(
        im.model.state_dict().values(), im32.model.state_dict().values())),
        "bf16 model does not hold the f32 model's weights")
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
            for hw in REQUEST_SHAPES]
    zero_launches()
    for img in imgs:
        api.inference_model(im, img)
    torch.cuda.synchronize()
    launches = read_launches()
    check(launches["k1_bf16"] == launches["k1"] == 6 * len(imgs),
          f"bf16 serve: K1 launches {launches}")
    gaps = []
    for img in imgs:
        padded, _ = api.resize_and_pad(im.cfg, img)
        x = torch.from_numpy(padded[None]).cuda()
        with f32_precision():
            lo = whole_logits(im.model, x)
            ref = whole_logits(im32.model, x)
        check(lo.dtype == torch.bfloat16 and bool(torch.isfinite(lo).all()),
              "bf16 logits not finite")
        gaps.append(compare_logits(lo, ref))
        log("bf16 serve", f"image {img.shape[:2]}: class agreement with f32 "
            f"{gaps[-1][0]:.6f}, max|logit gap| {gaps[-1][1]:.6g} (max|f32 "
            f"logit| {ref.abs().max().item():.6g})")
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        for img in imgs:
            torch.cuda.synchronize()
            t = time.perf_counter()
            api.inference_model(im, img)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
    return dict(launches=launches, request_ms=statistics.median(times),
                max_ms=max(times), n=len(times),
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                agreement=min(a for a, _ in gaps), gap=max(d for _, d in gaps))


def phase_bf16_train() -> dict:
    """(bf16 train): batch 6 of 512x512 at the preset's defaults (auction,
    ``compact_gt=32``, ``loss_at='gt'``) at bf16, then with
    ``model.remat=True`` and ``train.packed_residuals=True``: step ms and
    peak memory of each, the bf16 K1/K2 launches (K1 twice per DCN layer
    under remat: the recomputation samples again), finite losses, and the
    first step's losses equal across the two settings within
    ``KNOB_RTOL``."""
    rng = np.random.default_rng(0)
    out = {}
    for tag, extra in (("bf16", []), ("bf16+remat+packed", [
            "model.remat=True", "train.packed_residuals=True"])):
        tr = drawn_trainer(PRESET, BF16_OPTS + extra, seed=0)
        if not out:
            b, hw = tr.cfg.data.batch_size, tuple(tr.cfg.data.crop_size)
            batches = [synthetic_batch(rng, b, hw)
                       for _ in range(BF16_WARMUP + BF16_TIMED)]
        res = timed_steps(tr, batches, BF16_WARMUP, tag,
                          k1_per_step=12 if extra else 6)
        check(res["launches"]["k1_bf16"] == res["launches"]["k1"]
              and res["launches"]["k2_bf16"] == res["launches"]["k2"],
              f"{tag}: a K1/K2 launch was not the bf16 form")
        out[tag] = res
        del tr
        torch.cuda.empty_cache()
    a, b = (out[t]["first"] for t in out)
    worst = max(abs(a[k] - b[k]) / max(abs(a[k]), 1e-12)
                for k in a if k.startswith(("loss", "d", "total")))
    log("bf16 train", f"first step's losses with remat+packed against "
        f"without: max rel diff {worst:.3g} (tol {KNOB_RTOL})")
    check(worst <= KNOB_RTOL, f"remat/packed changed the first step's "
          f"losses by {worst:.3g}")
    out["knob_rel"] = worst
    return out


def bf16_tiny_inputs() -> tuple:
    """(bf16 tiny)'s overrides, 64x64 image and 3 train batches (maps of
    4 classes)."""
    opts = [f"model.{k}={v!r}".replace(" ", "") for k, v in TINY.items()]
    opts += BF16_OPTS
    x = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (1, 64, 64, 3)).astype(np.float32))
    rng = np.random.default_rng(1)
    batches = [synthetic_batch(rng, 2, (64, 64), num_classes=4)
               for _ in range(3)]
    return opts, x, batches


def bf16_tiny_cpu(threads: int) -> dict:
    """(bf16 tiny)'s CPU side, on ``threads`` CPU threads: the tiny
    model's bf16 logits and its 3 train steps' ``total``.  bf16 runs
    slowly on the CPU, so ``main`` computes this while ``nvcc`` builds
    the kernels, on the cores the build leaves."""
    torch.set_num_threads(threads)
    opts, x, batches = bf16_tiny_inputs()
    cpu = drawn_model(PRESET, overrides=opts, device="cpu", seed=1)
    with torch.inference_mode():
        logits = cpu.model.predict_logits(x)
    tr = drawn_trainer(PRESET, opts + ["train.warmup_iters=1"],
                       device="cpu", seed=1)
    return dict(logits=logits,
                totals=[m["total"] for m in api.train_steps(tr, batches)])


def phase_bf16_tiny(cpu_ref: dict) -> dict:
    """(bf16 tiny): the tiny model at bf16, card against CPU
    (``bf16_tiny_cpu``'s ``cpu_ref``): logits at 64x64 (class agreement,
    largest gap) and 3 train steps' ``total`` with the preset's auction
    matcher (maps of 4 classes)."""
    opts, x, batches = bf16_tiny_inputs()
    gpu = drawn_model(PRESET, overrides=opts, seed=1)
    with torch.inference_mode(), f32_precision():
        agree, gap = compare_logits(gpu.model.predict_logits(x.cuda()).cpu(),
                                    cpu_ref["logits"])
    log("bf16 tiny", f"64x64 card vs CPU at bf16: class agreement "
        f"{agree:.6f}, max|logit gap| {gap:.6g}")
    check(agree >= BF16_AGREEMENT and gap <= BF16_LOGIT_GAP,
          f"bf16 tiny card vs CPU: agreement {agree}, gap {gap}")
    tr = drawn_trainer(PRESET, opts + ["train.warmup_iters=1"], seed=1)
    totals = [cpu_ref["totals"],
              [m["total"] for m in api.train_steps(tr, batches)]]
    rel = max(abs(a - b) / abs(b) for a, b in zip(totals[1], totals[0]))
    log("bf16 tiny", f"3 steps' total CPU {totals[0]} card {totals[1]}: "
        f"max rel diff {rel:.3g} (tol {BF16_TRAIN_RTOL})")
    check(rel <= BF16_TRAIN_RTOL, f"bf16 tiny train card vs CPU {rel:.3g}")
    return dict(agreement=agree, gap=gap, train_rel=rel)


# the train CLI's seeded tree: the 12 training images of ADE_LIKE_SHAPES
# (two batches of 6 an epoch) and the three val images of (eval)
CLI_ITERS, CLI_RESUMED_ITERS, CLI_LOG = 10, 14, 2
CLI_OPTS = ["train.checkpoint_interval=5", "train.val_interval=5",
            "train.max_keep_ckpts=1"]
# log records whose window holds neither a val nor a checkpoint nor the
# resumed run's start
CLI_STEADY_STEPS = (4, 8, 14)
LOADER_BATCHES = 10


def state_snapshot(state) -> dict:
    """Host copies of what a train checkpoint holds."""
    def copy(tensors):
        return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}

    opt = state.optimizer.state_dict()
    return {"step": state.step, "count": opt["count"],
            "model": copy(state.model.state_dict()), "mu": copy(opt["mu"]),
            "nu": copy(opt["nu"])}


def check_saved(raw: dict, want: dict, what: str) -> None:
    """A loaded train checkpoint against a ``state_snapshot``, bit for
    bit."""
    check(raw["step"] == want["step"]
          and raw["optimizer"]["count"] == want["count"],
          f"{what}: step/count {raw['step']}/{raw['optimizer']['count']}, "
          f"expected {want['step']}/{want['count']}")
    for part, got in (("model", raw["model"]), ("mu", raw["optimizer"]["mu"]),
                      ("nu", raw["optimizer"]["nu"])):
        check(got.keys() == want[part].keys(), f"{what}: {part} keys")
        bad = [k for k, v in want[part].items() if not torch.equal(got[k], v)]
        check(not bad, f"{what}: {part} differs at {bad[:5]}")


@contextlib.contextmanager
def watch_checkpoints(store: dict):
    """Spy on the train CLI's ``save_state`` and ``restore_state``.  Each
    save's state is snapshot when the save returns (its file is still
    being written while the next steps update the state in place); the
    file is held to the snapshot once the next save has waited for it
    (and before that save prunes it), or at the end.  Each restore is held
    to the file it read."""
    real_save, real_restore = train_cli.save_state, train_cli.restore_state
    store.update(pending={}, checked=[], restored=[])

    def settle():
        checkpoint.wait_for_saves()
        for path, snap in list(store["pending"].items()):
            check_saved(torch.load(path, weights_only=True), snap, path)
            store["checked"].append((os.path.relpath(path, store["root"]),
                                     snap["step"]))
            del store["pending"][path]

    def save(work_dir, state, step, **kw):
        settle()
        path = real_save(work_dir, state, step, **kw)
        store["pending"][path] = state_snapshot(state)
        return path

    def restore(path, state):
        out = real_restore(path, state)
        check_saved(torch.load(path, weights_only=True),
                    state_snapshot(state), f"restored {path}")
        store["restored"].append((os.path.basename(path), state.step))
        store["state"] = state
        return out

    train_cli.save_state, train_cli.restore_state = save, restore
    try:
        yield settle
    finally:
        train_cli.save_state, train_cli.restore_state = real_save, real_restore


def run_cli(main, args: list[str], tag: str,
            phase: str = "train cli") -> list[str]:
    """``main(args)`` with its standard output captured and logged."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(args)
    lines = buf.getvalue().splitlines()
    for line in lines:
        log(phase, f"{tag}: {line}")
    check(rc == 0, f"{tag}: exit code {rc}")
    return lines


def loader_rate(root: str, workers: int) -> float:
    """Batches a second of the flagship's ``TrainLoader`` (batch 6,
    512x512 crops) alone, over ``LOADER_BATCHES`` after the first."""
    ds = make_dataset("ade20k", root, "train")
    with TrainLoader(ds, 6, (512, 512), seed=0, num_workers=workers) as ld:
        it = iter(ld)
        next(it)
        t = time.perf_counter()
        for _ in range(LOADER_BATCHES):
            next(it)
        return LOADER_BATCHES / (time.perf_counter() - t)


def step_under_loader(root: str, steps: int = 4) -> dict:
    """Median ms of a full-width ``api.train_steps`` step on the loader's
    batches: taken from memory (the loader closed), and taken while a
    live ``TrainLoader`` (``num_workers=8``) produces the next ones in its
    threads, as in the train CLI."""
    tr = drawn_trainer(PRESET, seed=0)
    ds = make_dataset("ade20k", root, "train")
    with TrainLoader(ds, 6, (512, 512), seed=1, num_workers=8) as ld:
        it = iter(ld)
        batches = [next(it) for _ in range(2 + steps)]

    def timed(batch) -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        api.train_steps(tr, [batch])
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    for b in batches[:2]:
        timed(b)
    costs = []
    with capture_auction(costs):
        memory = [timed(b) for b in batches[2:]]
    # the auction's iterations are data-dependent; on (train)'s synthetic
    # batch (auction) reports them
    iterations = [int(auction_match(c, with_stats=True)[1].iterations)
                  for c in costs]
    with TrainLoader(ds, 6, (512, 512), seed=2, num_workers=8) as ld:
        it = iter(ld)
        live = [timed(next(it)) for _ in range(steps)]
    del tr
    torch.cuda.empty_cache()
    return dict(memory_ms=statistics.median(memory),
                live_ms=statistics.median(live), memory=memory, live=live,
                iterations=iterations,
                classes=[len(np.unique(s[s != 255])) for _, sem in batches
                         for s in sem])


def phase_train_cli(step_ms: float, smi: str) -> dict:
    """(train cli): the train CLI at full width on a seeded ADE20K-layout
    tree at the preset's defaults (auction, ``compact_gt=32``, batch 6,
    512x512 crops): 10 iterations with a checkpoint and a val every 5
    (3 val images, an overlay each), then ``--resume`` to 14; the eval
    CLI on the best checkpoint; the loader alone; one save timed."""
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "ade")
        write_ade_tree(root, ADE_LIKE_SHAPES, seed=3, split="training")
        write_ade_tree(root, REQUEST_SHAPES, seed=0)
        wd = os.path.join(tmp, "wd")
        base = [PRESET, "--data-root", root, "--work-dir", wd,
                "--log-interval", str(CLI_LOG), "--eval-images", "3",
                "--vis-interval", "1"]
        store = {"root": wd}
        runs = {}
        with watch_checkpoints(store) as settle:
            for tag, iters, extra in (("first", CLI_ITERS, []),
                                      ("resumed", CLI_RESUMED_ITERS,
                                       ["--resume"])):
                torch.cuda.synchronize()
                zero_launches()
                t = time.perf_counter()
                lines = run_cli(train_cli.main, base + extra + [
                    "--cfg-options", *CLI_OPTS,
                    f"train.total_iters={iters}"], tag)
                torch.cuda.synchronize()
                runs[tag] = dict(lines=lines, launches=read_launches(),
                                 s=time.perf_counter() - t)
                settle()
                files = sorted(
                    os.path.relpath(os.path.join(d, f), wd)
                    for d, _, fs in os.walk(wd) for f in fs)
                runs[tag]["files"] = files
                log("train cli", f"{tag}: {runs[tag]['s']:.1f}s, files "
                    f"{files}")
        first, resumed = runs["first"], runs["resumed"]
        vals = {int(line.split()[1]): line.split()[4]
                for line in first["lines"] if " val mIoU " in line}
        check(sorted(vals) == [5, 10], f"val lines at {sorted(vals)}")
        # launches: 6 K1 and 6 K2 a train iteration, 6 K1 a val image
        for tag, steps, val_images in (("first", CLI_ITERS, 6),
                                       ("resumed",
                                        CLI_RESUMED_ITERS - CLI_ITERS, 0)):
            n = runs[tag]["launches"]
            check(n["k1"] == 6 * (steps + val_images)
                  and n["k2"] == 6 * steps,
                  f"{tag}: K1/K2 launches {n['k1']}/{n['k2']} for {steps} "
                  f"iterations and {val_images} val images")
        best = [f for f in first["files"] if f.startswith("best/")]
        check(len(best) == 1, f"best checkpoints {best}")
        want_first = sorted(
            ["ckpt_10", "scalars.jsonl", *best]
            + [f"vis/iter_{i}/val_{j:05d}.png" for i in (5, 10)
               for j in range(3)])
        check(first["files"] == want_first,
              f"first run's files {first['files']}")
        check(resumed["files"] == sorted(
            ["ckpt_14"] + [f for f in want_first if f != "ckpt_10"]),
              f"resumed run's files {resumed['files']}")
        check(resumed["lines"][0] == f"resumed from {wd}/ckpt_10 at step 10"
              and store["restored"] == [("ckpt_10", 10)],
              f"resume: {resumed['lines'][:1]} {store['restored']}")
        # each save, held to the state at its step once written: the
        # periodic and best saves at 5 and 10, the final saves at 10 and 14
        best_step = int(best[0].split("_")[1])
        want = ([("ckpt_5", 5), ("best/ckpt_5", 5), ("ckpt_10", 10)]
                + ([("best/ckpt_10", 10)] if best_step == 10 else [])
                + [("ckpt_10", 10), ("ckpt_14", 14)])
        check(store["checked"] == want,
              f"checkpoints held to the state: {store['checked']}")
        recs = read_scalars(os.path.join(wd, "scalars.jsonl"))
        losses = [r for r in recs if "total" in r]
        check([r["step"] for r in losses] == [2, 4, 6, 8, 10, 12, 14],
              f"logged steps {[r['step'] for r in losses]}")
        for r in losses:
            bad = [k for k, v in r.items() if not np.isfinite(v)]
            check(not bad, f"step {r['step']}: non-finite {bad}")
        sec = {r["step"]: r["sec_per_iter"] for r in losses}
        steady = statistics.median(sec[s] * 1e3 for s in CLI_STEADY_STEPS)

        # the eval CLI on the best checkpoint gives the printed mIoU
        zero_launches()
        lines = run_cli(eval_cli.main,
                        [PRESET, "--data-root", root, "--checkpoint",
                         os.path.join(wd, best[0]), "--max-images", "3"],
                        "eval --checkpoint")
        eval_launches = read_launches()
        check(lines[-1].split()[1] == vals[best_step],
              f"eval CLI on {best[0]}: {lines[-1]}, the train CLI printed "
              f"{vals[best_step]}")

        rates = {w: loader_rate(root, w)
                 for w in sorted({8, os.cpu_count() or 8})}
        under = step_under_loader(root)
        state = store["state"]
        t = time.perf_counter()
        path = checkpoint.save_state(os.path.join(tmp, "timed"), state,
                                     state.step)
        inline_ms = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        checkpoint.wait_for_saves()
        write_ms = (time.perf_counter() - t) * 1e3
        mb = os.path.getsize(path) / 1e6
    log("train cli", f"s/iter by log record (ms): "
        f"{ {k: round(v * 1e3, 1) for k, v in sec.items()} }; steady (steps "
        f"{CLI_STEADY_STEPS}) {steady:.1f} ms against (train)'s step "
        f"{step_ms:.1f} ms ({steady / step_ms:.3f}x) on {smi}")
    log("train cli", "loader alone, batches/s by num_workers: "
        + ", ".join(f"{w}: {r:.3f}" for w, r in rates.items())
        + f" (os.cpu_count() {os.cpu_count()}) on {smi}")
    log("train cli", f"api.train_steps on the loader's batches: "
        f"{under['memory_ms']:.1f} ms a step from memory "
        f"{[round(x, 1) for x in under['memory']]}, {under['live_ms']:.1f} "
        f"ms under a live loader {[round(x, 1) for x in under['live']]} "
        f"on {smi}; auction iterations on the memory steps "
        f"{under['iterations']}, classes per crop {under['classes']}")
    log("train cli", f"checkpoint {mb:.1f} MB: inline copy {inline_ms:.1f} "
        f"ms, background write {write_ms:.1f} ms on {smi}")
    log("train cli", f"K1/K2 launches: first run {first['launches']['k1']}/"
        f"{first['launches']['k2']}, resumed {resumed['launches']['k1']}/"
        f"{resumed['launches']['k2']}, eval CLI K1 {eval_launches['k1']}")
    return dict(launches=[first["launches"], resumed["launches"],
                          eval_launches],
                steady_ms=steady, sec=sec, rates=rates, under=under,
                inline_ms=inline_ms, write_ms=write_ms, mb=mb)


# tests/torch_golden.py's dims for a tiny reference-format checkpoint
GOLDEN = dict(num_classes=5, embed_dim=(8, 16, 24, 32), backbone_heads=4,
              feat_channels=16, num_queries=4, num_decoder_layers=2,
              num_encoder_layers=2, depths_stage3=1, depths_stage4=1,
              dcn_group=4)


def golden_state_dict(seed: int = 3, variant: str = "sdtv2") -> dict:
    """The reference-format state dict of ``tests/torch_golden.py``'s
    ``GoldenSpike2Former`` with the ``variant`` backbone at ``GOLDEN``'s
    dims, drawn by its ``randomize_torch``.  Its forward needs ``tests/test_dcnv3.py``,
    which imports JAX; only the state dict is taken here, so that import
    is answered by an empty module."""
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    saved = {k: sys.modules.get(k) for k in ("test_dcnv3", "torch_golden")}
    sys.modules["test_dcnv3"] = types.ModuleType("test_dcnv3")
    sys.modules["test_dcnv3"].torch_dcnv3_golden = None
    sys.path.insert(0, tests)
    try:
        import torch_golden
    finally:
        sys.path.remove(tests)
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v
    g = GOLDEN
    golden = torch_golden.GoldenSpike2Former(
        num_classes=g["num_classes"], embed_dim=g["embed_dim"],
        heads=g["backbone_heads"], T=1, feat=g["feat_channels"],
        num_queries=g["num_queries"], dec_layers=g["num_decoder_layers"],
        enc_layers=g["num_encoder_layers"], group=g["dcn_group"],
        depths_stage3=g["depths_stage3"], depths_stage4=g["depths_stage4"],
        variant=variant)
    torch_golden.randomize_torch(golden, seed=seed)
    return golden.state_dict()


def phase_reference() -> dict:
    """(reference): a reference-format checkpoint through
    ``load_reference_model`` onto the card, its logits against the
    CPU's, and through the eval CLI's ``--torch-checkpoint`` on the
    card."""
    depths = {k: GOLDEN[k] for k in ("depths_stage3", "depths_stage4",
                                      "num_encoder_layers",
                                      "num_decoder_layers")}
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "golden.pth")
        torch.save({"state_dict": golden_state_dict()}, path)
        sd = load_reference_model(path, **depths)
        cpu = Spike2Former(T=1, compat=True, **GOLDEN)
        cpu.load_state_dict(sd, strict=True)
        gpu = copy.deepcopy(cpu).cuda()
        x = torch.from_numpy(np.random.default_rng(2).normal(
            0, 1, (1, 64, 64, 3)).astype(np.float32))
        with torch.inference_mode(), f32_precision():
            want = cpu.eval().predict_logits(x)
            got = gpu.eval().predict_logits(x.cuda()).cpu()
        err = (got - want).abs().max().item()
        check(torch.allclose(got, want, atol=MODEL_TOL, rtol=MODEL_TOL),
              f"reference checkpoint card vs CPU: max|diff|={err:.3g}")
        root = write_ade_tree(os.path.join(d, "ade"), ((96, 128), (128, 96)),
                              seed=1)
        opts = [f"model.{k}={v!r}".replace(" ", "") for k, v in GOLDEN.items()]
        opts.append("data.test_scale=(128,96)")
        buf = io.StringIO()
        before = dcnv3.dcnv3_sample.launches
        with contextlib.redirect_stdout(buf):
            rc = eval_cli.main([PRESET, "--data-root", root,
                                "--torch-checkpoint", path,
                                "--cfg-options", *opts])
        lines = buf.getvalue().splitlines()
        check(rc == 0 and lines[-2] == "images: 2"
              and lines[-1].startswith("mIoU "),
              f"eval CLI with a reference checkpoint printed {lines}")
        check(dcnv3.dcnv3_sample.launches > before,
              "the eval CLI did not run K1")
    log("reference", f"reference-format checkpoint: logits card vs CPU "
        f"max|diff|={err:.3g} (tol {MODEL_TOL}); eval CLI on the card: "
        f"{' | '.join(lines[-2:])}")
    return dict(err=err, cli=lines[-2:])



# --- firing rates, TTA and the Inferencer, point-sampled
# losses, the Cityscapes and COCO-Stuff presets ------------------------------

@contextlib.contextmanager
def capture_dcn(store: dict, first: int = 0):
    """Keep a copy of the inputs and outputs of every K1 and K2 call made
    inside the block (the calls launch and count as usual); with
    ``first``, of the first ``first`` calls of each kernel at each batch
    size only."""
    real_f, real_b = dcnv3.dcnv3_sample, dcnv3.dcnv3_sample_backward
    seen = collections.Counter()

    def keep(kernel, value):
        seen[kernel, value.shape[0]] += 1
        return not first or seen[kernel, value.shape[0]] <= first

    def fwd(value, py, px, mask, **kw):
        out = real_f(value, py, px, mask, **kw)
        if keep("k1", value):
            store.setdefault("k1", []).append(
                [t.detach().clone() for t in (value, py, px, mask, out)])
        return out

    def bwd(value, py, px, mask, dout):
        out = real_b(value, py, px, mask, dout)
        if keep("k2", value):
            store.setdefault("k2", []).append(
                [t.clone() for t in (value, py, px, mask, dout, *out)])
        return out

    dcnv3.dcnv3_sample, dcnv3.dcnv3_sample_backward = fwd, bwd
    try:
        yield store
    finally:
        dcnv3.dcnv3_sample, dcnv3.dcnv3_sample_backward = real_f, real_b


def hold_captured(store: dict, tag: str, k1: int, k2: int = 0,
                  shapes: tuple = ()) -> dict:
    """Each captured K1 and K2 call against its plain version on the same
    card tensors; returns the largest differences and the shapes seen.
    Fails unless exactly ``k1`` K1 and ``k2`` K2 calls were captured and
    each ``(kernel, value shape)`` of ``shapes`` is among them."""
    n1, n2 = len(store.get("k1", [])), len(store.get("k2", []))
    check((n1, n2) == (k1, k2), f"{tag}: captured {n1} K1 and {n2} K2 "
          f"calls, expected {k1} and {k2}")
    worst = dict(k1=0.0, k2=0.0, shapes=set())
    for value, py, px, mask, out in store.get("k1", []):
        plain = dcnv3.dcnv3_sample_reference(value, py, px, mask)
        err = (out.float() - plain.float()).abs().max().item()
        close = (within_one_bf16_ulp(out, plain)
                 if value.dtype == torch.bfloat16 else err <= KERNEL_TOL)
        check(bool(torch.isfinite(out).all()) and close,
              f"{tag}: K1 at {tuple(value.shape)} {value.dtype} vs plain "
              f"{err:.3g} (tol {KERNEL_TOL} in f32, one ulp in bf16)")
        worst["k1"] = max(worst["k1"], err)
        worst["shapes"].add(("K1", tuple(value.shape)))
    for value, py, px, mask, dout, *got in store.get("k2", []):
        want = dcnv3.dcnv3_sample_backward_reference(value, py, px, mask,
                                                     dout)
        for name, gv, wv in zip(("dvalue", "dpy", "dpx", "dmask"), got,
                                want):
            check(bool(torch.isfinite(gv).all()) and torch.allclose(
                gv, wv, atol=BWD_ATOL, rtol=BWD_RTOL),
                f"{tag}: K2 {name} at {tuple(value.shape)} vs plain beyond "
                f"atol {BWD_ATOL} rtol {BWD_RTOL}: "
                f"{(gv - wv).abs().max().item():.3g}")
            worst["k2"] = max(worst["k2"], (gv - wv).abs().max().item())
        worst["shapes"].add(("K2", tuple(value.shape)))
    log(tag, f"captured calls held to their plain versions: "
        f"{len(store.get('k1', []))} K1 (max|diff| {worst['k1']:.3g}), "
        f"{len(store.get('k2', []))} K2 (max|diff| {worst['k2']:.3g}) at "
        f"{sorted(worst['shapes'])}")
    missing = set(shapes) - worst["shapes"]
    check(not missing, f"{tag}: no captured call at {sorted(missing)}")
    return worst


@contextlib.contextmanager
def mask_shares(shares: list):
    """Append, for every K1 call inside the block (one a DCN layer, in
    order), the share of its mask spikes that are non-zero."""
    real = dcnv3.dcnv3_sample

    def fwd(value, py, px, mask, **kw):
        shares.append(float((mask != 0).float().mean()))
        return real(value, py, px, mask, **kw)

    dcnv3.dcnv3_sample = fwd
    try:
        yield shares
    finally:
        dcnv3.dcnv3_sample = real


def hold_on_grid(store: dict, tag: str, seed: int) -> dict:
    """At flax's init the DCN input of the flagship's pixel decoder is
    silent (its spikes are 0) and the mask kernel is zero, so each
    captured K1 output and K2 gradient is exactly zero (checked) and a
    hold of them against the plain versions proves nothing.  Each
    captured call is held again at its own coordinates (at flax's init
    the offsets are zero: every tap on the reference grid, the pad ring
    included) and shapes, with a seeded value, mask and ``dout`` in its
    dtypes: the outputs non-zero and within the tolerances of (c), (k2)
    and (bf16 kernels) of the plain versions, from a generator seeded
    with ``seed``.  Returns the largest differences."""
    worst, gen = dict(k1=0.0, k2=0.0), torch.Generator().manual_seed(seed)

    def like(t, kind):
        x = torch.empty(t.shape, dtype=torch.float32)
        getattr(x, kind)(generator=gen)
        return x.to(device=t.device, dtype=t.dtype)

    for value, py, px, mask, out in store.get("k1", []):
        check(not out.any(), f"{tag}: a K1 output of the path is not zero")
        v, m = like(value, "normal_"), like(mask, "uniform_")
        got = dcnv3.dcnv3_sample(v, py, px, m)
        plain = dcnv3.dcnv3_sample_reference(v, py, px, m)
        err = (got.float() - plain.float()).abs().max().item()
        close = (within_one_bf16_ulp(got, plain)
                 if v.dtype == torch.bfloat16 else err <= KERNEL_TOL)
        check(bool(got.any()) and close, f"{tag}: K1 on the path's grid "
              f"at {tuple(v.shape)} {v.dtype} vs plain {err:.3g}")
        worst["k1"] = max(worst["k1"], err)
    for value, py, px, mask, dout, *grads in store.get("k2", []):
        check(not any(g.any() for g in grads[:3]),
              f"{tag}: a K2 gradient of the path is not zero")
        v, m, d = (like(value, "normal_"), like(mask, "uniform_"),
                   like(dout, "normal_"))
        got = dcnv3.dcnv3_sample_backward(v, py, px, m, d)
        want = dcnv3.dcnv3_sample_backward_reference(v, py, px, m, d)
        bf16 = v.dtype == torch.bfloat16
        for name, gv, wv in zip(("dvalue", "dpy", "dpx", "dmask"), got,
                                want):
            err = (gv.float() - wv.float()).abs().max().item()
            if bf16:   # as (bf16 kernels) holds them
                close = (within_one_bf16_ulp(gv, wv) if name == "dvalue"
                         else err <= BF16_GRAD_RTOL * wv.abs().max().item())
            else:
                close = torch.allclose(gv, wv, atol=BWD_ATOL, rtol=BWD_RTOL)
            check(bool(gv.any()) and bool(close), f"{tag}: K2 {name} on "
                  f"the path's grid vs plain {err:.3g}")
            worst["k2"] = max(worst["k2"], err)
    silent = sum(not value.any() for value, *_ in store.get("k1", []))
    log(tag, f"the path's {len(store.get('k1', []))} K1 and "
        f"{len(store.get('k2', []))} K2 calls, zero at flax's init (the "
        f"value map all zero in {silent} K1 calls), held again on their "
        f"grids with seeded values and masks: max|diff| K1 "
        f"{worst['k1']:.3g}, K2 {worst['k2']:.3g}")
    return worst

def device_busy_ms(fn, cpu: bool = True) -> float:
    """The device's kernel time in one call of ``fn`` (``torch.profiler``;
    the train step's ``record_function`` ranges left out).  ``cpu=False``
    traces the card alone, which a step's tens of thousands of host
    events make several times cheaper to read."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if cpu:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key not in STAGES) / 1e3
    check(busy > 0, "the profiler saw no device time")
    return busy


FIRING_SHAPES = ((512, 683), (683, 512), (512, 512), (384, 512))


def phase_firing(smi: str) -> dict:
    """(firing): ``tools/cal_firing_num.py`` at full width on a seeded
    ADE20K tree of four images (T=1 without the collapse, every decoder
    layer through the SDME sites, 512x512 crops): sites, energy proxy,
    time and K1 launches an image; the tiny model's rates on the card
    against the CPU's."""
    with tempfile.TemporaryDirectory() as root:
        write_ade_tree(root, FIRING_SHAPES, seed=1)
        out = os.path.join(root, "rates")
        args = [PRESET, "--data-root", root, "--checkpoint",
                drawn_checkpoint(os.path.join(root, "drawn.pt")),
                "--num-images", "4", "--out", out]
        zero_launches()
        t = time.perf_counter()
        lines = run_cli(cal_firing_num.main, args, "cli", phase="firing")
        torch.cuda.synchronize()
        cli_ms = (time.perf_counter() - t) * 1e3
        launches = read_launches()
        with open(out + ".json") as f:
            rates = json.load(f)
        with open(out + ".csv") as f:
            rows = f.read().splitlines()
        store = {}
        with capture_dcn(store):
            run_cli(cal_firing_num.main, args[:5] + [
                "--num-images", "1", "--out", out + "_check"], "check",
                phase="firing")
    held = hold_captured(store, "firing", k1=6)
    sites = len(rates) // 2
    check(launches["k1"] == 6 * len(FIRING_SHAPES),
          f"firing: expected {6 * len(FIRING_SHAPES)} K1 launches, got "
          f"{launches['k1']}")
    check(all(np.isfinite(v) and v >= 0 for v in rates.values())
          and len(rows) == len(rates) + 1
          and f"{len(rates)} spike sites" in lines[0],
          f"firing: {len(rates)} keys, {len(rows)} CSV rows")
    proxy = energy_proxy(rates)
    # an image's forward with the statistics, warm, on the CLI's model
    im = drawn_model(PRESET, overrides=["model.collapse_t=False",
                                        "model.eval_last_only=False"],
                     seed=0)
    x = preprocess(torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (1, 512, 512, 3), dtype=np.uint8)).cuda())
    with f32_precision():
        firing_rates(im.model, x)
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            firing_rates(im.model, x)
            times.append((time.perf_counter() - t) * 1e3)
    ms = statistics.median(times)
    del im
    log("firing", f"{sites} sites ({len(rates)} keys) at full width; "
        f"energy_proxy {proxy:.6f}; CLI {cli_ms / len(FIRING_SHAPES):.3f} "
        f"ms an image (wall over 4 images, the model's construction and "
        f"the loading included); a 512x512 forward with the statistics "
        f"{ms:.3f} ms (median of 5, warm); K1 launches {launches['k1']} "
        f"({launches['k1'] / len(FIRING_SHAPES):g} an image) on {smi}")

    cpu = Spike2Former(T=2, collapse_t=False, eval_last_only=False, **TINY)
    randomize_(cpu, seed=2)
    gpu = copy.deepcopy(cpu).cuda()
    x = torch.from_numpy(np.random.default_rng(2).normal(
        0, 1, (1, 64, 64, 3)).astype(np.float32))
    with f32_precision():
        want = firing_rates(cpu.eval(), x)
        got = firing_rates(gpu.eval(), x.cuda())
    check(set(got) == set(want), "firing: card and CPU key sets differ")
    gap = max(abs(got[k] - want[k]) for k in want)
    check(gap <= FIRING_TOL, f"firing: tiny card vs CPU {gap:.3g} > "
          f"{FIRING_TOL}")
    log("firing", f"tiny model T=2 card vs CPU: {len(got)} keys equal, "
        f"largest rate gap {gap:.3g} (tol {FIRING_TOL})")
    return dict(launches=launches, sites=sites, proxy=proxy, ms=ms,
                tiny_gap=gap, held=held)


TTA_SCALES = (0.75, 1.0, 1.25)


def phase_tta(im, smi: str) -> dict:
    """(tta): a full-width ``tta_logits`` request (flip x scales 0.75,
    1.0, 1.25 of a 512x512 image), its time and K1 launches; the tiny
    model's TTA on the card against the CPU's; the ``Inferencer`` on two
    images with overlays."""
    rng = np.random.default_rng(3)
    img = torch.from_numpy(rng.integers(0, 256, (1, 512, 512, 3),
                                        dtype=np.uint8)).cuda()

    def request():
        with torch.inference_mode(), f32_precision():
            return tta_logits(im.model.predict_logits, preprocess(img),
                              TTA_SCALES, flip=True)

    request()
    torch.cuda.synchronize()
    zero_launches()
    times = []
    for _ in range(3):
        t = time.perf_counter()
        logits = request()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    launches = read_launches()
    variants = 2 * len(TTA_SCALES)
    check(launches["k1"] == 6 * variants * len(times),
          f"tta: expected {6 * variants * len(times)} K1 launches, got "
          f"{launches['k1']}")
    check(tuple(logits.shape) == (1, 512, 512, im.num_classes)
          and bool(torch.isfinite(logits).all()), "tta: bad logits")
    store = {}
    with capture_dcn(store):
        request()
    held = hold_captured(store, "tta", k1=6 * variants)
    ms = statistics.median(times)
    log("tta", f"flip x scales {TTA_SCALES} on 512x512: {ms:.3f} ms a "
        f"request (median of {len(times)}: "
        f"{[round(x, 1) for x in times]}); K1 launches {launches['k1']} "
        f"({launches['k1'] / len(times) / variants:g} a variant) on {smi}")

    cpu = randomize_(Spike2Former(T=1, **TINY), seed=3).eval()
    gpu = copy.deepcopy(cpu).cuda()
    x = torch.from_numpy(np.random.default_rng(4).normal(
        0, 1, (1, 64, 48, 3)).astype(np.float32))
    with torch.inference_mode(), f32_precision():
        want = tta_logits(cpu.predict_logits, x, (0.5, 1.0, 1.5))
        got = tta_logits(gpu.predict_logits, x.cuda(), (0.5, 1.0, 1.5)).cpu()
    gap = (got - want).abs().max().item()
    check(torch.allclose(got, want, atol=MODEL_TOL, rtol=MODEL_TOL),
          f"tta: tiny card vs CPU {gap:.3g}")
    log("tta", f"tiny model TTA (flip x 0.5/1.0/1.5) card vs CPU "
        f"max|diff| {gap:.3g} (tol {MODEL_TOL})")

    inf = api.Inferencer(PRESET, seed=0)
    imgs = [rng.integers(0, 256, hw + (3,), dtype=np.uint8)
            for hw in REQUEST_SHAPES[:2]]
    with tempfile.TemporaryDirectory() as out_dir:
        zero_launches()
        t = time.perf_counter()
        res = inf(imgs, out_dir=out_dir)
        torch.cuda.synchronize()
        inf_ms = (time.perf_counter() - t) * 1e3 / len(imgs)
        inf_launches = read_launches()
        files = sorted(os.listdir(out_dir))
    check(files == ["img_0_pred.png", "img_1_pred.png"]
          and [p.shape for p in res["predictions"]] == [
              i.shape[:2] for i in imgs]
          and inf_launches["k1"] == 6 * len(imgs),
          f"Inferencer: files {files}, K1 {inf_launches['k1']}")
    log("tta", f"Inferencer on 2 images: {inf_ms:.3f} ms an image (first "
        f"calls of a fresh model, overlays written), overlays {files}, K1 "
        f"launches {inf_launches['k1']} on {smi}")
    del inf
    return dict(launches=launches, inf_launches=inf_launches, ms=ms,
                tiny_gap=gap, held=held)


POINTS = 12544   # the upstream Mask2Former recipe: oversample 3, 0.75


def point_loss_card_vs_cpu() -> dict:
    """``maskformer_loss`` with ``num_points`` on the same small inputs
    and key on the card and on the CPU (the host matcher; JAX's points,
    the threefry kernel's on the card): each term within 1e-5 relative,
    the gradients within 1e-4 of the largest."""
    rng = np.random.default_rng(5)
    num_layers, b, nq, g, hw, c = 3, 2, 10, 8, 32, 16
    cls = rng.normal(size=(num_layers, b, nq, 7)).astype(np.float32)
    emb = rng.normal(0, 0.5, (num_layers, 1, b, nq, c)).astype(np.float32)
    feats = rng.normal(0, 0.5, (1, b, hw, hw, c)).astype(np.float32)
    labels = rng.integers(0, 6, (b, g))
    valid = np.zeros((b, g), bool)
    valid[:, :4] = True
    smap = rng.integers(0, 5, (b, 4 * hw, 4 * hw))
    results = []
    for dev in ("cpu", "cuda"):
        ins = [torch.from_numpy(a).to(dev).requires_grad_()
               for a in (cls, emb, feats)]
        gt = criterion.GroundTruth(
            labels=torch.from_numpy(labels).to(dev),
            valid=torch.from_numpy(valid).to(dev),
            dropped=torch.zeros(b, dtype=torch.long, device=dev),
            slot_map=torch.from_numpy(smap).to(dev))
        with f32_precision():
            out = criterion.maskformer_loss(
                ins[0], criterion.LazyMasks(ins[1], ins[2]), gt,
                num_classes=6, matcher="host", loss_at="gt",
                num_points=100, rng=jr.key(5))
            out["total"].backward()
        results.append(({k: float(v.detach()) for k, v in out.items()},
                        [t.grad.cpu() for t in ins]))
    (want, wg), (got, gg) = results
    rel = max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-6) for k in want)
    grad = max(((a - w).abs().max() / w.abs().max()).item()
               for a, w in zip(gg, wg))
    check(rel <= 1e-5 and grad <= 1e-4,
          f"point loss card vs CPU: losses rel {rel:.3g}, gradients "
          f"{grad:.3g} of the largest")
    return dict(rel=rel, grad=grad)


def phase_point_train(gt_step: dict, smi: str) -> dict:
    """(point train): the flagship step at ``train.loss_points=12544``
    (batch 6, 512x512, the preset's auction and ``compact_gt``) beside
    the GT-resolution step of (train): wall and device ms, peak memory,
    K1 and K2 launches, finite losses; the point loss card vs CPU."""
    tr = drawn_trainer(PRESET, [f"train.loss_points={POINTS}"], seed=0)
    check(tr.cfg.train.loss_points == POINTS, "loss_points not applied")
    rng = np.random.default_rng(0)
    batches = [synthetic_batch(rng, 6, (512, 512))
               for _ in range(POINT_WARMUP + POINT_TIMED)]
    res = timed_steps(tr, batches, POINT_WARMUP, "points")
    step = tr.step_fn
    batch = [torch.as_tensor(a, device="cuda") for a in batches[-1]]
    with f32_precision():
        busy = device_busy_ms(lambda: step(tr.state, *batch))
    store = {}
    with capture_dcn(store), f32_precision():
        step(tr.state, *batch)
    held = hold_captured(store, "point train", k1=6, k2=6)
    cmp_ = point_loss_card_vs_cpu()
    log("point train", f"loss_points={POINTS}: median step_ms="
        f"{res['step_ms']:.3f} (max {res['max_ms']:.3f}, n={res['n']}) "
        f"device_busy_ms={busy:.3f} peak_mem_gib={res['peak_gib']:.3f}; "
        f"GT-resolution step (train) step_ms={gt_step['step_ms']:.3f} "
        f"device_busy_ms={gt_step['busy_ms']:.3f} peak_mem_gib="
        f"{gt_step['peak_gib']:.3f}; first step loss_mask "
        f"{res['first']['loss_mask']:.6g} loss_dice "
        f"{res['first']['loss_dice']:.6g}; card vs CPU point loss rel "
        f"{cmp_['rel']:.3g}, gradients {cmp_['grad']:.3g} on {smi}")
    del tr
    return dict(res, busy_ms=busy, held=held, cmp=cmp_)


CITYSCAPES = "SDTv2_maskformer_DCNPixelDecoder_CityScapes"
# the DCN encoder's value maps [N, H, W, C] at 1/16: an eval image at
# (2048, 1024), a train step of two 512x1024 crops
CS_EVAL_MAP, CS_TRAIN_MAP = (1, 64, 128, 256), (2, 32, 64, 256)
COCO_STUFF = "SDTv2_maskformer_cocostuff164k_512x512"


def phase_presets(gen, smi: str) -> dict:
    """(presets): seeded Cityscapes (1024x2048) and COCO-Stuff trees
    through the port's converters; the eval CLI on two images of each
    (Cityscapes at its (2048, 1024) scale); one Cityscapes train step at
    batch 2 and 512x1024 after a warm-up; K1 and K2 held to their plain
    versions at the shapes these paths give them, and timed there."""
    out = {}
    with tempfile.TemporaryDirectory() as root:
        cs, coco = os.path.join(root, "cityscapes"), os.path.join(root, "coco")
        write_cityscapes_tree(cs, seed=6)
        write_coco_stuff_tree(coco, seed=7)
        run_cli(dataset_converters.main, ["cityscapes",
                                          os.path.join(cs, "gtFine")],
                "cityscapes", phase="presets")
        run_cli(dataset_converters.main, ["coco_stuff",
                                          os.path.join(coco, "annotations")],
                "coco_stuff", phase="presets")
        ckpt = {}
        for preset, data, name in ((CITYSCAPES, cs, "cityscapes"),
                                   (COCO_STUFF, coco, "coco_stuff164k")):
            ckpt[preset] = drawn_checkpoint(os.path.join(root, name + ".pt"),
                                            preset)
            args = [preset, "--data-root", data, "--max-images", "2",
                    "--checkpoint", ckpt[preset]]
            zero_launches()
            lines = run_cli(eval_cli.main, args, preset, phase="presets")
            torch.cuda.synchronize()
            launches = read_launches()
            check("images: 2" in lines and launches["k1"] == 12,
                  f"{preset} eval: {lines}, K1 {launches['k1']}")
            # the CLI's evaluate, warm, on a model built once
            im = drawn_model(preset, seed=0)
            ds = make_dataset(name, data, "val")
            eval_cli.evaluate(im, ds)
            passes = []
            for _ in range(EVAL_PASSES):
                torch.cuda.synchronize()
                t = time.perf_counter()
                eval_cli.evaluate(im, ds)
                torch.cuda.synchronize()
                passes.append((time.perf_counter() - t) * 1e3 / len(ds))
            ms = statistics.median(passes)
            log("presets", f"{preset} eval CLI: K1 launches "
                f"{launches['k1']} over 2 images; evaluate warm {ms:.3f} ms "
                f"an image (median of {EVAL_PASSES} passes: "
                f"{[round(x, 1) for x in passes]}) on {smi}")
            out[preset] = dict(eval_ms=ms, launches=launches)
            del im
        store = {}
        with capture_dcn(store):
            run_cli(eval_cli.main, [CITYSCAPES, "--data-root", cs,
                                    "--max-images", "1", "--checkpoint",
                                    ckpt[CITYSCAPES]], "check",
                    phase="presets")
        held_eval = hold_captured(store, "presets", k1=6,
                                  shapes=[("K1", CS_EVAL_MAP)])

    tr = drawn_trainer(CITYSCAPES, seed=0)
    b, hw = tr.cfg.data.batch_size, tuple(tr.cfg.data.crop_size)
    check((b, hw) == (2, (512, 1024)), f"Cityscapes batch {b} at {hw}")
    rng = np.random.default_rng(8)
    batches = [synthetic_batch(rng, b, hw, num_classes=19, classes=(5, 15))
               for _ in range(CS_WARMUP + CS_TIMED)]
    res = timed_steps(tr, batches, CS_WARMUP, "cityscapes")
    store = {}
    batch = [torch.as_tensor(a, device="cuda") for a in batches[-1]]
    with f32_precision():
        busy = device_busy_ms(lambda: tr.step_fn(tr.state, *batch))
        with capture_dcn(store):
            tr.step_fn(tr.state, *batch)
    held_train = hold_captured(store, "presets", k1=6, k2=6, shapes=[
        ("K1", CS_TRAIN_MAP), ("K2", CS_TRAIN_MAP)])
    log("presets", f"{CITYSCAPES} train: batch {b} at {hw}: median step_ms="
        f"{res['step_ms']:.3f} (max {res['max_ms']:.3f}, n={res['n']}) "
        f"device_busy_ms={busy:.3f} peak_mem_gib={res['peak_gib']:.3f} "
        f"total {res['first']['total']:.6g} on {smi}")
    del tr
    torch.cuda.empty_cache()
    shapes = sorted(held_eval["shapes"] | held_train["shapes"])
    times = {}
    for kernel, shape in shapes:
        n, h, w = shape[:3]
        timing = k1_timing if kernel == "K1" else k2_timing
        times[kernel, (n, h, w)] = timing(n, h, w, gen, tag="presets")
    out.update(train=dict(res, busy_ms=busy), times=times,
               k1_err=max(held_eval["k1"], held_train["k1"]),
               k2_err=held_train["k2"])
    return out


# --- the micro-batching ServingEngine, the SDTv3 family, the tools ----------

SERVE_SHAPES = ((512, 683), (683, 512), (512, 512), (384, 512))
SERVE_REQUESTS, SERVE_THREADS = 64, 4
SERVE_TOL = 1e-3      # a request's logits in a micro-batch against alone
SERVE_AGREEMENT = 0.99  # a request's class map in its micro-batch vs alone
EXPORT_TOL = 1e-6     # the exported program's logits against eager
V3_PRESETS = {"sdtv3": "SDTv3_b_Spike2former_ade20k_512x512",
              "sdtv3mae": "SDTv3MAE_Spike2former_ade20k_512x512"}
V3_STEPS = 3


def serve_images() -> list:
    rng = np.random.default_rng(13)
    return [rng.integers(0, 256, (*SERVE_SHAPES[i % len(SERVE_SHAPES)], 3),
                         dtype=np.uint8) for i in range(SERVE_REQUESTS)]


def run_engine(eng, imgs, threads: int) -> tuple[list, float]:
    """Submit ``imgs`` from ``threads`` threads at once (each its share,
    then waits on its futures), or one at a time after the last one's
    result with ``threads=0``; returns every request's class map (or the
    exception its future holds) and the wall seconds."""
    out = [None] * len(imgs)

    def client(k):
        futs = [(i, eng.submit(imgs[i]))
                for i in range(k, len(imgs), threads)]
        for i, f in futs:
            try:
                out[i] = f.result(timeout=300)
            except Exception as e:  # noqa: BLE001 — checked by the caller
                out[i] = e

    t = time.perf_counter()
    if threads:
        workers = [threading.Thread(target=client, args=(k,))
                   for k in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(600)
    else:
        for i, img in enumerate(imgs):
            try:
                out[i] = eng.submit(img).result(timeout=300)
            except Exception as e:  # noqa: BLE001
                out[i] = e
    return out, time.perf_counter() - t


def check_futures(preds, imgs, tag: str) -> None:
    bad = [(i, p) for i, p in enumerate(preds)
           if not isinstance(p, np.ndarray)]
    check(not bad, f"{tag}: {len(bad)} futures hold no class map, e.g. "
          f"{bad[:3]}")
    for p, img in zip(preds, imgs):
        check(p.shape == img.shape[:2] and p.dtype == np.int32,
              f"{tag}: map {p.shape} {p.dtype} for {img.shape}")


@contextlib.contextmanager
def hold_batches(store: dict):
    """Inside the block, each of the engine's forwards is followed by
    each of its requests alone (N=1, the same bucket-padded image and
    ``valid_hw``); the largest logit difference and the batch sizes go
    to ``store``, and the last forward's batch, logits and requests' alone
    logits to its keys ``batch``, ``logits`` and ``alone`` (``hold_maps``
    takes them)."""
    real = serving.whole_logits

    def wrapped(model, batch, valid_hw=None):
        logits = real(model, batch, valid_hw=valid_hw)
        store.setdefault("sizes", []).append(len(batch))
        alones = []
        for i in range(len(batch)):
            alone = real(model, batch[i:i + 1], valid_hw=valid_hw[i:i + 1])
            err = (logits[i] - alone[0]).abs().max().item()
            store["err"] = max(store.get("err", 0.0), err)
            alones.append(alone)
        store.update(batch=batch, logits=logits, alone=alones)
        return logits

    serving.whole_logits = wrapped
    try:
        yield store
    finally:
        serving.whole_logits = real


def post_logits(logits: torch.Tensor, pad_shape: tuple[int, int],
                ori_shape: tuple[int, int]) -> torch.Tensor:
    """``postprocess_pred`` without its argmax: [1, H, W, C] logits
    cropped to ``pad_shape`` and resized to ``ori_shape`` -> [h, w, C]."""
    logits = logits[:, :pad_shape[0], :pad_shape[1]]
    if tuple(logits.shape[1:3]) != tuple(ori_shape):
        logits = resize_bilinear(logits, tuple(ori_shape))
    return logits[0]


@contextlib.contextmanager
def hold_maps(store: dict, batches: dict):
    """Inside the block and ``hold_batches(batches)``, after each of the engine's
    forwards the class map that each request's future holds is held, and
    the least share of each over the requests goes to ``store``:

    * ``inputs``: its row of the batch is its own bucket-padded image;
    * ``own``: pixels where the map is the argmax of that row's logits,
      cropped and resized (``post_logits``);
    * ``strict``: pixels where it equals the map of the request alone;
    * ``ties``: pixels where it equals that map, or where the alone
      logits of the two classes lie within twice the largest difference
      between the request's logits in its micro-batch and alone: a tie
      that this difference may decide either way.

    A failure of the holding itself goes to ``store['errors']``."""
    real = ServingEngine._process

    def wrapped(self, reqs):
        real(self, reqs)
        try:
            batch, logits, alone = (batches.pop(k)
                                    for k in ("batch", "logits", "alone"))
            with f32_precision(), torch.inference_mode():
                for i, r in enumerate(reqs):
                    got = torch.from_numpy(r.future.result(timeout=0)).to(
                        logits.device).long()
                    mine = post_logits(logits[i:i + 1], r.img_shape,
                                       r.ori_shape)
                    ref = post_logits(alone[i], r.img_shape, r.ori_shape)
                    best = ref.argmax(-1)
                    gap = (ref.gather(-1, best[..., None])
                           - ref.gather(-1, got[..., None]))[..., 0]
                    slack = 2 * (mine - ref).abs().max()
                    shares = dict(
                        inputs=float(np.array_equal(batch[i].cpu().numpy(),
                                                    r.image)),
                        own=(got == mine.argmax(-1)).float().mean().item(),
                        strict=(got == best).float().mean().item(),
                        ties=(gap <= slack).float().mean().item())
                    for k, v in shares.items():
                        store[k] = min(store.get(k, 1.0), v)
                    store["n"] = store.get("n", 0) + 1
        except Exception as e:  # noqa: BLE001 — checked by the caller
            store.setdefault("errors", []).append(repr(e))

    ServingEngine._process = wrapped
    try:
        yield store
    finally:
        ServingEngine._process = real


def phase_serving(im, gen, smi: str) -> dict:
    """(serving): the flagship through ``ServingEngine(max_batch=16,
    bucket=128)``: 64 requests of four ADE-like shapes from 4 threads at
    once, the same one at a time, and a loop of ``inference_model``."""
    imgs = serve_images()
    with ServingEngine(model=im, max_batch=16, bucket=128) as eng:
        run_engine(eng, imgs[:8], SERVE_THREADS)         # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    with ServingEngine(model=im, max_batch=16, bucket=128) as eng:
        preds, wall = run_engine(eng, imgs, SERVE_THREADS)
        st = eng.stats()
    torch.cuda.synchronize()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check_futures(preds, imgs, "serving")
    forwards = sum(st["batch_sizes"].values())
    check(launches["k1"] == 6 * forwards,
          f"serving: {launches['k1']} K1 launches for {forwards} "
          f"micro-batches, expected 6 each")
    check(st["requests"] == len(imgs), f"serving: stats {st}")
    log("serving", f"{len(imgs)} requests from {SERVE_THREADS} threads: "
        f"{len(imgs) / wall:.3f} img/s, p50 {st['p50_ms']:.3f} ms, p99 "
        f"{st['p99_ms']:.3f} ms, micro-batches {st['batch_sizes']} "
        f"(size: count), K1 launches {launches['k1']} ({forwards} "
        f"micro-batches), peak {peak:.3f} GiB on {smi}")

    # the same traffic held: each request against itself alone, its class
    # map against its logits, and every K1 call against its plain version
    # at each N it was handed
    store, held, maps = {}, {}, {}
    with hold_batches(held), hold_maps(maps, held), capture_dcn(store), \
            ServingEngine(model=im, max_batch=16, bucket=128) as eng:
        checked, _ = run_engine(eng, imgs, SERVE_THREADS)
    check_futures(checked, imgs, "serving (held)")
    check(not maps.get("errors") and maps.get("n") == len(imgs),
          f"serving: {maps.get('n')} maps held, errors "
          f"{maps.get('errors', [])[:3]}")
    check(maps["inputs"] == 1.0, "serving: a micro-batch row is not its "
          "request's image")
    check(maps["own"] >= SERVE_AGREEMENT, f"serving: a future's class map "
          f"is the argmax of its logits in {maps['own']:.4f} < "
          f"{SERVE_AGREEMENT}")
    check(maps["ties"] >= SERVE_AGREEMENT, f"serving: class maps in "
          f"micro-batches vs alone agree (up to ties) in "
          f"{maps['ties']:.4f} < {SERVE_AGREEMENT}")
    sizes = sorted(set(held["sizes"]))
    k1 = hold_captured(store, "serving", k1=6 * (len(held["sizes"])
                                                  + len(imgs)))
    check(held["err"] <= SERVE_TOL, f"serving: a request in its "
          f"micro-batch vs alone {held['err']:.3g} > {SERVE_TOL}")
    log("serving", f"each request in its micro-batch vs alone (N=1, same "
        f"valid_hw): max|diff| {held['err']:.3g} (tol {SERVE_TOL}); least "
        f"class agreement {maps['strict']:.6f}, up to ties "
        f"{maps['ties']:.6f} (tol {SERVE_AGREEMENT}); each future's map "
        f"the argmax of its own logits in {maps['own']:.6f}; K1 held at N "
        f"in {sizes} (max|diff| {k1['k1']:.3g})")

    zero_launches()
    with ServingEngine(model=im, max_batch=16, bucket=128) as eng:
        seq, seq_wall = run_engine(eng, imgs, 0)
        seq_st = eng.stats()
    seq_launches = read_launches()
    check_futures(seq, imgs, "serving (one at a time)")
    zero_launches()
    t = time.perf_counter()
    loop = [api.inference_model(im, img) for img in imgs]
    torch.cuda.synchronize()
    loop_wall = time.perf_counter() - t
    loop_launches = read_launches()
    # the micro-batched maps against the same requests served alone (one
    # at a time: N=1, the same bucket and valid_hw), reported only: the
    # random weights' class scores are flat (the top two of a pixel lie
    # ~1e-6 apart, less than a micro-batch moves the logits), so one
    # request's map may flip whole with the batch the threads' timing
    # made; the held run above gates this agreement up to such ties
    agree = min(float((a == b).mean()) for a, b in zip(preds, seq))
    # inference_model pads to 32 without valid_hw: another input, and the
    # random weights' logits are flat, so this share is reported only
    loop_agree = float(np.mean([(a == b).mean() for a, b in zip(preds,
                                                                 loop)]))
    log("serving", f"one at a time: {len(imgs) / seq_wall:.3f} img/s, p50 "
        f"{seq_st['p50_ms']:.3f} ms, p99 {seq_st['p99_ms']:.3f} ms; "
        f"inference_model loop {len(imgs) / loop_wall:.3f} img/s; engine "
        f"(4 threads) / loop {loop_wall / wall:.3f}x; least class "
        f"agreement micro-batched vs alone {agree:.6f} (reported only; "
        f"the held run gates it up to ties); mean agreement with the "
        f"loop's pad-32 maps "
        f"{loop_agree:.4f} on {smi}")

    # K1 at the largest micro-batch on the 512x768 bucket's /16 map
    n_max, h, w = max(sizes), 32, 48
    t_k1 = k1_timing(n_max, h, w, gen, tag="serving")
    return dict(launches=launches, seq_launches=seq_launches,
                loop_launches=loop_launches, img_s=len(imgs) / wall,
                seq_img_s=len(imgs) / seq_wall, loop_img_s=len(imgs)
                / loop_wall, p50=st["p50_ms"], p99=st["p99_ms"],
                sizes=st["batch_sizes"], peak_gib=peak, agree=agree,
                maps=maps, err=held["err"], held=k1,
                k1_max=(n_max, h, w, t_k1))


def phase_v3(variant: str, gen, smi: str) -> dict:
    """(sdtv3) / (sdtv3mae): the preset at full width: 3 requests, 3 train
    steps at batch 6 of 512x512, the tiny model card vs CPU, a
    reference-format state dict loaded strictly onto the card."""
    preset = V3_PRESETS[variant]
    tag = variant
    t = time.perf_counter()
    im = drawn_model(preset, seed=0)
    check((im.cfg.model.variant, im.cfg.model.T, im.cfg.model.collapse_t)
          == (variant, 4, True), f"{tag}: {im.cfg.model}")
    log(tag, f"{preset} built at full width in "
        f"{time.perf_counter() - t:.1f}s")
    rng = np.random.default_rng(5)
    imgs = [rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
            for hw in REQUEST_SHAPES]
    api.inference_model(im, imgs[0])
    torch.cuda.synchronize()
    zero_launches()
    preds = [api.inference_model(im, img) for img in imgs]
    torch.cuda.synchronize()
    req_launches = read_launches()
    check(req_launches["k1"] == 6 * len(imgs),
          f"{tag}: {req_launches['k1']} K1 launches for 3 requests")
    for p, img in zip(preds, imgs):
        check(p.shape == img.shape[:2] and 0 <= p.min()
              and p.max() < im.num_classes, f"{tag}: bad map {p.shape}")
    store = {}
    with capture_dcn(store):
        for img in imgs:
            api.inference_model(im, img)
    held = hold_captured(store, tag, k1=18)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(5):
        for img in imgs:
            torch.cuda.synchronize()
            t = time.perf_counter()
            api.inference_model(im, img)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
    req_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    padded, _ = api.resize_and_pad(im.cfg, imgs[0])
    x = torch.from_numpy(padded[None]).cuda()
    with f32_precision():
        req_busy = device_busy_ms(lambda: whole_logits(im.model, x))
    log(tag, f"request: median {statistics.median(times):.3f} ms (max "
        f"{max(times):.3f}, n={len(times)}), device {req_busy:.3f} ms, "
        f"peak {req_peak:.3f} GiB, K1 {req_launches['k1']} launches over "
        f"3 requests on {smi}")
    del im
    torch.cuda.empty_cache()

    tr = drawn_trainer(preset, seed=0)
    b, hw = tr.cfg.data.batch_size, tuple(tr.cfg.data.crop_size)
    check((b, hw) == (6, (512, 512)), f"{tag}: trains at {b} x {hw}")
    batches = [synthetic_batch(np.random.default_rng(7), b, hw)
               for _ in range(1 + V3_STEPS)]
    steps = timed_steps(tr, batches, 1, tag)
    store = {}
    with capture_dcn(store):
        api.train_steps(tr, batches[:1])
    held_train = hold_captured(store, tag, k1=6, k2=6)
    batch = [torch.as_tensor(a, device="cuda") for a in batches[-1]]
    with f32_precision():
        step_busy = device_busy_ms(lambda: tr.step_fn(tr.state, *batch),
                                   cpu=False)
    log(tag, f"train: median step {steps['step_ms']:.3f} ms (max "
        f"{steps['max_ms']:.3f}, n={steps['n']}), device {step_busy:.3f} "
        f"ms, peak {steps['peak_gib']:.3f} GiB, first total "
        f"{steps['first']['total']:.6g} on {smi}")
    del tr
    torch.cuda.empty_cache()

    tiny = dict(TINY, variant=variant)
    cpu = randomize_(Spike2Former(T=4, **tiny), seed=1).eval()
    gpu = copy.deepcopy(cpu).cuda()
    xs = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (1, 64, 64, 3)).astype(np.float32))
    with torch.inference_mode(), f32_precision():
        want = cpu.predict_logits(xs)
        got = gpu.predict_logits(xs.cuda()).cpu()
    tiny_err = (got - want).abs().max().item()
    check(torch.allclose(got, want, atol=MODEL_TOL, rtol=MODEL_TOL),
          f"{tag}: tiny model card vs CPU {tiny_err:.3g}")

    depths = {k: GOLDEN[k] for k in ("depths_stage3", "depths_stage4",
                                      "num_encoder_layers",
                                      "num_decoder_layers")}
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "golden.pth")
        torch.save({"state_dict": golden_state_dict(variant=variant)}, path)
        sd = load_reference_model(path, variant=variant, **depths)
    ref_cpu = Spike2Former(T=1, compat=True, variant=variant, **GOLDEN)
    ref_cpu.load_state_dict(sd, strict=True)
    ref_gpu = Spike2Former(T=1, compat=True, variant=variant, **GOLDEN)
    ref_gpu.cuda().load_state_dict(sd, strict=True)
    with torch.inference_mode(), f32_precision():
        want = ref_cpu.eval().predict_logits(xs)
        got = ref_gpu.eval().predict_logits(xs.cuda()).cpu()
    ref_err = (got - want).abs().max().item()
    check(torch.allclose(got, want, atol=MODEL_TOL, rtol=MODEL_TOL),
          f"{tag}: reference state dict card vs CPU {ref_err:.3g}")
    log(tag, f"tiny model card vs CPU max|diff| {tiny_err:.3g}; "
        f"reference-format state dict loaded strictly on the card, "
        f"logits vs CPU {ref_err:.3g} (tol {MODEL_TOL})")
    return dict(req_launches=req_launches, launches=steps["launches"],
                req_ms=statistics.median(times), req_busy=req_busy,
                req_peak=req_peak, step_ms=steps["step_ms"],
                step_busy=step_busy, step_peak=steps["peak_gib"],
                held=dict(k1=max(held["k1"], held_train["k1"]),
                          k2=held_train["k2"]),
                tiny_err=tiny_err, ref_err=ref_err)


def phase_tools(im, smi: str) -> dict:
    """(tools): the benchmark CLI (inference and train, ``--mfu``), the
    export of the flagship at batch 1, and ``ServingEngine.close()`` with
    requests queued."""
    kind = torch.cuda.get_device_name(0)
    out = {}
    for train, argv in ((False, ["--num-iters", "10", "--warmup", "2"]),
                        (True, ["--train", "--batch-size", "6",
                                "--num-iters", "3", "--warmup", "2"])):
        args = benchmark._parser().parse_args(
            [PRESET, "--dtype", "float32", "--mfu"] + argv)
        r = benchmark.run(args)
        line = benchmark.format_line(r)
        log("tools", f"benchmark: {line}")
        check(np.isfinite(r["flops"]) and r["flops"] > 0
              and 0 < r["mfu"] < 1, f"benchmark: {line}")
        check(r["peak_tflops"] == peak_tflops(kind, "float32")
              and r["smi"] == smi, f"benchmark: peak {r['peak_tflops']} "
              f"on {r['smi']}")
        out["bench_train" if train else "bench_infer"] = r

    x = preprocess(torch.from_numpy(np.random.default_rng(9).integers(
        0, 256, (1, 512, 512, 3), dtype=np.uint8)).cuda())
    t = time.perf_counter()
    program = export.export_model(im.model, x)
    export_s = time.perf_counter() - t
    calls = export.sampler_calls(program)
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "flagship.pt2")
        torch.export.save(program, path)
        mb = os.path.getsize(path) / 1e6
        save_s = time.perf_counter() - t
        t = time.perf_counter()
        loaded = torch.export.load(path).module()
        load_s = time.perf_counter() - t
    zero_launches()
    t = time.perf_counter()
    with torch.no_grad(), f32_precision():
        got = loaded(x)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t
        export_launches = read_launches()
        want = im.model.predict_logits(x)
    err = (got - want).abs().max().item()
    check(calls == 6 and export_launches["k1"] == 6,
          f"export: {calls} calls of the K1 operator in the graph, "
          f"{export_launches['k1']} launches in a run")
    check(err <= EXPORT_TOL, f"export: logits vs eager {err:.3g} > "
          f"{EXPORT_TOL}")
    log("tools", f"export: traced in {export_s:.1f}s, saved in "
        f"{save_s:.1f}s, loaded in {load_s:.1f}s, run in {run_s:.1f}s, "
        f"{mb:.1f} MB, "
        f"{calls} calls of spike2former::dcnv3_sample, loaded back: logits "
        f"vs eager max|diff| {err:.3g} (tol {EXPORT_TOL})")

    imgs = serve_images()[:8]
    eng = ServingEngine(model=im, max_batch=1, bucket=128)
    futs = [eng.submit(img) for img in imgs]
    eng.close()
    done = [f.exception(timeout=60) for f in futs]
    failed = sum(isinstance(e, RuntimeError) and "closed" in str(e)
                 for e in done)
    check(all(f.done() for f in futs) and failed >= 1
          and failed + done.count(None) == len(futs),
          f"close(): {failed} of {len(futs)} queued requests failed, "
          f"others {done}")
    log("tools", f"ServingEngine.close() with {len(futs)} requests "
        f"queued: {failed} failed with 'engine closed', "
        f"{done.count(None)} served")
    return dict(out, export_err=err, export_launches=export_launches)


# --- COCO panoptic, the Mask2Former head, the DAB-DETR decoder --------------

PANOPTIC = "SDTv2_maskformer_coco_panoptic"
PAN_TRAIN_SHAPES = COCO_LIKE_SHAPES + ((480, 640),)
PAN_ITERS = 3                 # the panoptic train CLI's iterations
PAN_TINY_THR = 0.5            # object_mask_thr of the tiny card-vs-CPU run
PAN_AGREEMENT = 0.99          # share of equal sem / inst pixels, card-CPU
VARIANTS = {"m2f": ["model.masked_attention=True"],
            "dab": ["model.decoder='dab'"]}
VARIANT_STEPS = 3             # a warm-up and two timed steps, each
VARIANT_PASSES = 3            # timed passes over the 3 requests


def confident_tiny_model() -> Spike2Former:
    """The tiny panoptic model of tests/test_torch_panoptic.py on weights
    drawn by ``engine/weights.py`` with its three changes (query features
    at std 2, the class kernel x8, the last mask-embedding kernel x32), so
    that the merge keeps queries; on the CPU, in eval mode."""
    m = randomize_(Spike2Former(T=1, **dict(TINY, num_classes=4,
                                            num_queries=8,
                                            num_decoder_layers=2)), seed=14)
    with torch.no_grad():
        m.head.query_feat.normal_(0.0, 2.0,
                                  generator=torch.Generator().manual_seed(114))
        m.head.cls_embed.weight.mul_(8.0)
        m.head.mask_embed.Dense_2.weight.mul_(32.0)
    return m.eval()


def phase_panoptic(smi: str) -> dict:
    """(panoptic): the eval CLI's panoptic branch and the panoptic train
    CLI on the preset at full width, on a seeded COCO-panoptic tree;
    ``whole_panoptic`` and the merge on the card against the CPU."""
    tag = "panoptic"
    out = {}
    with tempfile.TemporaryDirectory() as root:
        write_coco_panoptic_tree(root, COCO_LIKE_SHAPES, seed=0, split="val")
        write_coco_panoptic_tree(root, PAN_TRAIN_SHAPES, seed=1,
                                 split="train")
        for split in ("val", "train"):
            ds = PanopticDataset(root, split)
            segs = [ds.load(i)["segments"] for i in range(len(ds))]
            crowd = sum(c for sg in segs for _, _, c in sg)
            things = sum(lab < ds.num_things for sg in segs
                         for _, lab, c in sg if not c)
            stuff = sum(lab >= ds.num_things for sg in segs
                        for _, lab, _ in sg)
            void = [float((ds.load(i)["pan_ids"] == 0).mean())
                    for i in range(len(ds))]
            check(things and stuff and crowd and min(void) > 0,
                  f"{tag}: {split} tree has {things} things, {stuff} stuff, "
                  f"{crowd} crowds, void shares {void}")
            log(tag, f"{split}: {len(ds)} images "
                f"{[ds.load(i)['image'].shape[:2] for i in range(len(ds))]},"
                f" {things} thing, {stuff} stuff and {crowd} crowd segments,"
                f" {ds.num_things}+{ds.num_stuff} classes")

        t = time.perf_counter()
        im = drawn_model(PANOPTIC, seed=0)
        m = im.cfg.model
        check((m.num_classes, m.num_things, im.cfg.data.dataset)
              == (133, 80, "coco_panoptic"), f"{tag}: preset {m}")
        log(tag, f"{PANOPTIC} built at full width in "
            f"{time.perf_counter() - t:.1f}s")
        val = PanopticDataset(root, "val")
        eval_cli.evaluate_panoptic(im, val, max_images=1)   # warm-up
        times = []
        for _ in range(EVAL_PASSES):
            torch.cuda.synchronize()
            zero_launches()
            t = time.perf_counter()
            res = eval_cli.evaluate_panoptic(im, val)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3 / res["images"])
            launches = read_launches()
        check(res["images"] == 3 and launches["k1"] == 6 * 3
              and launches["grouped"] == (0, 0),
              f"{tag}: eval {res['images']} images, launches {launches}")
        for (sem, inst), i in zip(res["maps"], range(3)):
            shape = val.load(i)["image"].shape[:2]
            check(sem.shape == inst.shape == shape and sem.min() >= -1
                  and sem.max() < 133, f"{tag}: map {sem.shape} vs {shape}")
        # the device's share: whole_panoptic alone on the padded images
        xs = [torch.from_numpy(test_pipeline(
            {"image": val.load(i)["image"], "meta": {}},
            im.cfg.data.test_scale, size_divisor=im.cfg.data.size_divisor,
            bucket=im.cfg.test.bucket)["image"][None]).cuda()
            for i in range(3)]
        fwd = []
        for _ in range(EVAL_PASSES):
            for x in xs:
                torch.cuda.synchronize()
                t = time.perf_counter()
                whole_panoptic(im.model, x, num_things=80)
                torch.cuda.synchronize()
                fwd.append((time.perf_counter() - t) * 1e3)
        busy = device_busy_ms(lambda: whole_panoptic(im.model, xs[0],
                                                     num_things=80))
        out.update(eval_launches=launches, eval_ms=statistics.median(times),
                   fwd_ms=statistics.median(fwd), fwd_busy=busy)
        log(tag, f"evaluate_panoptic: {statistics.median(times):.3f} ms an "
            f"image (median of {EVAL_PASSES} passes over 3, "
            f"{[round(x, 3) for x in times]}), of which whole_panoptic "
            f"{statistics.median(fwd):.3f} ms (n={len(fwd)}; device "
            f"{busy:.3f} ms on {tuple(xs[0].shape[1:3])}), K1 "
            f"{launches['k1']} launches for 3 images, PQ {res['PQ']:.2f} on "
            f"{smi}")
        lines = run_cli(eval_cli.main, [PANOPTIC, "--data-root", root],
                        "eval CLI", phase=tag)
        check(lines[0] == "images: 3" and lines[1].startswith("PQ ")
              and "PQ_th" in lines[1] and "PQ_st" in lines[1],
              f"{tag}: eval CLI printed {lines}")
        del im
        torch.cuda.empty_cache()

        # whole_panoptic and the merge, card against CPU
        cpu = confident_tiny_model()
        gpu = copy.deepcopy(cpu).cuda()
        x = torch.from_numpy(np.random.default_rng(6).integers(
            0, 256, (2, 96, 128, 3), dtype=np.uint8))
        want = whole_panoptic(cpu, x, num_things=2,
                              object_mask_thr=PAN_TINY_THR)
        got = [t.cpu() for t in whole_panoptic(
            gpu, x.cuda(), num_things=2, object_mask_thr=PAN_TINY_THR)]
        agree = [(g == w).float().mean().item() for g, w in zip(got, want)]
        kept = (want[0] >= 0).float().mean().item()
        check(min(agree) >= PAN_AGREEMENT and kept > 0,
              f"{tag}: whole_panoptic card vs CPU agreement {agree}, "
              f"kept share {kept}")
        cls, masks = (torch.from_numpy(a) for a in confident_merge_inputs(
            hw=(96, 128)))
        want_m = panoptic_inference(cls, masks, num_things=2)
        got_m = [t.cpu() for t in panoptic_inference(
            cls.cuda(), masks.cuda(), num_things=2)]
        sem = want_m[0]
        check(all(torch.equal(g, w) for g, w in zip(got_m, want_m))
              and (sem == -1).any() and (sem >= 2).any()
              and (want_m[1] > 0).any(),
              f"{tag}: the merge on the card differs from its plain CPU run"
              f" or is trivial")
        out.update(agree=agree, kept=kept)
        log(tag, f"whole_panoptic (tiny, object_mask_thr {PAN_TINY_THR}) "
            f"card vs CPU: sem equal on {agree[0]:.6f}, inst on "
            f"{agree[1]:.6f} of pixels (>= {PAN_AGREEMENT}), kept share "
            f"{kept:.4f}, classes {sorted(set(want[0].unique().tolist()))}; "
            f"the merge on confident inputs equals its plain CPU run "
            f"(void {(sem == -1).float().mean().item():.3f}, "
            f"{len(want_m[1].unique()) - 1} instance ids)")

        # the train CLI at full width
        tr_cfg = get_config(PANOPTIC)
        batches = iter(train_cli.panoptic_train_batches(
            PanopticDataset(root, "train"), tr_cfg.data.batch_size,
            tr_cfg.data.crop_size, tr_cfg.train.max_gt,
            seed=tr_cfg.train.seed))
        t = time.perf_counter()
        batch = next(batches)
        host_s = time.perf_counter() - t
        copies = {}
        for name, arr in (("masks f32", batch[2]),
                          ("masks u8", batch[2].astype(np.uint8)),
                          ("images f32", batch[0])):
            ms = []
            for _ in range(3):
                torch.cuda.synchronize()
                t = time.perf_counter()
                train_cli._to_device(arr, torch.device("cuda"))
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t) * 1e3)
            copies[name] = (min(ms), arr.nbytes / 1e6)
        log(tag, f"a host batch of {tuple(batch[2].shape)} masks in "
            f"{host_s:.3f} s; H2D (pinned, ms, MB): "
            + ", ".join(f"{k} {v[0]:.2f} ({v[1]:.1f})"
                        for k, v in copies.items()))
        # the step alone on that batch (masks as the CLI sends them)
        tr = drawn_trainer(PANOPTIC, seed=0)
        u8 = (batch[0], batch[1], batch[2].astype(np.uint8), batch[3])
        steps = timed_steps(tr, [u8] * 3, 1, tag)
        out.update(step_ms=steps["step_ms"], step_peak=steps["peak_gib"],
                   step_launches=steps["launches"])
        log(tag, f"step from memory: {steps['step_ms']:.3f} ms (n="
            f"{steps['n']}), peak {steps['peak_gib']:.3f} GiB on {smi}")
        del tr
        torch.cuda.empty_cache()
        wd = os.path.join(root, "wd")
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        t = time.perf_counter()
        lines = run_cli(train_cli.main, [
            PANOPTIC, "--data-root", root, "--work-dir", wd,
            "--log-interval", "1", "--cfg-options",
            f"train.total_iters={PAN_ITERS}", "train.checkpoint_interval=0"],
            "train CLI", phase=tag)
        cli_s = time.perf_counter() - t
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        recs = read_scalars(os.path.join(wd, "scalars.jsonl"))
        check(launches["k1"] == 6 * PAN_ITERS
              and launches["k2"] == 6 * PAN_ITERS
              and len(recs) == PAN_ITERS
              and all(np.isfinite(r["total"]) for r in recs)
              and sorted(os.listdir(wd)) == [f"ckpt_{PAN_ITERS}",
                                             "scalars.jsonl"]
              and not any("val" in ln for ln in lines),
              f"{tag}: train CLI launches {launches}, records {recs}, "
              f"files {sorted(os.listdir(wd))}")
        out.update(cli_launches=launches, cli_peak=peak, cli_s=cli_s,
                   sec_per_iter=[r["sec_per_iter"] for r in recs],
                   copies=copies, host_s=host_s)
        log(tag, f"train CLI: {PAN_ITERS} iterations in {cli_s:.1f} s, "
            f"s/iter {[round(r['sec_per_iter'], 3) for r in recs]}, "
            f"totals {[round(r['total'], 4) for r in recs]}, K1/K2 "
            f"{launches['k1']}/{launches['k2']} launches, peak {peak:.3f} "
            f"GiB on {smi}")
    return out


def request_images(seed: int = 5) -> list:
    """Seeded uint8 images of the three request shapes."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
            for hw in REQUEST_SHAPES]


def phase_variant(name: str, smi: str) -> dict:
    """(m2f) / (dab): the flagship with ``VARIANTS[name]`` at full width
    beside the flagship itself, the two taking turns: ``VARIANT_PASSES``
    passes over three requests (K1 held at each DCN call of one more
    request of the variant) and ``VARIANT_STEPS`` train steps each at
    batch 6 of 512x512, the first a warm-up (K1 and K2 held at one more
    step of the variant)."""
    opts = VARIANTS[name]
    t = time.perf_counter()
    ims = {"flagship": drawn_model(PRESET, seed=0),
           name: drawn_model(PRESET, overrides=opts, seed=0)}
    head = ims[name].model.head
    check(head.masked_attention if name == "m2f" else head.decoder == "dab",
          f"{name}: head {head.masked_attention}, {head.decoder}")
    log(name, f"{PRESET} {opts} and the flagship built at full width in "
        f"{time.perf_counter() - t:.1f}s")
    imgs = request_images()
    for im in ims.values():
        for img in imgs:
            api.inference_model(im, img)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    api.inference_model(ims[name], imgs[0])
    req_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    zero_launches()
    times = {k: [] for k in ims}
    for _ in range(VARIANT_PASSES):
        for img in imgs:
            for k, im in ims.items():
                torch.cuda.synchronize()
                t = time.perf_counter()
                p = api.inference_model(im, img)
                torch.cuda.synchronize()
                times[k].append((time.perf_counter() - t) * 1e3)
                check(p.shape == img.shape[:2] and 0 <= p.min()
                      and p.max() < im.num_classes,
                      f"{name}: bad map {p.shape}")
    req_launches = read_launches()
    n_req = sum(len(v) for v in times.values())
    check(req_launches["k1"] == 6 * n_req,
          f"{name}: {req_launches['k1']} K1 launches for {n_req} requests")
    store = {}
    with capture_dcn(store):
        api.inference_model(ims[name], imgs[0])
    held = hold_captured(store, name, k1=6)
    req = {k: statistics.median(v) for k, v in times.items()}
    log(name, f"request, taking turns with the flagship (n="
        f"{len(times[name])} each): median {req[name]:.3f} ms "
        f"({[round(x, 1) for x in times[name]]}) against the flagship's "
        f"{req['flagship']:.3f} ({[round(x, 1) for x in times['flagship']]})"
        f", peak {req_peak:.3f} GiB, K1 {req_launches['k1']} launches over "
        f"{n_req} requests on {smi}")
    del ims
    torch.cuda.empty_cache()

    trs = {"flagship": drawn_trainer(PRESET, seed=0),
           name: drawn_trainer(PRESET, opts, seed=0)}
    b, hw = trs[name].cfg.data.batch_size, tuple(trs[name].cfg.data.crop_size)
    batches = [synthetic_batch(np.random.default_rng(7), b, hw)
               for _ in range(VARIANT_STEPS)]
    zero_launches()
    steps, peaks = {k: [] for k in trs}, {}
    for i, batch in enumerate(batches):
        for k, tr in trs.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            m = api.train_steps(tr, [batch])[0]
            torch.cuda.synchronize()
            steps[k].append((time.perf_counter() - t) * 1e3)
            peaks[k] = torch.cuda.max_memory_allocated() / 2 ** 30
            bad = [key for key, v in m.items() if not np.isfinite(v)]
            check(not bad, f"{name}: {k} step {i} non-finite {bad}")
    launches = read_launches()
    n_steps = sum(len(v) for v in steps.values())
    check(launches["k1"] == 6 * n_steps and launches["k2"] == 6 * n_steps,
          f"{name}: K1/K2 launches {launches} over {n_steps} steps")
    step = {k: statistics.median(v[1:]) for k, v in steps.items()}
    batch = [torch.as_tensor(a, device="cuda") for a in batches[-1]]
    with f32_precision():
        busy = device_busy_ms(lambda: trs[name].step_fn(trs[name].state,
                                                        *batch), cpu=False)
    store = {}
    with capture_dcn(store):
        api.train_steps(trs[name], batches[-1:])
    held_train = hold_captured(store, name, k1=6, k2=6)
    log(name, f"train, taking turns with the flagship: step "
        f"{step[name]:.3f} ms ({[round(x, 1) for x in steps[name]]}, the "
        f"first a warm-up; device {busy:.3f} ms) against the flagship's "
        f"{step['flagship']:.3f} ({[round(x, 1) for x in steps['flagship']]}"
        f"), peak {peaks[name]:.3f} GiB against {peaks['flagship']:.3f} on "
        f"{smi}")
    del trs
    torch.cuda.empty_cache()
    return dict(req_launches=req_launches, launches=launches,
                req_ms=req[name], flag_req_ms=req["flagship"],
                req_peak=req_peak, step_ms=step[name],
                flag_step_ms=step["flagship"], step_peak=peaks[name],
                flag_step_peak=peaks["flagship"], step_busy=busy,
                held=dict(k1=max(held["k1"], held_train["k1"]),
                          k2=held_train["k2"]))


# --- the FPN family (FPN and cascade segmentors, MS-ResNet) -----------------

FPN_PRESET = "fpn_sdtv3_512x512_19M_ade20k"
FPN_FAMILY = ("fpn_msresnet104_512x512_ade20k",
              "cascade_fpn_sdtv2_512x512_ade20k")
FPN_REQUESTS = 10             # timed requests after a warm-up pass
FPN_WARMUP, FPN_TIMED = 2, 3  # the 19M preset's steps
FPN_AGREEMENT = 0.99          # tiny model, card against CPU: class share
FPN_CLI_ITERS = (2, 3)        # the train CLI's run, then its --resume
# the FPN family at tiny widths, for the card-against-CPU checks
TINY_FPN = ["model.num_classes=5", "model.embed_dim=(8,16,24,32)",
            "model.backbone_heads=4", "model.depths_stage3=1",
            "model.depths_stage4=1", "model.neck_channels=16",
            "model.head_channels=8", "model.T=2"]


def timed_requests(im, imgs, n: int) -> list:
    """Wall ms of ``n`` requests over ``imgs`` in turn, each a class map
    of its image's shape."""
    times = []
    for i in range(n):
        img = imgs[i % len(imgs)]
        torch.cuda.synchronize()
        t = time.perf_counter()
        p = api.inference_model(im, img)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        check(p.shape == img.shape[:2] and 0 <= p.min()
              and p.max() < im.num_classes, f"bad map {p.shape}")
    return times


def fpn_steps(name: str, warmup: int, timed: int, tag: str) -> dict:
    """``warmup`` + ``timed`` steps of preset ``name`` at full width at its
    batch (halved while a step runs out of device memory) of seeded
    512x512 batches: median step ms, peak GiB, the last metrics, the
    neck's and the head's largest gradients."""
    b = get_config(name).data.batch_size
    while True:
        tr = drawn_trainer(name, [f"data.batch_size={b}"], seed=0)
        rng = np.random.default_rng(7)
        batches = [synthetic_batch(rng, b, (512, 512))
                   for _ in range(warmup + timed)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, metrics = [], []
        try:
            for batch in batches:
                torch.cuda.synchronize()
                t = time.perf_counter()
                metrics.append(api.train_steps(tr, [batch])[0])
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
            break
        except torch.cuda.OutOfMemoryError:
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            log(tag, f"{name} at batch {b} ran out of device memory (peak "
                f"{peak:.3f} GiB before the failing allocation); halving")
            check(b > 1, f"{name}: batch 1 does not fit")
            del tr, batches
            torch.cuda.empty_cache()
            b //= 2
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for m in metrics:
        bad = [k for k, v in m.items() if not np.isfinite(v)]
        check(not bad, f"{name}: non-finite {bad}")
    model = tr.state.model
    heads = ([model.head.Conv_0] if hasattr(model, "head") else
             [getattr(model, f"stage{i}") for i in range(model.num_stages)])
    grads = dict(neck=max(float(p.grad.abs().max())
                          for p in model.neck.parameters()),
                 head=min(max(float(p.grad.abs().max())
                              for p in h.parameters()) for h in heads))
    check(grads["neck"] > 0 and grads["head"] > 0,
          f"{name}: silent gradients {grads}")
    out = dict(batch=b, step_ms=statistics.median(times[warmup:]),
               times=times, peak_gib=peak, metrics=metrics[-1], grads=grads)
    del tr, model
    torch.cuda.empty_cache()
    return out


def tiny_fpn_card_vs_cpu() -> dict:
    """The 19M preset at tiny widths, the same seeded weights on the CPU
    and the card: logits of two 64x64 images (class agreement, largest
    gap) and 3 train steps' ``total`` with the same dropout masks (the
    steps' own: JAX's keys, the kernel on the card)."""
    ims = {dev: drawn_model(FPN_PRESET, overrides=TINY_FPN, device=dev,
                            seed=1) for dev in ("cpu", "cuda")}
    x = torch.from_numpy(np.random.default_rng(2).normal(
        0, 1, (2, 64, 64, 3)).astype(np.float32))
    logits = {}
    for dev, im in ims.items():
        with torch.inference_mode(), f32_precision():
            logits[dev] = im.model.predict_logits(x.to(dev)).cpu()
    agree, gap = compare_logits(logits["cuda"], logits["cpu"])
    # the steps' own dropout on both devices: JAX's masks of each step, by
    # the plain threefry on the CPU and the kernel on the card
    rng = np.random.default_rng(3)
    batches = [synthetic_batch(rng, 2, (64, 64), num_classes=5)
               for _ in range(3)]
    totals = {}
    for dev in ("cpu", "cuda"):
        tr = drawn_trainer(FPN_PRESET, TINY_FPN + [
            "train.warmup_iters=1"], device=dev, seed=1)
        totals[dev] = [m["total"] for m in api.train_steps(tr, batches)]
    rel = max(abs(a - b) / abs(b) for a, b in zip(totals["cuda"],
                                                  totals["cpu"]))
    check(agree >= FPN_AGREEMENT, f"tiny FPN class agreement {agree}")
    check(rel <= TRAIN_RTOL, f"tiny FPN train card vs CPU rel {rel:.3g}")
    return dict(agree=agree, gap=gap, totals=totals, rel=rel)


def phase_fpn(smi: str) -> dict:
    """(fpn): the 19M FPN preset at full width serves the three request
    images through ``api.inference_model``: a warm-up pass, then
    ``FPN_REQUESTS`` timed requests with the launch counts set to 0 just
    before them (K1 and K2 must read 0: the FPN family runs no DCN), peak
    memory; the tiny model card against CPU."""
    t = time.perf_counter()
    im = drawn_model(FPN_PRESET, seed=0)
    log("fpn", f"{FPN_PRESET} built at full width in "
        f"{time.perf_counter() - t:.1f}s")
    imgs = request_images()
    timed_requests(im, imgs, len(imgs))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    times = timed_requests(im, imgs, FPN_REQUESTS)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(launches["k1"] == launches["k2"] == 0,
          f"fpn: K1/K2 launched on the FPN path: {launches}")
    log("fpn", f"request median {statistics.median(times):.3f} ms, max "
        f"{max(times):.3f} (n={len(times)}: {[round(x, 1) for x in times]})"
        f", peak {peak:.3f} GiB, K1/K2 launches {launches['k1']}/"
        f"{launches['k2']} on {smi}")
    del im
    torch.cuda.empty_cache()
    tiny = tiny_fpn_card_vs_cpu()
    log("fpn", f"tiny model card vs CPU: class agreement "
        f"{tiny['agree']:.6f}, largest logit gap {tiny['gap']:.3g}; 3 train "
        f"steps' total CPU {tiny['totals']['cpu']} card "
        f"{tiny['totals']['cuda']} (max rel {tiny['rel']:.3g}, tol "
        f"{TRAIN_RTOL})")
    return dict(req_ms=statistics.median(times), req_max=max(times),
                req_peak=peak, launches=launches, tiny=tiny)


def phase_fpn_train(smi: str) -> dict:
    """(fpn train): the 19M preset at its own defaults (batch 6 of 512x512,
    T=4 over every step, the backbone's BN trained) takes ``FPN_WARMUP``
    + ``FPN_TIMED`` steps, the launch counts set to 0 just before them."""
    zero_launches()
    r = fpn_steps(FPN_PRESET, FPN_WARMUP, FPN_TIMED, "fpn train")
    r["launches"] = read_launches()
    check(r["launches"]["k1"] == r["launches"]["k2"] == 0,
          f"fpn train: K1/K2 launched: {r['launches']}")
    log("fpn train", f"batch {r['batch']} of 512x512: step median "
        f"{r['step_ms']:.3f} ms ({[round(x, 1) for x in r['times']]}, the "
        f"first {FPN_WARMUP} warm-ups), peak {r['peak_gib']:.3f} GiB; "
        f"losses {r['metrics']}; largest gradient neck "
        f"{r['grads']['neck']:.3g}, head {r['grads']['head']:.3g}; K1/K2 "
        f"launches {r['launches']['k1']}/{r['launches']['k2']} on {smi}")
    return r


def phase_fpn_family(smi: str) -> dict:
    """(fpn family): one request (after a warm-up one) and one step (after
    a warm-up step) at full width for MS-ResNet-104 and the cascade, the
    cascade's per-stage losses printed; the eval CLI in whole and slide
    mode on (eval)'s seeded tree and 3 train CLI iterations, a checkpoint
    and a ``--resume``, with the 19M preset.  Every path's launch counts
    are set to 0 just before it and must read 0."""
    out = {"launches": []}
    imgs = request_images()
    for name in FPN_FAMILY:
        im = drawn_model(name, seed=0)
        timed_requests(im, imgs[:1], 1)
        zero_launches()
        req = timed_requests(im, imgs[1:2], 1)[0]
        out["launches"].append(read_launches())
        del im
        torch.cuda.empty_cache()
        zero_launches()
        r = fpn_steps(name, 1, 1, "fpn family")
        out["launches"].append(read_launches())
        stages = {k: round(v, 4) for k, v in r["metrics"].items()
                  if k.startswith("decode_")}
        log("fpn family", f"{name}: request {req:.3f} ms; batch "
            f"{r['batch']} step {r['step_ms']:.3f} ms, peak "
            f"{r['peak_gib']:.3f} GiB, total {r['metrics']['total']:.4f}"
            + (f", per stage {stages}" if stages else "") + f" on {smi}")
        out[name] = dict(req_ms=req, **r)
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "ade")
        write_ade_tree(root, REQUEST_SHAPES, seed=0)
        write_ade_tree(root, ADE_LIKE_SHAPES[:6], seed=3, split="training")
        for mode in ("whole", "slide"):
            opts = (["test.mode='slide'"] if mode == "slide" else [])
            torch.cuda.synchronize()
            zero_launches()
            t = time.perf_counter()
            run_cli(eval_cli.main, [FPN_PRESET, "--data-root", root,
                                    "--cfg-options", *opts],
                    f"eval {mode}", "fpn family")
            torch.cuda.synchronize()
            out["launches"].append(read_launches())
            log("fpn family", f"eval CLI {mode}: "
                f"{(time.perf_counter() - t) * 1e3 / len(REQUEST_SHAPES):.1f}"
                f" ms an image (the build included)")
        wd = os.path.join(tmp, "wd")
        for iters, extra in zip(FPN_CLI_ITERS, ([], ["--resume"])):
            zero_launches()
            t = time.perf_counter()
            lines = run_cli(train_cli.main, [
                FPN_PRESET, "--data-root", root, "--work-dir", wd,
                "--log-interval", "1", "--eval-images", "1", *extra,
                "--cfg-options", "train.checkpoint_interval=2",
                "train.val_interval=2", "data.num_workers=4",
                f"train.total_iters={iters}"], f"train {iters}", "fpn family")
            out["launches"].append(read_launches())
            check(any(f"iter {iters}/{iters} loss" in ln for ln in lines),
                  f"train CLI: no log of iteration {iters}")
            log("fpn family", f"train CLI to {iters}: "
                f"{time.perf_counter() - t:.1f} s (the build included)")
        check(any("resumed from" in ln for ln in lines), "no --resume")
        files = sorted(os.listdir(wd))
        check(files == ["best", "ckpt_2", "ckpt_3", "scalars.jsonl"],
              f"train CLI files {files}")
    for n in out["launches"]:
        check(n["k1"] == n["k2"] == 0, f"fpn family: K1/K2 launched: {n}")
    return out


FPN_BF16_ROUNDS = 3           # turns of the three requests per dtype
FPN_BF16_STEPS = 2            # timed steps per dtype, after a warm-up each


def phase_fpn_bf16(smi: str) -> dict:
    """(fpn bf16): the 19M FPN preset at ``model.dtype=bfloat16`` beside
    the f32 preset with the same seeded weights, at full width: the three
    request images in turns (f32, bf16, ``FPN_BF16_ROUNDS`` times after a
    warm-up of each), request ms and peak memory of each, the class
    agreement and largest logit gap of bf16 against f32; then a warm-up
    and ``FPN_BF16_STEPS`` train steps at batch 6 of 512x512 of each, in
    turns, step ms and peak memory.  The launch counts are set to 0 just
    before the bf16 requests and before the bf16 steps (K1 and K2 must
    read 0: no DCN).  At tiny widths the bf16 model on the card against
    the CPU: class agreement >= ``BF16_AGREEMENT``, logit gap <=
    ``BF16_LOGIT_GAP``."""
    ims = {dt: drawn_model(FPN_PRESET, overrides=opts, seed=0)
           for dt, opts in (("f32", []), ("bf16", BF16_OPTS))}
    imgs = request_images()
    for im in ims.values():
        timed_requests(im, imgs, len(imgs))
    times = {dt: [] for dt in ims}
    peaks = {dt: 0.0 for dt in ims}
    for _ in range(FPN_BF16_ROUNDS):
        for dt, im in ims.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_launches()
            times[dt] += timed_requests(im, imgs, len(imgs))
            req_launches = read_launches()
            check(req_launches["k1"] == req_launches["k2"] == 0,
                  f"fpn bf16: K1/K2 launched: {req_launches}")
            peaks[dt] = max(peaks[dt],
                            torch.cuda.max_memory_allocated() / 2 ** 30)
    x = preprocess(torch.from_numpy(imgs[2][None]).cuda())
    with torch.inference_mode(), f32_precision():
        logits = {dt: im.model.predict_logits(x).float().cpu()
                  for dt, im in ims.items()}
    agree, gap = compare_logits(logits["bf16"], logits["f32"])
    check(all(torch.isfinite(v).all() for v in logits.values()),
          "fpn bf16: non-finite logits")
    log("fpn bf16", f"requests in turns: f32 median "
        f"{statistics.median(times['f32']):.3f} ms (peak "
        f"{peaks['f32']:.3f} GiB), bf16 median "
        f"{statistics.median(times['bf16']):.3f} ms (peak "
        f"{peaks['bf16']:.3f} GiB), n={len(times['bf16'])} each; bf16 vs "
        f"f32 logits of a 512x512 image: class agreement {agree:.6f}, "
        f"largest gap {gap:.6g}; K1/K2 launches {req_launches['k1']}/"
        f"{req_launches['k2']} on {smi}")
    del ims
    torch.cuda.empty_cache()

    rng = np.random.default_rng(7)
    batches = [synthetic_batch(rng, 6, (512, 512))
               for _ in range(1 + FPN_BF16_STEPS)]
    trs = {dt: drawn_trainer(FPN_PRESET, opts, seed=0)
           for dt, opts in (("f32", []), ("bf16", BF16_OPTS))}
    step_ms = {dt: [] for dt in trs}
    step_peak = {dt: 0.0 for dt in trs}
    step_launches = {}
    metrics = {}
    for i, batch in enumerate(batches):
        for dt, tr in trs.items():
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_launches()
            t = time.perf_counter()
            metrics[dt] = api.train_steps(tr, [batch])[0]
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            if dt == "bf16":
                step_launches = read_launches()
            step_peak[dt] = max(step_peak[dt],
                                torch.cuda.max_memory_allocated() / 2 ** 30)
            if i:
                step_ms[dt].append(ms)
    for dt, m in metrics.items():
        bad = [k for k, v in m.items() if not np.isfinite(v)]
        check(not bad, f"fpn bf16: {dt} step non-finite {bad}")
    model = trs["bf16"].state.model
    check(all(p.dtype == torch.float32 for p in model.parameters()),
          "fpn bf16: parameters left float32")
    head = max(float(p.grad.abs().max()) for p in model.head.parameters())
    check(head > 0, "fpn bf16: the head's gradients are 0")
    del trs, model
    torch.cuda.empty_cache()
    check(step_launches["k1"] == step_launches["k2"] == 0,
          f"fpn bf16: K1/K2 launched: {step_launches}")
    log("fpn bf16", f"batch 6 of 512x512 in turns: f32 step "
        f"{[round(v, 1) for v in step_ms['f32']]} ms (peak "
        f"{step_peak['f32']:.3f} GiB), bf16 step "
        f"{[round(v, 1) for v in step_ms['bf16']]} ms (peak "
        f"{step_peak['bf16']:.3f} GiB); last total f32 "
        f"{metrics['f32']['total']:.4f}, bf16 {metrics['bf16']['total']:.4f}"
        f"; K1/K2 launches {step_launches['k1']}/{step_launches['k2']} on "
        f"{smi}")

    opts = TINY_FPN + BF16_OPTS
    cpu = drawn_model(FPN_PRESET, overrides=opts, device="cpu", seed=1)
    gpu = drawn_model(FPN_PRESET, overrides=opts, seed=1)
    x = torch.from_numpy(np.random.default_rng(2).normal(
        0, 1, (2, 64, 64, 3)).astype(np.float32))
    with torch.inference_mode(), f32_precision():
        t_agree, t_gap = compare_logits(
            gpu.model.predict_logits(x.cuda()).float().cpu(),
            cpu.model.predict_logits(x).float())
    log("fpn bf16", f"tiny model at bf16, 64x64 card vs CPU: class "
        f"agreement {t_agree:.6f}, largest logit gap {t_gap:.6g}")
    check(t_agree >= BF16_AGREEMENT and t_gap <= BF16_LOGIT_GAP,
          f"fpn bf16 tiny card vs CPU: agreement {t_agree}, gap {t_gap}")
    return dict(req_ms={dt: statistics.median(v) for dt, v in times.items()},
                req_peak=peaks, step_ms={dt: statistics.median(v)
                                         for dt, v in step_ms.items()},
                step_peak=step_peak, agree=agree, gap=gap,
                launches=[req_launches, step_launches])


DDD17_PRESET_OPTS = ["data.dataset='ddd17'", "model.num_classes=6"]
DDD17_VAL, DDD17_TRAIN = 3, 6   # frames in the seeded tree's two splits


def phase_ddd17(smi: str) -> dict:
    """(ddd17): the flagship preset with ``data.dataset=ddd17
    model.num_classes=6`` on a seeded DDD17 tree (``write_ddd17_tree``:
    raw events voxelized by the port's ``events`` converter into 2-channel
    uint8 frames of 200x352 as ``.npy``, 6-class maps): the eval CLI whole
    on the val frames (K1 6 launches a frame), then the train CLI for 2
    iterations at the preset's batch 6 (K1 and K2 6 an iteration, K1 6
    more for the val frame of the val at iteration 2).  Each path's launch
    counts are set to 0 just before it."""
    out = {"launches": []}
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "ddd17")
        t = time.perf_counter()
        write_ddd17_tree(root, DDD17_VAL, seed=0)
        write_ddd17_tree(root, DDD17_TRAIN, seed=1, split="training")
        frame = np.load(os.path.join(root, "images", "validation",
                                     "rec_0.npy"))
        check(frame.shape == (200, 352, 2) and frame.dtype == np.uint8,
              f"ddd17 frame {frame.shape} {frame.dtype}")
        log("ddd17", f"seeded tree of {DDD17_VAL} + {DDD17_TRAIN} event "
            f"frames {frame.shape} {frame.dtype} written in "
            f"{time.perf_counter() - t:.1f}s (mean count "
            f"{frame.mean():.3f})")
        torch.cuda.synchronize()
        zero_launches()
        t = time.perf_counter()
        lines = run_cli(eval_cli.main, [PRESET, "--data-root", root,
                                        "--cfg-options",
                                        *DDD17_PRESET_OPTS], "eval", "ddd17")
        torch.cuda.synchronize()
        n = read_launches()
        out["launches"].append(n)
        check(any(f"images: {DDD17_VAL}" in ln for ln in lines)
              and any("mIoU" in ln for ln in lines),
              "ddd17: the eval CLI printed no mIoU")
        check(n["k1"] == 6 * DDD17_VAL and n["k2"] == 0,
              f"ddd17 eval: launches {n}")
        log("ddd17", f"eval CLI: {time.perf_counter() - t:.1f} s for "
            f"{DDD17_VAL} frames (the build included); K1 launches "
            f"{n['k1']}")
        zero_launches()
        t = time.perf_counter()
        wd = os.path.join(tmp, "wd")
        lines = run_cli(train_cli.main, [
            PRESET, "--data-root", root, "--work-dir", wd, "--log-interval",
            "1", "--eval-images", "1", "--cfg-options", *DDD17_PRESET_OPTS,
            "train.checkpoint_interval=2", "train.val_interval=2",
            "data.num_workers=4", "train.total_iters=2"], "train", "ddd17")
        torch.cuda.synchronize()
        n = read_launches()
        out["launches"].append(n)
        check(any("iter 2/2 loss" in ln for ln in lines),
              "ddd17: no log of iteration 2")
        check(os.path.exists(os.path.join(wd, "ckpt_2")),
              "ddd17: no checkpoint")
        check(n["k2"] == 6 * 2 and n["k1"] == 6 * 2 + 6,
              f"ddd17 train: launches {n}")
        log("ddd17", f"train CLI 2 iterations: "
            f"{time.perf_counter() - t:.1f} s (the build included); K1/K2 "
            f"launches {n['k1']}/{n['k2']} on {smi}")
    return out


# the flagship head's widths and the levels it sees of a 512x512 image
DEFORM_SHAPES = ((64, 64), (32, 32), (16, 16))   # /8, /16, /32
DECODER_LEVELS = ((256, 32), (128, 64), (64, 128), (32, 360))  # /2-/16
DEFORM_TOL, DEFORM_SHARE = 1e-3, 0.99   # card vs CPU: elements within


def card_vs_cpu(module: torch.nn.Module, args: list, tag: str) -> dict:
    """``module`` in inference mode on the CPU and on the card on the same
    ``args`` (tensors, or lists of them): the share of output elements
    within ``DEFORM_TOL`` (>= ``DEFORM_SHARE``), the largest gap, and the
    card's warm ms."""
    def to(a, dev):
        return ([x.to(dev) for x in a] if isinstance(a, list)
                else a.to(dev) if torch.is_tensor(a) else a)

    def flat(out):
        if torch.is_tensor(out):
            return [out]
        return [t for o in out for t in flat(o)]

    module = module.eval()
    with torch.inference_mode(), f32_precision():
        want = flat(module(*args))
        module.cuda()
        gpu_args = [to(a, "cuda") for a in args]
        got = flat(module(*gpu_args))
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: module(*gpu_args), iters=5, warmup=1)
    module.cpu()
    share = min(float(((g.cpu() - w).abs() <= DEFORM_TOL).float().mean())
                for g, w in zip(got, want))
    gap = max(float((g.cpu() - w).abs().max()) for g, w in zip(got, want))
    scale = max(float(w.abs().max()) for w in want)
    check(all(bool(torch.isfinite(g).all()) for g in got),
          f"deformable: {tag} non-finite on the card")
    check(share >= DEFORM_SHARE, f"deformable: {tag} card vs CPU: only "
          f"{share:.6f} of the elements within {DEFORM_TOL}")
    return dict(share=share, gap=gap, scale=scale, ms=ms)


def phase_deformable(smi: str) -> dict:
    """(deformable): at the flagship head's widths (feat 256, 8 heads, FFN
    1024, 6 layers, seeded weights), the deformable encoder over the /8,
    /16 and /32 maps of a 512x512 image (5376 tokens, 4 points), and the
    Transformer-encoder and FPN pixel decoders over the four levels the
    head sees ((32, 64, 128, 360) channels at /2 to /16), on the card
    against the CPU on the same inputs: the share of elements within
    ``DEFORM_TOL`` and the largest gap of every output, the card's ms."""
    from spike2former_tpu_torch.models.deformable import (
        SpikeDeformableEncoder)
    from spike2former_tpu_torch.models.pixel_decoder import (
        FPNPixelDecoder, TransformerEncoderPixelDecoder)

    gen = torch.Generator().manual_seed(11)
    n_tok = sum(h * w for h, w in DEFORM_SHAPES)
    tokens = torch.randn((1, 1, n_tok, 256), generator=gen) + 0.5
    pos = torch.randn((1, 1, n_tok, 256), generator=gen)
    feats = [torch.randn((1, 1, s, s, c), generator=gen) + 0.4
             for s, c in DECODER_LEVELS]
    chans = tuple(c for _, c in DECODER_LEVELS)
    out = {}
    for tag, module, args in (
            ("deformable encoder", SpikeDeformableEncoder(
                6, 256, 8, 4, 1024, num_levels=len(DEFORM_SHAPES)),
             [tokens, DEFORM_SHAPES, pos]),
            ("transformer pixel decoder", TransformerEncoderPixelDecoder(
                chans, 256, 256, 6, 8, 1024), [feats]),
            ("fpn pixel decoder", FPNPixelDecoder(chans, 256, 256),
             [feats])):
        randomize_(module, 3)
        r = card_vs_cpu(module, args, tag)
        out[tag] = r
        log("deformable", f"{tag}: card vs CPU {r['share']:.6f} of the "
            f"elements within {DEFORM_TOL}, largest gap {r['gap']:.3g} "
            f"(largest |output| {r['scale']:.3g}); card {r['ms']:.3f} ms on "
            f"{smi}")
    return out


# --- slice fifteen: data-parallel training and the library modules ----------

DDP_ITERS = 3          # (distributed a): the one-rank NCCL train CLI
DDP_STEPS = 2          # (distributed b): steps of each comparison
DDP_RTOL = 2e-4        # each metric, two ranks against one process (tiny)
DDP_FP_RTOL = 2e-5     # the parameters' fingerprint (tiny)
DDP_TIMEOUT = 600      # seconds, for each rank's process
# (distributed b)'s configurations: (overrides, crop, synthetic_batch's
# keywords).  The tiny model (the host matcher; 4 queries, so at most 4
# classes a crop) is held to the one-process step; at the flagship's
# widths one element of the 128x128 step's million-element spike maps
# lands within a last-bit BN rounding of a q8 step and flips, and the
# flip moves the losses by up to a few percent (seen at half the widths
# on the CPU: inputs 1e-6 apart, one flipped element of 1M in the pixel
# decoder's ``output_spike_2``, ``tests/torch_ddp_divergence.py``), so
# there the ranks are held to each other and the gap to one process is
# reported
DDP_CONFIGS = {
    "tiny": ([f"model.{k}={v!r}".replace(" ", "") for k, v in TINY.items()]
             + ["train.matcher='host'"], 64,
             dict(num_classes=4, classes=(2, 4))),
    "flagship": ([], 128, {}),
}


def ddp_worker(argv: list[str]) -> int:
    """One rank of (distributed b), started as ``chip_smoke.py
    --ddp-worker COORD PID NPROC OUT CONFIG``: joins a gloo group of
    ``NPROC`` ranks on the one card, takes ``DDP_STEPS`` steps of
    ``DDP_CONFIGS[CONFIG]`` on its rows of the global batches and saves
    its metrics, K1/K2 launches and final state to ``OUT``."""
    coord, pid, nproc, out, config = argv
    pid, pcount = parallel.distributed_init(coord, int(nproc), int(pid),
                                            backend="gloo")
    try:
        res = ddp_steps(pid, pcount, config)
        torch.save(res, out)
    finally:
        parallel.shutdown()
    return 0


def ddp_steps(pid: int, pcount: int, config: str) -> dict:
    """``DDP_STEPS`` steps of the flagship preset with the overrides of
    ``DDP_CONFIGS[config]`` (weights from seed 0) on rank ``pid``'s rows
    of global batches of 2 at its crop."""
    overrides, crop, synth = DDP_CONFIGS[config]
    tr = drawn_trainer(PRESET, overrides, seed=0)
    rng = np.random.default_rng(7)
    batches = [parallel.shard_batch(
        synthetic_batch(rng, 2, (crop, crop), **synth), pid, pcount)
        for _ in range(DDP_STEPS)]
    torch.cuda.synchronize()
    zero_launches()
    metrics, ms = [], []
    for batch in batches:
        t = time.perf_counter()
        metrics += api.train_steps(tr, [batch])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    return dict(metrics=metrics, launches=read_launches(), step_ms=ms,
                dcn_layers=tr.cfg.model.num_encoder_layers,
                state={k: v.detach().cpu()
                       for k, v in tr.state.model.state_dict().items()})


def phase_distributed(smi: str) -> dict:
    """(distributed): (a) the train CLI with ``--distributed
    --num-processes 1`` (NCCL, one rank) at full width, batch 6 of 512x512,
    ``DDP_ITERS`` iterations from the tests' draw (a ``ckpt_0`` of
    ``drawn_trainer``'s state, ``--resume``d: the CLI takes no weights),
    every K1/K2 call held to its plain version; (b) two gloo ranks on the one card, one row each of global batches of
    2, against this process taking the whole batches, for each of
    ``DDP_CONFIGS`` (``ddp_compare``)."""
    t0 = time.perf_counter()
    # NCCL itself: one rank's all-reduce on the card
    parallel.distributed_init(None, 1, 0, backend="nccl")
    x = torch.arange(4.0, device="cuda")
    torch.distributed.all_reduce(x)
    check(x.tolist() == [0.0, 1.0, 2.0, 3.0], f"NCCL all-reduce {x}")
    parallel.shutdown()
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "ade")
        write_ade_tree(root, ADE_LIKE_SHAPES, seed=3, split="training")
        wd = os.path.join(tmp, "wd")
        os.makedirs(wd)
        checkpoint.save_state(wd, drawn_trainer(PRESET, device="cpu").state,
                              0, wait=True)
        store: dict = {}
        torch.cuda.synchronize()
        zero_launches()
        t = time.perf_counter()
        with capture_dcn(store):
            lines = run_cli(train_cli.main, [
                PRESET, "--data-root", root, "--work-dir", wd,
                "--log-interval", "1", "--eval-images", "0", "--resume",
                "--distributed", "--num-processes", "1", "--cfg-options",
                f"train.total_iters={DDP_ITERS}",
                "train.checkpoint_interval=0", "train.val_interval=0"],
                "nccl", phase="distributed")
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t
        nccl_launches = read_launches()
        check(lines[0] == "distributed: process 0/1, 1 global devices",
              f"first line {lines[0]!r}")
        check(not torch.distributed.is_initialized(),
              "the CLI left its process group")
        recs = [r for r in read_scalars(os.path.join(wd, "scalars.jsonl"))
                if "total" in r]
        check([r["step"] for r in recs] == list(range(1, DDP_ITERS + 1))
              and all(np.isfinite(r["total"]) for r in recs),
              f"logged {[(r['step'], r['total']) for r in recs]}")
        check(nccl_launches["k1"] == 6 * DDP_ITERS
              and nccl_launches["k2"] == 6 * DDP_ITERS,
              f"one-rank CLI K1/K2 launches {nccl_launches['k1']}/"
              f"{nccl_launches['k2']} for {DDP_ITERS} iterations")
        held = hold_captured(store, "distributed", k1=6 * DDP_ITERS,
                             k2=6 * DDP_ITERS)
        del store
        step_ms = [r["sec_per_iter"] * 1e3 for r in recs]
        log("distributed", f"(a) one NCCL rank, train CLI at full width, "
            f"batch 6 of 512x512: {cli_s:.1f}s for {DDP_ITERS} iterations, "
            f"s/iter {[round(s, 1) for s in step_ms]} ms, K1/K2 launches "
            f"{nccl_launches['k1']}/{nccl_launches['k2']} on {smi}")

        gloo = {config: ddp_compare(config, tmp, smi)
                for config in DDP_CONFIGS}
    log("distributed", f"the phase took {time.perf_counter() - t0:.1f}s")
    return dict(launches=[nccl_launches] + [
                    n for g in gloo.values() for n in g["launches"]],
                held=held, cli_step_ms=step_ms, gloo=gloo)


def fmt_ms(times: list[float]) -> str:
    return ", ".join(f"{t:.1f}" for t in times)


def ddp_compare(tag: str, tmp: str, smi: str) -> dict:
    """Two gloo ranks on the one card (this script as ``--ddp-worker``)
    against this process on the whole global batches, for the
    configuration ``tag`` of ``DDP_CONFIGS``: the ranks' metrics and
    parameters bitwise equal and finite, K1/K2 one launch a DCN layer and
    step on each;
    for the tiny model every metric within ``DDP_RTOL`` and the
    parameters' fingerprint within ``DDP_FP_RTOL`` of the one-process
    step."""
    coord = f"localhost:{parallel.free_port()}"
    outs = [os.path.join(tmp, f"{tag}{i}.pt") for i in (0, 1)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--ddp-worker",
         coord, str(i), "2", outs[i], tag], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i in (0, 1)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=DDP_TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            p.kill()
            logs.append(p.communicate()[0])
    for i, (p, out) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"gloo rank {i} failed:\n{out[-3000:]}")
    # after the ranks, so that the timings do not share the card
    single = ddp_steps(0, 1, tag)
    ranks = [torch.load(o, weights_only=False) for o in outs]
    worst, gaps = 0.0, []
    for s, (want, got) in enumerate(zip(single["metrics"],
                                        ranks[0]["metrics"])):
        check(set(got) == set(want), f"metric keys {sorted(got)}")
        for k, w in want.items():
            check(bool(np.isfinite(got[k])), f"step {s} {k}: {got[k]}")
            rel = abs(got[k] - w) / max(abs(w), 1e-6)
            if abs(got[k] - w) > 1e-6:
                worst = max(worst, rel)
                gaps.append(f"step {s} {k} {got[k]:.7g}/{w:.7g}")
    log("distributed", f"(b, {tag}) two ranks against one process: "
        f"{'; '.join(gaps[:12]) or 'every metric equal'}")

    check(ranks[0]["metrics"] == ranks[1]["metrics"],
          f"{tag}: the ranks' metrics differ")
    same = all(torch.equal(v, ranks[1]["state"][k])
               for k, v in ranks[0]["state"].items())
    check(same, f"{tag}: the ranks' parameters differ")

    def fingerprint(state):
        return sum(float(v.double().abs().sum()) for v in state.values())

    fp_rel = abs(fingerprint(ranks[0]["state"])
                 - fingerprint(single["state"])) / fingerprint(
                     single["state"])
    if tag == "tiny":
        check(worst <= DDP_RTOL and fp_rel <= DDP_FP_RTOL,
              f"{tag}: two ranks against one process: metrics {worst:.3g} "
              f"(tol {DDP_RTOL}), fingerprint {fp_rel:.3g} (tol "
              f"{DDP_FP_RTOL})")
    for r in ranks + [single]:
        n = r["dcn_layers"] * DDP_STEPS   # K1 and K2 once a DCN layer
        check(r["launches"]["k1"] == n and r["launches"]["k2"] == n,
              f"{tag}: K1/K2 launches {r['launches']}, expected {n} each")
    crop = DDP_CONFIGS[tag][1]
    log("distributed", f"(b, {tag}) two gloo ranks on one card, batch 1 "
        f"each at {crop}x{crop}, against one process at batch 2: "
        f"largest metric rel diff {worst:.3g}, parameter fingerprint rel "
        f"diff {fp_rel:.3g}, ranks bitwise equal {same}; step ms (first, "
        f"second) two ranks {fmt_ms(ranks[0]['step_ms'])} / "
        f"{fmt_ms(ranks[1]['step_ms'])}, one process "
        f"{fmt_ms(single['step_ms'])} on {smi}")
    return dict(launches=[single["launches"],
                          *(r["launches"] for r in ranks)],
                worst=worst, fp_rel=fp_rel,
                step_ms=[r["step_ms"] for r in ranks],
                single_step_ms=single["step_ms"])


# --- slice sixteen: tensor parallelism and row-sharded inference -----------

PAR_TIMEOUT = 900        # seconds, for each rank's process
TP_TINY_RTOL = 2e-4      # tiny widths, TP against one process (JAX's bound)
SP_TINY_TOL = 2e-5       # tiny widths, row bands against one process (JAX's)
# full width: at least FULL_AGREE of the logits within FULL_TOL of one
# process, and of the pixels' classes equal (one flipped q8 level moves a
# full-width model by percents: tests/torch_ddp_divergence.py)
FULL_TOL, FULL_AGREE = 1e-3, 0.99
K1_ROW_MAPS = ((32, 32), (64, 128))   # the ADE and Cityscapes /16 maps
FLAGSHIP_HW = (512, 512)
TP_STEP_HW = (128, 128)


def k1_row_bytes(value, py, out_elems: int) -> int:
    """The bytes K1 must move for output pixels whose taps are ``py``: the
    value rows those taps touch (this run's data), read once; the
    coordinates and mask; the output, written once."""
    h = value.shape[1]
    y0 = torch.floor(py)
    rows = torch.cat([y0, y0 + 1]).long().flatten()
    touched = int(torch.unique(rows[(rows >= 0) & (rows < h)]).numel())
    per_row = value[0, 0].numel() * value.element_size()
    return (touched * per_row * value.shape[0] + 3 * 4 * py.numel()
            + out_elems * value.element_size())


def k1_rows_timing(value, py, px, mask, rows, tag: str) -> dict:
    """K1's time on one row band's output pixels of the whole map
    ``value`` (``rows`` = (row0, out_rows), or None for the whole map's
    launch), warm and cold L2, beside the plain version, the
    ``F.grid_sample`` yardstick on the same inputs and the bounds."""
    n, h, w, c = value.shape
    g, p = py.shape[2], py.shape[3]
    out_elems = n * py.shape[1] * c
    flops = n * py.shape[1] * g * p * (4 * (c // g) * 2 + 16)
    kw = {} if rows is None else dict(rows=rows)
    # the yardstick on bf16 takes its coordinates in bf16, as (bf16
    # kernels) times it
    lib = [value] + [t.to(value.dtype) for t in (py, px, mask)]

    def k1():
        return dcnv3.dcnv3_sample(value, py, px, mask, **kw)

    plan = dcnv3.tile_plan(n, h, w, py.shape[1], g, c // g, p,
                           backward=False,
                           out_rows=None if rows is None else rows[1])
    t = dict(ms=median_ms(k1, reps=3), cold_ms=cuda_ms(k1, cold=True),
             plain_ms=cuda_ms(lambda: dcnv3.dcnv3_sample_reference(
                 value, py, px, mask), iters=10),
             library_ms=cuda_ms(lambda: grid_sample_yardstick(*lib),
                                iters=20),
             bytes_ms=k1_row_bytes(value, py, out_elems)
             / HBM_BYTES_PER_S * 1e3,
             ops_ms=flops / F32_FLOPS_PER_S * 1e3, plan=plan)
    log("k1 rows", f"{tag}: plan {plan}, kernel_ms={t['ms']:.5f} "
        f"cold_l2_ms={t['cold_ms']:.5f} plain_ms={t['plain_ms']:.5f} "
        f"library_ms={t['library_ms']:.5f} "
        f"byte_bound_us={t['bytes_ms'] * 1e3:.3f} "
        f"op_bound_us={t['ops_ms'] * 1e3:.3f}")
    return t


def phase_k1_rows(gen) -> dict:
    """(k1 rows): K1 in f32 and bf16 with a first output row, as row-
    sharded inference hands it the whole /16 map and one band's output
    rows: on each half of the ADE 32x32 and the Cityscapes 64x128 map
    (banded: no group's map fits a block) for every kind of coordinates,
    against the plain version (2e-5 in f32, one bf16 ulp in bf16) and
    bitwise against that slice of the whole map's launch; then each
    half's time beside the whole map's on 'random' coordinates."""
    g, cg, p = 32, 8, 9
    worst = worst_bf16 = 0.0
    times = {}
    for h, w in K1_ROW_MAPS:
        half = h // 2
        for kind in KINDS:
            value, py, px, mask = sampler_inputs(1, h, w, g, cg, p, kind,
                                                 gen)
            for dt in (torch.float32, torch.bfloat16):
                v = value.to(dt)
                whole = dcnv3.dcnv3_sample(v, py, px, mask)
                for row0 in (0, half):
                    sl = slice(row0 * w, (row0 + half) * w)
                    args = [t[:, sl].contiguous() for t in (py, px, mask)]
                    got = dcnv3.dcnv3_sample(v, *args, rows=(row0, half))
                    torch.cuda.synchronize()
                    want = dcnv3.dcnv3_sample_reference(v, *args)
                    err = (got.float() - want.float()).abs().max().item()
                    check(bool(torch.isfinite(got).all()),
                          f"k1 rows: non-finite out ({kind}, {h}x{w})")
                    if dt == torch.float32:
                        check(err <= KERNEL_TOL, f"k1 rows: {err:.3g} > "
                              f"{KERNEL_TOL} ({kind}, {h}x{w}, row0 {row0})")
                        worst = max(worst, err)
                    else:
                        check(within_one_bf16_ulp(got, want),
                              f"k1 rows bf16: beyond one ulp ({kind}, "
                              f"{h}x{w}, row0 {row0})")
                        worst_bf16 = max(worst_bf16, err)
                    check(torch.equal(got, whole[:, sl]), f"k1 rows: not "
                          f"the whole map's rows ({kind}, {h}x{w})")
                log("k1 rows", f"{h}x{w} {kind} {str(dt)[6:]}: both halves "
                    f"within the gate, equal to the whole map's launch")
        for dt in (torch.float32, torch.bfloat16):
            value, py, px, mask = sampler_inputs(1, h, w, g, cg, p,
                                                 "random", gen)
            value = value.to(dt)
            name = f"{h}x{w} {str(dt)[6:]}"
            times[h, w, dt, None] = k1_rows_timing(
                value, py, px, mask, None, f"{name} whole map")
            for row0 in (0, half):
                sl = slice(row0 * w, (row0 + half) * w)
                args = [t[:, sl].contiguous() for t in (py, px, mask)]
                times[h, w, dt, row0] = k1_rows_timing(
                    value, *args, (row0, half), f"{name} rows "
                    f"[{row0}, {row0 + half})")
    return dict(max_abs_err=worst, bf16_err=worst_bf16, times=times)


def par_forward(model, img: np.ndarray, mesh=None,
                capture: bool = False, valid_hw=None) -> dict:
    """``model.predict_logits`` of one image on the card (row-sharded
    over ``mesh``'s data group when given, in bands of the model's
    ``band_stride``; ``valid_hw`` the image's valid extent), run once
    with the launches counted (and, with ``capture``, every K1 call held
    to its plain version), then timed twice; the logits, launches, host
    ms and peak GiB."""
    x = preprocess(torch.from_numpy(img[None]).cuda())
    vhw = None if valid_hw is None else torch.tensor([valid_hw]).cuda()

    def run():
        with torch.no_grad(), f32_precision():
            if mesh is None:
                return model.predict_logits(x, vhw)
            with parallel.spatial_sharding(mesh):
                band = model.predict_logits(
                    parallel.shard_rows(x, stride=model.band_stride), vhw)
                return parallel.gather_rows_h(band)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    store: dict = {}
    with (capture_dcn(store) if capture else contextlib.nullcontext()):
        logits = run()
    torch.cuda.synchronize()
    launches = read_launches()
    held = (hold_captured(store, "par", k1=launches["k1"])["k1"]
            if capture else None)
    del store
    ms = []
    for _ in range(2):
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    return dict(logits=logits.float().cpu(), launches=launches, ms=ms,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                held=held)


def par_step(tr, batch, mesh=None, warmup=None) -> dict:
    """One train step of ``tr`` on ``batch`` (this data rank's rows),
    after a step on ``warmup`` where given; the step's metrics, the
    logical post-step state (gathered over the model group), launches,
    host ms and peak GiB."""
    if warmup is not None:
        api.train_steps(tr, [warmup])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t = time.perf_counter()
    metrics = api.train_steps(tr, [batch])[0]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    sd = tr.state.model.state_dict()
    if mesh is not None:
        sd = parallel.gather_params_tp(sd, mesh)
    return dict(metrics=metrics, launches=read_launches(), ms=ms,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                state={k: v.detach().cpu() for k, v in sd.items()})


def par_images() -> dict:
    """The seeded uint8 images of (tp) and (spatial)."""
    rng = np.random.default_rng(11)
    return {hw: rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
            for hw in (FLAGSHIP_HW, CITYSCAPES_SHAPE, (64, 64))}


def par_batch(b: int, hw, seed: int = 13, **kw):
    return synthetic_batch(np.random.default_rng(seed), b, hw, **kw)


def par_two(mesh_of) -> dict:
    """The two-rank cases of (tp) and (spatial), each built from seed 0
    on every rank (``mesh_of(model_axis)`` gives the mesh; None: one
    process).  Keys: ('tp', dtype), ('tp', 'step'), ('spatial', preset,
    dtype)."""
    imgs = par_images()
    res = {}
    mesh = mesh_of(2)
    for tag, opts in (("f32", []), ("bf16", BF16_OPTS)):
        im = drawn_model(PRESET, overrides=opts, seed=0)
        if mesh is not None:
            parallel.shard_params_tp(im.model, mesh)
        res["tp", tag] = par_forward(im.model, imgs[FLAGSHIP_HW],
                                     capture=tag == "f32")
        del im
        torch.cuda.empty_cache()
    tr = drawn_trainer(PRESET, seed=0)
    if mesh is not None:
        parallel.shard_params_tp(tr.state, mesh)
    res["tp", "step"] = par_step(tr, par_batch(2, TP_STEP_HW), mesh,
                                 warmup=par_batch(2, TP_STEP_HW, seed=17))
    del tr
    torch.cuda.empty_cache()
    mesh = mesh_of(1)
    for preset, hw in ((PRESET, FLAGSHIP_HW),
                       (CITYSCAPES, CITYSCAPES_SHAPE)):
        for tag, opts in (("f32", []), ("bf16", BF16_OPTS)):
            im = drawn_model(preset, overrides=opts, seed=0)
            res["spatial", preset, tag] = par_forward(
                im.model, imgs[hw], mesh, capture=tag == "f32")
            del im
            torch.cuda.empty_cache()
    return res


def par_four(mesh_of) -> dict:
    """The four-rank cases: the tiny model's DP2 x TP2 step (each data
    rank two rows of a global batch of 4) and its 64x64 forward in four
    row bands."""
    overrides, crop, synth = DDP_CONFIGS["tiny"]
    res = {}
    mesh = mesh_of(2)
    tr = drawn_trainer(PRESET, overrides, seed=0)
    batch = par_batch(4, (crop, crop), **synth)
    if mesh is not None:
        parallel.shard_params_tp(tr.state, mesh)
        batch = parallel.shard_batch(batch)     # this data rank's rows
    res["step"] = par_step(tr, batch, mesh)
    del tr
    im = drawn_model(PRESET, overrides=overrides, seed=0)
    res["spatial"] = par_forward(im.model, par_images()[64, 64],
                                 mesh_of(1), capture=True)
    return res


PAR_SETS = {"two": par_two, "four": par_four}


def par_worker(argv: list[str]) -> int:
    """One rank of (tp) / (spatial), started as ``chip_smoke.py
    --par-worker COORD PID NPROC OUT SET``: joins a gloo group of
    ``NPROC`` ranks on the one card, runs ``PAR_SETS[SET]`` and saves its
    results to ``OUT``."""
    coord, pid, nproc, out, which = argv
    parallel.distributed_init(coord, int(nproc), int(pid), backend="gloo")
    try:
        torch.save(PAR_SETS[which](parallel.make_mesh), out)
    finally:
        parallel.shutdown()
    return 0


def par_launch(which: str, nproc: int, tmp: str) -> list:
    """Run ``PAR_SETS[which]`` on ``nproc`` gloo ranks (this script as
    ``--par-worker``); each rank's results."""
    coord = f"localhost:{parallel.free_port()}"
    outs = [os.path.join(tmp, f"{which}{i}.pt") for i in range(nproc)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--par-worker", coord,
         str(i), str(nproc), outs[i], which], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i in range(nproc)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=PAR_TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            p.kill()
            logs.append(p.communicate()[0])
    for i, (p, out) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"{which} rank {i} failed:\n{out[-3000:]}")
    return [torch.load(o, weights_only=False) for o in outs]


def full_width_gate(tag: str, ranks: list, want: torch.Tensor) -> dict:
    """The ranks' logits bitwise equal, finite, at least ``FULL_AGREE`` of
    the elements within ``FULL_TOL`` of one process's and of the pixels'
    classes equal; the worst element printed."""
    got = ranks[0]
    check(all(torch.equal(r, got) for r in ranks[1:]),
          f"{tag}: the ranks' logits differ")
    check(bool(torch.isfinite(got).all()) and got.shape == want.shape,
          f"{tag}: logits {tuple(got.shape)} against {tuple(want.shape)}")
    d = (got - want).abs()
    within = (d <= FULL_TOL).float().mean().item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    i = int(d.argmax())
    where = np.unravel_index(i, tuple(d.shape))
    log("par", f"{tag}: {within:.6f} of the logits within {FULL_TOL} of one "
        f"process, class agreement {agree:.6f}; worst element "
        f"{tuple(int(k) for k in where)}: {got.flatten()[i].item():.6g} "
        f"against {want.flatten()[i].item():.6g}")
    check(within >= FULL_AGREE and agree >= FULL_AGREE,
          f"{tag}: {within:.6f} within {FULL_TOL}, agreement {agree:.6f} "
          f"(need {FULL_AGREE})")
    return dict(within=within, agree=agree, gap=d.max().item())


def phase_tp_spatial(smi: str) -> dict:
    """(tp) and (spatial): two gloo ranks on the one card against this
    process (``par_two``), then four (``par_four``).

    (tp), model axis 2: the flagship at full width split (its FFNs' 1024
    and 2048 hidden channels and the mask-embed MLP) serves a 512x512
    image in f32 and bf16, and takes a train step at 128x128, batch 2,
    each rank with the whole batch; the tiny model's DP2 x TP2 step on
    four ranks.  (spatial), data axis 2: the flagship at 512x512 and
    ``CITYSCAPES`` at its whole 1024x2048 image, in f32 and bf16, in two
    row bands; the tiny model at 64x64 in four.  Full width: the ranks
    bitwise equal and ``full_width_gate``; tiny: within ``TP_TINY_RTOL``
    / ``SP_TINY_TOL`` of one process.  K1 (and K2) launches, ms and peak
    GiB of every rank and of one process."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        two = par_launch("two", 2, tmp)
        four = par_launch("four", 4, tmp)
    t_ranks = time.perf_counter() - t0
    one = par_two(lambda _: None)
    one4 = par_four(lambda _: None)
    out = dict(launches=[], bf16_launches=[], k1_err=0.0)

    def record(name, rs, single):
        out["launches"] += [r["launches"] for r in rs] + [single["launches"]]
        held = [r["held"] for r in rs + [single] if r.get("held") is not None]
        out["k1_err"] = max([out["k1_err"]] + held)
        log("par", f"{name}: K1/K2 launches a rank "
            f"{[(r['launches']['k1'], r['launches']['k2']) for r in rs]} "
            f"(one process {single['launches']['k1']}/"
            f"{single['launches']['k2']}; bf16 "
            f"{[r['launches']['k1_bf16'] for r in rs]}); ms a rank "
            f"{[fmt_ms(np.atleast_1d(r['ms'])) for r in rs]} against "
            f"{fmt_ms(np.atleast_1d(single['ms']))}; peak GiB a rank "
            f"{[round(r['peak_gib'], 3) for r in rs]} against "
            f"{single['peak_gib']:.3f} on {smi}")

    for key in (("tp", "f32"), ("tp", "bf16")):
        rs = [r[key] for r in two]
        out[key] = full_width_gate(f"(tp) {key[1]} 512x512",
                                   [r["logits"] for r in rs],
                                   one[key]["logits"])
        for r in rs + [one[key]]:
            check(r["launches"]["k1"] == 6, f"(tp) {key}: K1 "
                  f"{r['launches']}")
        record(f"(tp) {key[1]} request", rs, one[key])
    rs = [r["tp", "step"] for r in two]
    single = one["tp", "step"]
    check(rs[0]["metrics"] == rs[1]["metrics"],
          "(tp) step: the ranks' metrics differ")
    check(all(torch.equal(v, rs[1]["state"][k])
              for k, v in rs[0]["state"].items()),
          "(tp) step: the ranks' gathered parameters differ")
    check(all(np.isfinite(v) for v in rs[0]["metrics"].values()),
          f"(tp) step: metrics {rs[0]['metrics']}")
    gaps = {k: abs(rs[0]["metrics"][k] - w) / max(abs(w), 1e-6)
            for k, w in single["metrics"].items()}
    pgap = max(float((rs[0]["state"][k] - w).abs().max())
               for k, w in single["state"].items())
    worst_k = max(gaps, key=gaps.get)
    out["step"] = dict(metric_gap=gaps[worst_k],
                       grad_norm_gap=gaps["grad_norm"], param_gap=pgap)
    for r in rs + [single]:
        check((r["launches"]["k1"], r["launches"]["k2"]) == (6, 6),
              f"(tp) step: K1/K2 {r['launches']}")
    log("par", f"(tp) second step at {TP_STEP_HW}, batch 2, model axis 2 "
        f"against one process: largest metric rel gap {gaps[worst_k]:.3g} "
        f"({worst_k}), total {rs[0]['metrics']['total']:.7g} / "
        f"{single['metrics']['total']:.7g}, grad_norm "
        f"{rs[0]['metrics']['grad_norm']:.7g} / "
        f"{single['metrics']['grad_norm']:.7g}, largest post-step "
        f"parameter gap {pgap:.3g}; ranks bitwise equal")
    record("(tp) step", rs, single)

    for preset in (PRESET, CITYSCAPES):
        for tag in ("f32", "bf16"):
            key = ("spatial", preset, tag)
            rs = [r[key] for r in two]
            hw = tuple(one[key]["logits"].shape[1:3])
            out[key] = full_width_gate(f"(spatial) {preset} {tag} {hw}",
                                       [r["logits"] for r in rs],
                                       one[key]["logits"])
            for r in rs + [one[key]]:
                check(r["launches"]["k1"] == 6, f"(spatial) {key}: K1 "
                      f"{r['launches']}")
            record(f"(spatial) {preset} {tag} {hw}", rs, one[key])

    rs = [r["step"] for r in four]
    single = one4["step"]
    worst = max(abs(rs[0]["metrics"][k] - w) / max(abs(w), 1e-6)
                for k, w in single["metrics"].items())
    check(all(r["metrics"] == rs[0]["metrics"] for r in rs[1:]),
          "(tp) tiny DP2 x TP2: the ranks' metrics differ")
    check(all(torch.equal(v, r["state"][k]) for r in rs[1:]
              for k, v in rs[0]["state"].items()),
          "(tp) tiny DP2 x TP2: the ranks' gathered parameters differ")
    check(worst <= TP_TINY_RTOL, f"(tp) tiny DP2 x TP2 against one "
          f"process: {worst:.3g} > {TP_TINY_RTOL}")
    pgap = max(float((rs[0]["state"][k] - w).abs().max())
               for k, w in single["state"].items())
    log("par", f"(tp) tiny DP2 x TP2 step (each process's first) on four "
        f"ranks against one process: largest metric rel gap {worst:.3g} (tol {TP_TINY_RTOL}),"
        f" largest post-step parameter gap {pgap:.3g}")
    record("(tp) tiny DP2 x TP2 step", rs, single)
    out["tiny_step"] = worst
    rs = [r["spatial"] for r in four]
    single = one4["spatial"]
    gap = max(float((r["logits"] - single["logits"]).abs().max())
              for r in rs)
    check(gap <= SP_TINY_TOL, f"(spatial) tiny 64x64 on four ranks: "
          f"{gap:.3g} > {SP_TINY_TOL}")
    log("par", f"(spatial) tiny 64x64 in four row bands against one "
        f"process: max|diff| {gap:.3g} (tol {SP_TINY_TOL})")
    record("(spatial) tiny 64x64", rs, single)
    out["tiny_spatial"] = gap
    log("par", f"(tp) and (spatial) took {time.perf_counter() - t0:.1f}s "
        f"(ranks {t_ranks:.1f}s)")
    return out


# --- slice seventeen: row-sharded inference of every model family -----------

SDTV3_CITY = "SDTv3_b_Spike2former_Cityscapes_512x1024"
FAM_BUCKET = (683, 512)        # a keep-ratio eval image, in its 128 bucket
FAM_HW = (512, 512)
# name -> (preset, overrides, capture K1): the second launch's models
FAM_MODELS = {
    "sdtv3mae": (V3_PRESETS["sdtv3mae"], [], True),
    "m2f": (PRESET, VARIANTS["m2f"], True),
    "dab": (PRESET, VARIANTS["dab"], True),
    "fpn bf16": (FPN_PRESET, BF16_OPTS, False),
    "msresnet18": ("fpn_msresnet18_512x512_ade20k", [], False),
    # in f32 the cascade's own logits move as much under another
    # summation order (cuDNN off: 0.0072 within 1e-3, classes 0.999) as
    # under bands (tests/torch_spatial_sensitivity.py); in bf16 the bands
    # are bitwise one process's
    "cascade bf16": ("cascade_fpn_sdtv2_512x512_ade20k", BF16_OPTS, False),
}


def fam_images() -> dict:
    """The seeded uint8 images of (spatial families): the Cityscapes
    image, the 512x512 one and the bucketed one padded to its bucket
    (zeros, as the eval pads)."""
    rng = np.random.default_rng(19)
    imgs = {hw: rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
            for hw in (CITYSCAPES_SHAPE, FAM_HW, FAM_BUCKET)}
    bh, bw = bucket_hw(*FAM_BUCKET)
    imgs["bucket"] = np.pad(imgs.pop(FAM_BUCKET),
                            ((0, bh - FAM_BUCKET[0]),
                             (0, bw - FAM_BUCKET[1]), (0, 0)))
    return imgs


def par_panoptic(model, img: np.ndarray, mesh=None) -> dict:
    """``whole_panoptic`` of one image as ``par_forward`` runs
    ``predict_logits`` (every K1 call held); ``sem`` and ``inst``
    gathered."""
    x = torch.from_numpy(img[None]).cuda()

    def run():
        if mesh is None:
            return whole_panoptic(model, x, num_things=80)
        with parallel.spatial_sharding(mesh):
            sem, inst = whole_panoptic(model, parallel.shard_rows(x),
                                       num_things=80)
            return parallel.gather_rows_h(sem), parallel.gather_rows_h(inst)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    store: dict = {}
    with capture_dcn(store):
        sem, inst = run()
    torch.cuda.synchronize()
    launches = read_launches()
    held = hold_captured(store, "par", k1=launches["k1"])["k1"]
    del store
    ms = []
    for _ in range(2):
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    return dict(sem=sem.cpu(), inst=inst.cpu(), launches=launches, ms=ms,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                held=held)


def fam_cityscapes(mesh_of) -> dict:
    """``SDTV3_CITY`` at full width on its whole image, f32 and bf16."""
    img = fam_images()[CITYSCAPES_SHAPE]
    res = {}
    for tag, opts in (("f32", []), ("bf16", BF16_OPTS)):
        im = drawn_model(SDTV3_CITY, overrides=opts, seed=0)
        res[tag] = par_forward(im.model, img, mesh_of(1), capture=True)
        del im
        torch.cuda.empty_cache()
    return res


def fam_models(mesh_of) -> dict:
    """The bucketed eval, ``FAM_MODELS`` and the panoptic merge, each
    built from seed 0."""
    imgs = fam_images()
    mesh = mesh_of(1)
    im = drawn_model(PRESET, seed=0)
    res = {"bucketed": par_forward(im.model, imgs["bucket"], mesh,
                                   capture=True, valid_hw=FAM_BUCKET)}
    del im
    for name, (preset, opts, capture) in FAM_MODELS.items():
        im = drawn_model(preset, overrides=opts, seed=0)
        res[name] = par_forward(im.model, imgs[FAM_HW], mesh,
                                capture=capture)
        del im
        torch.cuda.empty_cache()
    im = drawn_model(PANOPTIC, seed=0)
    head = im.model.head
    with torch.no_grad():
        # confident queries, as confident_tiny_model's, and the 80 thing
        # classes favoured: on the 512x512 image the merge keeps two
        # thing instances that cover it (random weights' are all void)
        head.query_feat.copy_(2.0 * torch.randn(
            head.query_feat.shape, generator=torch.Generator().manual_seed(
                119)))
        head.cls_embed.weight.mul_(16.0)
        head.cls_embed.bias[:80] += 20.0
        head.mask_embed.Dense_2.weight.mul_(32.0)
    res["panoptic"] = par_panoptic(im.model, imgs[FAM_HW], mesh)
    return res


PAR_SETS.update(fam_cityscapes=fam_cityscapes, fam_models=fam_models)


def phase_spatial_families(smi: str) -> dict:
    """(spatial families): two gloo ranks on the one card against this
    process, ``fam_cityscapes`` and then ``fam_models`` (one launch
    each); the gates of (spatial), K1's 6 launches a rank and image on
    every MaskFormer path (none on the FPN family's), ms and peak GiB a
    rank beside one process's."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = {which: par_launch(which, 2, tmp)
                 for which in ("fam_cityscapes", "fam_models")}
    t_ranks = time.perf_counter() - t0
    one = {"fam_cityscapes": fam_cityscapes(lambda _: None),
           "fam_models": fam_models(lambda _: None)}
    out = dict(launches=[], k1_err=0.0, k1_bf16_err=0.0)
    for which, results in one.items():
        for name, single in results.items():
            rs = [r[name] for r in ranks[which]]
            what = (f"(spatial families) {SDTV3_CITY} {name} "
                    f"{CITYSCAPES_SHAPE}" if which == "fam_cityscapes"
                    else f"(spatial families) {name}")
            if name == "panoptic":
                for key in ("sem", "inst"):
                    check(all(torch.equal(r[key], rs[0][key])
                              for r in rs[1:]),
                          f"{what}: the ranks' {key} differ")
                    same = (rs[0][key] == single[key]).float().mean().item()
                    check(same >= FULL_AGREE, f"{what}: {key} equal on "
                          f"{same:.6f} of the pixels (need {FULL_AGREE})")
                    out[name, key] = same
                check(bool((single["sem"] >= 0).any()),
                      f"{what}: one process's merge is all void")
                log("par", f"{what}: sem/inst equal to one process on "
                    f"{out[name, 'sem']:.6f}/{out[name, 'inst']:.6f} of "
                    f"the pixels; one process: "
                    f"{(single['sem'] >= 0).float().mean().item():.4f} of "
                    f"the pixels not void, "
                    f"{len(torch.unique(single['inst'])) - 1} instances")
            else:
                out[name] = full_width_gate(
                    what, [r["logits"] for r in rs], single["logits"])
            maskformer = "held" in single and single["held"] is not None
            for r in rs + [single]:
                check(r["launches"]["k1"] == (6 if maskformer else 0),
                      f"{what}: K1 {r['launches']}")
            out["launches"] += [r["launches"] for r in rs] + [
                single["launches"]]
            held = [r["held"] for r in rs + [single]
                    if r.get("held") is not None]
            err = "k1_bf16_err" if name == "bf16" else "k1_err"
            out[err] = max([out[err]] + held)
            log("par", f"{what}: K1 launches a rank "
                f"{[r['launches']['k1'] for r in rs]} (bf16 "
                f"{[r['launches']['k1_bf16'] for r in rs]}; one process "
                f"{single['launches']['k1']}); ms a rank "
                f"{[fmt_ms(np.atleast_1d(r['ms'])) for r in rs]} against "
                f"{fmt_ms(np.atleast_1d(single['ms']))}; peak GiB a rank "
                f"{[round(r['peak_gib'], 3) for r in rs]} against "
                f"{single['peak_gib']:.3f} on {smi}")
    log("par", f"(spatial families) took {time.perf_counter() - t0:.1f}s "
        f"(ranks {t_ranks:.1f}s)")
    return out


LIB_TOL = 1e-4           # |card - CPU| <= LIB_TOL * (1 + |CPU|)
LIB_AGREE = 1.0          # share of the elements within LIB_TOL
# spiking modules at their full sizes: the float32 sums of thousands of
# terms run in another order on the card, and a sum that lands on the
# other side of a quantization step flips a spike level, which the next
# layers spread; below, the same modules at small sizes are held at
# LIB_SPIKE_AGREE
LIB_FULL_AGREE = 0.8
LIB_FULL_MEAN = 1e-2     # and mean|card - CPU| <= this * mean|CPU|
LIB_SPIKE_AGREE = 0.999


def hold_module(name: str, module: torch.nn.Module, args: tuple,
                agree: float | None = None, train: bool = False) -> float:
    """``module`` on the card against a CPU copy of it on the same inputs
    (float32, TF32 off): every output finite, at least ``agree`` (by
    default ``LIB_AGREE``) of the elements within ``LIB_TOL``, the mean
    difference within ``LIB_FULL_MEAN`` of the mean magnitude; returns
    the largest difference."""
    agree = LIB_AGREE if agree is None else agree
    cpu = copy.deepcopy(module).cpu().train(train)
    card = module.cuda().train(train)

    def flat(out):
        if isinstance(out, torch.Tensor):
            return [out]
        if isinstance(out, (tuple, list)):
            return [t for o in out for t in flat(o)]
        return []

    with torch.no_grad(), f32_precision():
        want = flat(cpu(*(a.cpu() if isinstance(a, torch.Tensor) else a
                          for a in args)))
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = flat(card(*(a.cuda() if isinstance(a, torch.Tensor) else a
                          for a in args)))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
    worst, n, bad, total_d, total_w = 0.0, 0, 0, 0.0, 0.0
    for g, w in zip(got, want):
        g = g.float().cpu()
        w = w.float()
        check(bool(torch.isfinite(g).all()), f"{name}: non-finite output")
        d = (g - w).abs()
        worst = max(worst, float(d.max()) if d.numel() else 0.0)
        n += d.numel()
        bad += int((d > LIB_TOL * (1 + w.abs())).sum())
        total_d += float(d.sum())
        total_w += float(w.abs().sum())
    share = 1.0 - bad / max(n, 1)
    log("library", f"{name}: card vs CPU max|diff| {worst:.3g}, share "
        f"within {LIB_TOL} {share:.6f} (need {agree}), mean|diff| / "
        f"mean|CPU| {total_d / max(total_w, 1e-30):.3g}, {n} elements, "
        f"card {ms:.1f} ms (first call)")
    check(share >= agree, f"{name}: {share:.6f} of the outputs within "
          f"{LIB_TOL} < {agree}")
    check(total_d <= LIB_FULL_MEAN * total_w, f"{name}: mean|diff| "
          f"{total_d / max(total_w, 1e-30):.3g} of mean|CPU|")
    return worst


def phase_library(smi: str) -> dict:
    """(library): each module this slice adds, built with weights from
    seed 0 (``engine/weights.py``), on the card against a CPU copy on the
    same seeded inputs; then the native runtime."""
    from spike2former_tpu_torch import runtime
    from spike2former_tpu_torch.ann2snn import AnnSequential, Converter
    from spike2former_tpu_torch.models.cyclemlp import CycleBlock
    from spike2former_tpu_torch.models.spikeformer_lib import (
        QueryProposal, SpikeformerDecoderLayer)
    from spike2former_tpu_torch.ops.rnn import (SpikingGRU, SpikingLSTM,
                                                SpikingVanillaRNN)

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(11)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen) * scale

    errs = {}

    def decoder_layer(keys, queries=100):
        layer = randomize_(SpikeformerDecoderLayer(256, 8, 1024), 0)
        return layer, (randn(4, 1, queries, 256, scale=2.0),
                       randn(4, 1, keys, 256, scale=2.0),
                       randn(4, 1, queries, 256), randn(4, 1, keys, 256))

    def proposal(hw, queries=100):
        qp = randomize_(QueryProposal(256, num_queries=queries,
                                      num_classes=150), 0)
        return qp, (randn(2, hw, hw, 256, scale=2.0),
                    randn(1, hw, hw, 256), True)

    def rnn(cls, t, b):
        return randomize_(cls(256, 256), 0), (randn(t, b, 256),)

    spiking = [
        ("SpikeformerDecoderLayer (256 ch, 8 heads, 100 queries, T=4, "
         "64x64 keys)", *decoder_layer(64 * 64), LIB_FULL_AGREE),
        ("SpikeformerDecoderLayer (16 queries, 4x4 keys)",
         *decoder_layer(16, 16), LIB_SPIKE_AGREE),
        ("QueryProposal (150 classes, 100 queries, 128x128)",
         *proposal(128), LIB_FULL_AGREE),
        ("QueryProposal (150 classes, 10 queries, 8x8)", *proposal(8, 10),
         LIB_SPIKE_AGREE)]
    for cls in (SpikingLSTM, SpikingGRU, SpikingVanillaRNN):
        spiking += [
            (f"{cls.__name__} (256 -> 256, T=16, batch 32)",
             *rnn(cls, 16, 32), LIB_FULL_AGREE),
            (f"{cls.__name__} (T=4, batch 2)", *rnn(cls, 4, 2),
             LIB_SPIKE_AGREE)]
    for name, module, args, agree in spiking:
        errs[name.split(" (")[0] + ("" if agree == LIB_FULL_AGREE
                                    else " small")] = hold_module(
            name, module, args, agree=agree)
    errs["CycleBlock"] = hold_module(
        "CycleBlock (dim 256)", randomize_(CycleBlock(256), 0),
        (randn(2, 32, 32, 256),))

    # ANN->SNN: calibrate on the card and on the CPU, the SNN at T=32
    def ann():
        torch.manual_seed(0)
        return AnnSequential((
            torch.nn.Conv2d(3, 64, 3, padding=1), "relu",
            torch.nn.Conv2d(64, 128, 3, stride=2, padding=1), "relu",
            lambda x: x.mean((1, 2)), torch.nn.Linear(128, 10)))

    calib = [torch.rand((16, 32, 32, 3), generator=gen) for _ in range(2)]
    x = torch.rand((16, 32, 32, 3), generator=gen)
    with torch.no_grad(), f32_precision():
        snn_c, scales_c = Converter("99.9%").convert(ann(), calib, t=32)
        snn_g, scales_g = Converter("99.9%").convert(
            ann().cuda(), [c.cuda() for c in calib], t=32)
        y_c, y_g = snn_c(x), snn_g(x.cuda()).cpu()
    d = (y_g - y_c).abs()
    share = float((d <= LIB_TOL * (1 + y_c.abs())).float().mean())
    errs["ann2snn"] = float(d.max())
    log("library", f"ANN->SNN (T=32, 99.9% scales): scales card "
        f"{[round(s, 6) for s in scales_g]} CPU "
        f"{[round(s, 6) for s in scales_c]}, outputs max|diff| "
        f"{errs['ann2snn']:.3g}, share within {LIB_TOL} {share:.4f}")
    check(np.allclose(scales_g, scales_c, rtol=1e-5)
          and bool(torch.isfinite(y_g).all()) and share >= LIB_FULL_AGREE,
          f"ANN->SNN card vs CPU: scales {scales_g} / {scales_c}, share "
          f"{share}")

    # the native image runtime: built here or not, as in the JAX package
    if not runtime.available():
        log("library", f"native runtime not available on this machine "
            f"(the JAX package's contract: every function returns None): "
            f"{(runtime.build_error() or '').splitlines()[:3]}")
        check(runtime.decode_image("missing.png") is None,
              "runtime without a library returned an array")
        rt = False
    else:
        rng = np.random.default_rng(12)
        with tempfile.TemporaryDirectory() as tmp:
            img = rng.integers(0, 255, (37, 53, 3), np.uint8)
            Image.fromarray(img).save(os.path.join(tmp, "x.png"))
            Image.fromarray(img).save(os.path.join(tmp, "x.jpg"),
                                      quality=95)
            png = runtime.decode_image(os.path.join(tmp, "x.png"))
            jpg = runtime.decode_image(os.path.join(tmp, "x.jpg"))
            with Image.open(os.path.join(tmp, "x.jpg")) as im:
                pil_jpg = np.asarray(im.convert("RGB"))
        check(png is not None and np.array_equal(png, img),
              "runtime PNG decode differs from the image PIL wrote")
        jpg_gap = float(np.abs(jpg.astype(int) - pil_jpg.astype(int)).mean())
        check(jpg_gap < 2.0, f"runtime JPEG decode vs PIL mean gap "
              f"{jpg_gap}")
        rs = runtime.resize_bilinear_u8(img, 80, 120).astype(np.float32)
        ref = F.interpolate(
            torch.from_numpy(img.astype(np.float32)).permute(2, 0, 1)[None],
            size=(80, 120), mode="bilinear", align_corners=False
        )[0].permute(1, 2, 0).numpy()
        rs_gap = float(np.abs(rs - ref).max())
        check(rs_gap <= 1.0, f"runtime bilinear resize gap {rs_gap}")
        log("library", f"native runtime built: PNG decode equal to PIL's "
            f"image, JPEG mean gap to PIL {jpg_gap:.3g}, bilinear resize "
            f"max gap to F.interpolate {rs_gap:.3g}")
        rt = True
    log("library", f"the phase took {time.perf_counter() - t0:.1f}s on "
        f"{smi}")
    return dict(errs=errs, runtime=rt)


# (burnin): the burn-in at the module's defaults and full width, bf16
BURNIN_STEPS, BURNIN_CKPT, BURNIN_CRASH, BURNIN_VAL = 24, 6, 15, 12
BURNIN_ARGS = ["--steps", str(BURNIN_STEPS), "--batch-size", "4",
               "--image-size", "512", "--num-classes", "150", "--dtype",
               "bfloat16", "--ckpt-every", str(BURNIN_CKPT), "--resume-at",
               str(BURNIN_CRASH), "--val-every", str(BURNIN_VAL),
               "--log-every", "1"]
# the newest checkpoint at the crash, the steps run (15, then 13-24 again
# from ckpt_12) and the val forwards (one batch of 2 images at 12 and 24)
BURNIN_RESTORED = BURNIN_CRASH // BURNIN_CKPT * BURNIN_CKPT
BURNIN_RUN = BURNIN_CRASH + BURNIN_STEPS - BURNIN_RESTORED
BURNIN_VALS = BURNIN_STEPS // BURNIN_VAL
# (learning): the learning run on a generated set of 16 train and 4 val
# images at 512x512, 10 iterations
LEARN_ITERS, LEARN_TRAIN, LEARN_VAL, LEARN_LOG = 10, 16, 4, 5
LEARN_OPTS = [f"train.val_interval={LEARN_LOG}",
              f"train.checkpoint_interval={LEARN_ITERS}"]
# the flagship's DCN value map at 512x512, [N, 32, 32, 256], by batch size
FLAGSHIP_MAP = (32, 32, 256)


def phase_burnin(smi: str) -> dict:
    """(burnin): ``tools/burnin.py``'s port at full width (the module's
    defaults, 150 classes, 512x512, batch 4, bf16) for 24 steps, a
    checkpoint every 6, a crash at 15 and a val every 12.  Every logged
    loss finite, the run resumed from ckpt_12, the restored state bitwise
    that checkpoint, bf16 K1 and K2 6 launches a step run (27) and K1 6
    a val forward (2, of 2 images each); the first step's K1 and K2 calls
    (N=4) and the first val forward's K1 calls (N=2) held to their plain
    versions, and again on their grids (``hold_on_grid``: from flax's
    laws, the tool's start, the DCN branch is silent); its JSON line, s a
    step, peak memory and the largest share of non-zero mask spikes."""
    with tempfile.TemporaryDirectory() as tmp:
        args = burnin.parser().parse_args(BURNIN_ARGS + ["--work-dir", tmp])
        restored = []
        real_restore = burnin.restore_state

        def restore(path, state):
            out = real_restore(path, state)
            check_saved(torch.load(path, weights_only=True),
                        state_snapshot(state), f"(burnin) restored {path}")
            restored.append((os.path.basename(path), state.step))
            return out

        burnin.restore_state = restore
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        t = time.perf_counter()
        buf, store, shares = io.StringIO(), {}, []
        try:
            with contextlib.redirect_stdout(buf), capture_dcn(
                    store, first=6), mask_shares(shares):
                out = burnin.run(args)
        finally:
            burnin.restore_state = real_restore
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = read_launches()
        held = hold_captured(store, "burnin", k1=12, k2=6, shapes=[
            ("K1", (4, *FLAGSHIP_MAP)), ("K2", (4, *FLAGSHIP_MAP)),
            ("K1", (2, *FLAGSHIP_MAP))])
        grid = hold_on_grid(store, "burnin", 24)
        del store
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        for line in buf.getvalue().splitlines():
            if "val" in line or "resumed" in line:
                log("burnin", line)
        recs = read_scalars(os.path.join(tmp, "burnin.jsonl"))
    summary = out["summary"]
    log("burnin", json.dumps(summary))
    check(summary["all_finite"] and summary["resumed_mid_run"],
          f"(burnin) {summary}")
    check(restored == [(f"ckpt_{BURNIN_RESTORED}", BURNIN_RESTORED)],
          f"(burnin) restored {restored}")
    steps = [r for r in recs if "loss" in r]
    check([r["step"] for r in steps]
          == list(range(1, BURNIN_CRASH + 1))
          + list(range(BURNIN_RESTORED + 1, BURNIN_STEPS + 1)),
          f"(burnin) logged steps {[r['step'] for r in steps]}")
    check(all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
              for r in steps), "(burnin) a logged loss is not finite")
    vals = [r for r in recs if "val_acc" in r]
    check([r["step"] for r in vals]
          == list(range(BURNIN_VAL, BURNIN_STEPS + 1, BURNIN_VAL)),
          f"(burnin) vals {vals}")
    k1, k2 = 6 * (BURNIN_RUN + BURNIN_VALS), 6 * BURNIN_RUN
    # every launch is of the bf16 forms (``launches`` counts both dtypes);
    # the threefry kernel draws the weights of seed 0 and of the resume's
    # fresh state (seed 1), the steps draw nothing
    want = dict(k1=k1, k2=k2, k1_bf16=k1, k2_bf16=k2, grouped=(0, 0),
                grouped_bf16=(0, 0),
                threefry=2 * drawn_entries(burnin.build_model(args)))
    check(launches == want, f"(burnin) launches {launches}, want {want}")
    # s a step: the median gap between consecutive logged steps of one
    # segment (the resume's restore and the vals fall between segments
    # or in a few gaps)
    gaps = [b["sec"] - a["sec"] for a, b in zip(steps, steps[1:])
            if b["step"] == a["step"] + 1]
    s_step = statistics.median(gaps)
    log("burnin", f"{s_step:.4f} s a step (median of {len(gaps)} gaps; "
        f"min {min(gaps):.4f}, max {max(gaps):.4f}), {wall:.1f}s in all, "
        f"peak {peak:.3f} GiB, val pixel-acc "
        f"{[round(r['val_acc'], 4) for r in vals]}, bf16 K1/K2 launches "
        f"{launches['k1_bf16']}/{launches['k2_bf16']}; the largest share "
        f"of non-zero DCN mask spikes in a K1 call {max(shares):.4g} on "
        f"{smi}")
    return dict(launches=launches, summary=summary, s_step=s_step,
                peak_gib=peak, wall=wall,
                held=dict(k1=max(held["k1"], grid["k1"]),
                          k2=max(held["k2"], grid["k2"])))


def phase_learning(smi: str) -> dict:
    """(learning): ``tools/learning_run.sh``'s port on a generated set of
    16 train and 4 val images at 512x512 for 10 iterations (val every 5,
    a checkpoint at 20), then its report: every logged loss finite, the
    report's val rows the ``scalars.jsonl`` mIoU records, its sha256 that
    of ckpt_10 hashed afresh, bf16 K1 and K2 6 launches an iteration and
    K1 6 a val image; the first iteration's K1 and K2 calls (N=8) and the
    first val image's K1 calls (N=1) held to their plain versions and
    again on their grids, as (burnin)'s."""
    with tempfile.TemporaryDirectory() as tmp:
        wd, md = os.path.join(tmp, "wd"), os.path.join(tmp, "LEARNING.md")
        torch.cuda.synchronize()
        zero_launches()
        t, store, shares = time.perf_counter(), {}, []
        with capture_dcn(store, first=6), mask_shares(shares):
            run_cli(learning_run.main, [
                "--iters", str(LEARN_ITERS), "--data-root",
                os.path.join(tmp, "data"), "--work-dir", wd, "--train",
                str(LEARN_TRAIN), "--val", str(LEARN_VAL), "--log-interval",
                str(LEARN_LOG), "--out", md, "--png",
                os.path.join(tmp, "curve.png"), "--cfg-options",
                *LEARN_OPTS], "learning_run", phase="learning")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = read_launches()
        held = hold_captured(store, "learning", k1=12, k2=6, shapes=[
            ("K1", (8, *FLAGSHIP_MAP)), ("K2", (8, *FLAGSHIP_MAP)),
            ("K1", (1, *FLAGSHIP_MAP))])
        grid = hold_on_grid(store, "learning", 25)
        del store
        recs = read_scalars(os.path.join(wd, "scalars.jsonl"))
        report = open(md).read()
        h = hashlib.sha256()
        with open(os.path.join(wd, f"ckpt_{LEARN_ITERS}"), "rb") as f:
            h.update(f.read())
        info = json.load(open(os.path.join(wd, "run_info.json")))
        png = os.path.exists(os.path.join(tmp, "curve.png"))
    train = [r for r in recs if "total" in r]
    check([r["step"] for r in train]
          == list(range(LEARN_LOG, LEARN_ITERS + 1, LEARN_LOG)),
          f"(learning) logged steps {[r['step'] for r in train]}")
    check(all(np.isfinite(v) for r in train for v in r.values()),
          "(learning) a logged value is not finite")
    val = [r for r in recs if "mIoU" in r]
    check([r["step"] for r in val]
          == list(range(LEARN_LOG, LEARN_ITERS + 1, LEARN_LOG)),
          f"(learning) vals {val}")
    section = report.split("## Val mIoU trace", 1)[1].split("\n## ", 1)[0]
    rows = [line for line in section.splitlines()
            if line.startswith("| ") and line != "| step | mIoU |"]
    want_rows = [f"| {r['step']} | {r['mIoU']:.2f} |" for r in val]
    check(rows == want_rows, f"(learning) report's val rows {rows}, "
          f"scalars {want_rows}")
    check(f"`ckpt_{LEARN_ITERS}` sha256 `{h.hexdigest()}`" in report,
          f"(learning) the report's hash is not ckpt_{LEARN_ITERS}'s "
          f"{h.hexdigest()}")
    k1, k2 = 6 * (LEARN_ITERS + LEARN_VAL * len(val)), 6 * LEARN_ITERS
    # the threefry kernel draws the initial weights, the steps nothing
    want = dict(k1=k1, k2=k2, k1_bf16=k1, k2_bf16=k2, grouped=(0, 0),
                grouped_bf16=(0, 0), threefry=drawn_entries(build_model(
                    get_config(PRESET, INIT_OPTS).model)))
    check(launches == want, f"(learning) launches {launches}, want {want}")
    log("learning", f"{wall:.1f}s in all; s/iter by log record "
        f"{[round(r['sec_per_iter'], 4) for r in train]}, loss "
        f"{[round(r['total'], 4) for r in train]}, val mIoU "
        f"{[r['mIoU'] for r in val]}, peak {info.get('peak_gib', 0):.3f} "
        f"GiB; report card line {info['card']!r}, PNG written: {png}; "
        f"bf16 K1/K2 launches {launches['k1_bf16']}/"
        f"{launches['k2_bf16']}; the largest share of non-zero DCN mask "
        f"spikes in a K1 call {max(shares):.4g} on {smi}")
    return dict(launches=launches, wall=wall, train=train, val=val,
                held=dict(k1=max(held["k1"], grid["k1"]),
                          k2=max(held["k2"], grid["k2"])))


# (init): the learning run's recipe (bf16, batch 8, 512x512, 30 classes,
# lr 6e-4 after 300 warm-up iterations of 1000) from flax's laws
INIT_OPTS = [*learning_run.OPTIONS, "model.num_classes=30",
             "train.total_iters=1000"]
INIT_STEPS = 10
INIT_STD_RTOL = 0.02    # the five largest random entries' std, their laws'


def phase_init(smi: str) -> dict:
    """(init): the flagship at full width from ``init_weights_`` (flax's
    laws, ``train.seed`` 0; ``api.init_trainer`` without weights) with the
    learning run's recipe: every constant of the laws exactly (the DCN
    offset and mask kernels 0, the gammas 1e-6, BN scales 1 and
    statistics 0 and 1), the std of the five largest random entries
    within 2% of their laws'; ``INIT_STEPS`` steps through the bf16 K1
    and K2 (6 launches each a step), every loss finite; the share of
    non-zero DCN mask spikes per layer at steps 1 and ``INIT_STEPS`` and
    the first step with one, if any; the first step's K1 and K2 calls held
    to their plain versions, and again on their grids (``hold_on_grid``:
    the DCN branch is silent at flax's init, its outputs zero)."""
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    zero_launches()
    tr = api.init_trainer(PRESET, INIT_OPTS)
    torch.cuda.synchronize()
    init_launches = read_launches()
    model, cfg = tr.state.model, tr.cfg
    drawn = drawn_entries(model)
    check(init_launches == dict(k1=0, k2=0, k1_bf16=0, k2_bf16=0,
                                grouped=(0, 0), grouped_bf16=(0, 0),
                                threefry=drawn),
          f"(init) the init's launches {init_launches}, want {drawn} "
          f"threefry")
    digest = hold_init_digest(model, "init")
    check((cfg.data.batch_size, tuple(cfg.data.crop_size), cfg.model.dtype,
           cfg.model.num_classes) == (8, (512, 512), "bfloat16", 30),
          f"(init) recipe {cfg.data.batch_size} {cfg.data.crop_size} "
          f"{cfg.model.dtype} {cfg.model.num_classes}")
    laws, sd = init_laws(model), model.state_dict()
    consts = [k for k, law in laws.items() if law.kind == "constant"]
    for k in consts:
        check(bool((sd[k] == laws[k].scale).all()),
              f"(init) {k} is not the constant {laws[k].scale}")
    dcn = "head.pixel_decoder.encoder_0."
    check(not sd[dcn + "dcn.offset_conv.weight"].any()
          and not sd[dcn + "dcn.mask_conv.weight"].any()
          and bool((sd[dcn + "gamma2"] == 1e-6).all()),
          "(init) the DCN kernels or gammas are not flax's")
    big = sorted((k for k in laws if laws[k].kind != "constant"),
                 key=lambda k: -sd[k].numel())[:5]
    ratios = {k: float(sd[k].double().std()) / laws[k].std for k in big}
    check(all(abs(r - 1.0) <= INIT_STD_RTOL for r in ratios.values()),
          f"(init) std against the law {ratios}")
    b, hw = cfg.data.batch_size, tuple(cfg.data.crop_size)
    rng = np.random.default_rng(22)
    batches = [synthetic_batch(rng, b, hw, num_classes=30) for _ in range(2)]
    per_step, totals, store = [], [], {}
    torch.cuda.synchronize()
    zero_launches()
    t = time.perf_counter()
    for step in range(1, INIT_STEPS + 1):
        batch = batches[step % 2]
        shares = []
        with mask_shares(shares), (capture_dcn(store) if step == 1
                                   else contextlib.nullcontext()):
            m = api.train_steps(tr, [batch])[0]
        check(np.isfinite(m["total"]) and np.isfinite(m["grad_norm"]),
              f"(init) step {step}: {m}")
        per_step.append(shares)
        totals.append(m["total"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = read_launches()
    k = 6 * INIT_STEPS
    want = dict(k1=k, k2=k, k1_bf16=k, k2_bf16=k, grouped=(0, 0),
                grouped_bf16=(0, 0), threefry=0)
    check(launches == want, f"(init) launches {launches}, want {want}")
    held = hold_captured(store, "init", k1=6, k2=6, shapes=[
        ("K1", (b, *FLAGSHIP_MAP)), ("K2", (b, *FLAGSHIP_MAP))])
    grid = hold_on_grid(store, "init", 22)
    del store
    fired = next((i + 1 for i, sh in enumerate(per_step) if any(sh)), None)
    log("init", f"JAX's model.init(PRNGKey(0)) at full width: "
        f"{digest['entries']} entries held to its digest (largest sample "
        f"gap {digest['worst_ulp']:.3g} ulp), drawn by {drawn} threefry "
        f"launches; {len(consts)} constant "
        f"entries exact, std/law of the five largest random entries "
        f"{ {k: round(r, 5) for k, r in ratios.items()} }; non-zero DCN "
        f"mask spikes per layer at step 1 {per_step[0]}, at step "
        f"{INIT_STEPS} {per_step[-1]}, first non-zero at step {fired}; "
        f"totals {[round(x, 4) for x in totals]}; {INIT_STEPS} steps in "
        f"{wall:.1f}s ({time.perf_counter() - t0:.1f}s with the build); "
        f"bf16 K1/K2 launches {launches['k1_bf16']}/"
        f"{launches['k2_bf16']} on {smi}")
    del tr, model
    return dict(launches=launches, init_launches=init_launches,
                fired_at=fired, shares=per_step, totals=totals,
                ratios=ratios,
                held=dict(k1=max(held["k1"], grid["k1"]),
                          k2=max(held["k2"], grid["k2"])))


# (jax random): the shapes of the kernel's checks (0-d, odd, 3-d, and the
# FPN-19M step's dropout draw [T, B, H/4, W/4, C] = 4x6x128x128x128) and
# the blocks of one axis held to the slice of the whole draw (the last:
# a data-parallel rank's 2 of the batch's 6 rows)
JR_SHAPES = ((), (7,), (3, 5, 2), (4, 6, 128, 128, 128))
JR_BLOCKS = (((7,), 0, 2, 5), ((3, 5, 2), 1, 1, 4), ((3, 5, 2), -1, 1, 2),
             ((4, 6, 128, 128, 128), 1, 2, 4),
             ((4, 6, 128, 128, 128), 3, 40, 104))
JR_KEY = (2716826189, 292468403)    # jax.random.fold_in(PRNGKey(0), 7)
JR_KEEP = 0.9                       # the FPN head's keep probability
# threefry2x32's known-answer vectors (Random123): (key, counter, output)
THREEFRY_KAT = (((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
                ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
                 (0x1CB996FC, 0xBB002BE7)),
                ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
                 (0xC4923A9C, 0x483DF7A0)))
# values of jax.random (jax 0.9.0, CPU, jax_threefry_partitionable on) and
# flax 0.12.3, each beside the call that made it; floats as float32 bits
JAX_KEYS = {
    "PRNGKey(42)": ((0, 42), lambda: jr.key(42)),
    "fold_in(PRNGKey(0), 1)": ((928981903, 3453687069),
                               lambda: jr.fold_in(jr.key(0), 1)),
    "fold_in(PRNGKey(0), 7)": (JR_KEY, lambda: jr.fold_in(jr.key(0), 7)),
    "split(PRNGKey(42), 3)[2]": ((2465931498, 255383827),
                                 lambda: jr.split(jr.key(42), 3)[2]),
    "LazyRng.create(PRNGKey(0), 'backbone', 'Conv_0', 1).as_jax_rng()": (
        (1286269754, 3917951290),
        lambda: jr.fold_in_static(jr.key(0), ("backbone", "Conv_0", 1))),
}
JAX_DRAWS = {
    "bits(PRNGKey(1), (4,))": (
        (0x704A38B7, 0x88A4083E, 0x7227B57A, 0x703ABFF1),
        lambda d: jr.bits(jr.key(1), (4,), device=d)),
    "uniform(PRNGKey(0), (5,))": (
        (0x3F729A4E, 0x3F7A8436, 0x3EAA221C, 0x3EEFF550, 0x3F11E43A),
        lambda d: jr.uniform(jr.key(0), (5,), device=d)),
    "uniform(PRNGKey(3), (2, 3), minval=-1.0, maxval=1.0)": (
        (0xBF5A15C8, 0x3F605474, 0x3E988830, 0x3F738498, 0xBEE2F0F0,
         0x3E29DB70),
        lambda d: jr.uniform(jr.key(3), (2, 3), -1.0, 1.0, device=d)),
    "bernoulli(PRNGKey(7), 0.9, (16,))": (
        (1, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 1),
        lambda d: jr.bernoulli(jr.key(7), 0.9, (16,), device=d)),
    "normal(PRNGKey(0), (4,))": (
        (0x3FCFB2BD, 0x40019DF0, 0xBEDE0017, 0xBDA10222),
        lambda d: jr.normal(jr.key(0), (4,), device=d)),
    "truncated_normal(PRNGKey(5), -2.0, 2.0, (4,))": (
        (0xBDA4EAA0, 0x3FA54F1F, 0x3F1916AB, 0xBF9AA2DC),
        lambda d: jr.truncated_normal(jr.key(5), -2.0, 2.0, (4,), device=d)),
}
# the hash's 32-bit operations an element: 20 rounds of add, rotate, xor,
# 5 key injections of 3 adds, 2 initial adds, the xor of the two words and
# 3 to make the float (shift, or, subtract) and compare or scale it
THREEFRY_OPS = 20 * 3 + 5 * 3 + 2 + 1 + 4
F32_OPS_PER_S = 67e12   # H100 SXM float32 outside the tensor cores
INIT_DIGEST = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "jax_init_digest.json")
NORMAL_ULP = 2          # normal-law entries: units in the last place


def as_bits(t: torch.Tensor) -> list[int]:
    """A draw's values as ints: float32 bits, a mask's 0/1, bits as is."""
    t = t.detach().cpu().reshape(-1)
    if t.dtype == torch.float32:
        t = t.view(torch.int32).long() & jr.MASK
    return [int(v) for v in t]


def sample_indices(numel: int) -> np.ndarray:
    """``tests/torch_init_digest.py:sample_indices``."""
    return np.unique(np.linspace(0, numel - 1, 16).round().astype(np.int64))


def hold_init_digest(model: torch.nn.Module, tag: str) -> dict:
    """``model``'s state (the flagship with (init)'s options, drawn from
    seed 0) against ``tests/jax_init_digest.json``, JAX's ``model.init(
    PRNGKey(0))`` entry by entry: the shape, 16 sampled elements bitwise
    (normal-law entries within ``NORMAL_ULP`` of the unit draw), the
    float64 sum within 2^-20 of sqrt(n sum of squares) and the sum of
    squares within 2^-20 of itself (each element off by at most a few
    ulp).  Returns the counts and the largest gap in ulp."""
    with open(INIT_DIGEST) as f:
        want = json.load(f)
    check((want["preset"], want["seed"]) == (PRESET, 0),
          f"({tag}) digest of {want['preset']} seed {want['seed']}")
    laws, sd = init_laws(model), model.state_dict()
    check(set(sd) == set(want["entries"]),
          f"({tag}) entries {sorted(set(sd) ^ set(want['entries']))[:8]}")
    exact, worst, fails = 0, 0.0, []
    for key, w in want["entries"].items():
        t = sd[key].detach().float()
        if list(t.shape) != w["shape"]:
            fails.append(f"{key}: shape {list(t.shape)} != {w['shape']}")
            continue
        flat = t.reshape(-1)
        got = flat[torch.from_numpy(sample_indices(flat.numel())).to(
            flat.device)].cpu().numpy()
        ws = np.float32(w["samples"])
        x = flat.double()
        s, ss = float(x.sum()), float((x * x).sum())
        scale = math.sqrt(flat.numel() * max(w["sumsq"], 1e-300))
        sums_ok = (abs(s - w["sum"]) <= 2 ** -20 * scale
                   and abs(ss - w["sumsq"]) <= 2 ** -20 * w["sumsq"])
        if np.array_equal(got, ws) and sums_ok:
            exact += float(s == w["sum"] and ss == w["sumsq"])
            continue
        law = laws[key]
        gap = float((np.abs(got.astype(np.float64) - ws) / np.spacing(
            np.float32(law.factor) * np.maximum(np.abs(ws / law.factor),
                                                np.float32(1e-30)))).max())
        worst = max(worst, gap)
        if not sums_ok or law.kind not in ("normal", "truncated_normal") \
                or gap > NORMAL_ULP:
            fails.append(f"{key} ({law.kind}): samples off by {gap:.3g} "
                         f"ulp, sum {s} / {w['sum']}, sumsq {ss} / "
                         f"{w['sumsq']}")
    check(not fails, f"({tag}) not JAX's model.init: " + "; ".join(
        fails[:6]) + f" ({len(fails)} entries)")
    return dict(entries=len(sd), exact_sums=int(exact), worst_ulp=worst)


def phase_jax_random(smi: str) -> dict:
    """(jax random): ``csrc/threefry.cu`` against its plain version
    (``utils/jax_random.py``, run on the card) bitwise: bits, uniforms on
    [0, 1) and [-1, 1) and keep masks for every ``JR_SHAPES`` shape, and
    each ``JR_BLOCKS`` block equal to the slice of the whole draw;
    threefry2x32's known-answer vectors (host, plain and the kernel's
    element 0 of key (0, 0)); recorded ``jax.random`` and flax keys and
    draws; the kernel's mask and uniform times at the 50 M-element draw
    beside ``torch.rand`` of the shape and the plain version, and its
    bound; the flagship's full-width ``init_weights_(seed=0)`` drawn on
    the card, timed and held to JAX's ``model.init`` digest."""
    dev = torch.device("cuda")
    kt = jr.threefry_kernel
    before = kt.launches
    for k, ctr, want in THREEFRY_KAT:
        x0, x1 = jr.threefry2x32(k, torch.tensor([ctr[0]], device=dev),
                                 torch.tensor([ctr[1]], device=dev))
        check(jr.threefry2x32_block(k, *ctr) == want
              and (int(x0), int(x1)) == want,
              f"(jax random) threefry2x32 {k} {ctr}: {int(x0):#x} "
              f"{int(x1):#x}, want {want}")
    first = int(jr.bits((0, 0), (1,), device=dev)[0])
    check(first == 0x6B200159 ^ 0x99BA4EFE,
          f"(jax random) kernel's bits of key (0, 0) at 0: {first:#x}")
    for call, (want, fn) in JAX_KEYS.items():
        check(tuple(fn()) == tuple(want), f"(jax random) {call}: {fn()}")
    for call, (want, fn) in JAX_DRAWS.items():
        for d in ("cpu", dev):
            got = as_bits(fn(d))
            check(got == list(want), f"(jax random) {call} on {d}: "
                  f"{[hex(v) for v in got]}")
    k = JR_KEY
    checked, err = 0, 0.0
    for shape in JR_SHAPES:
        pairs = [(jr.bits(k, shape, device=dev),
                  jr.bits_reference(k, shape, device=dev)),
                 (jr.uniform(k, shape, device=dev),
                  jr.uniform_reference(k, shape, device=dev)),
                 (jr.uniform(k, shape, -1.0, 1.0, device=dev),
                  jr.uniform_reference(k, shape, -1.0, 1.0, device=dev)),
                 (jr.bernoulli(k, JR_KEEP, shape, device=dev),
                  jr.bernoulli_reference(k, JR_KEEP, shape, device=dev))]
        torch.cuda.synchronize()
        for got, want in pairs:
            check(got.shape == want.shape and torch.equal(got, want),
                  f"(jax random) kernel != plain at {shape}")
            checked += want.numel()
            if want.numel():
                err = max(err, float((got.double() - want.double()).abs()
                                     .max()))
        del pairs
    for shape, axis, start, stop in JR_BLOCKS:
        index = [slice(None)] * len(shape)
        index[axis] = slice(start, stop)
        blk = dict(axis=axis, start=start, stop=stop, device=dev)
        for mode in ("bits", "uniform", "mask"):
            draw = {"bits": lambda **b: jr.bits(k, shape, **b),
                    "uniform": lambda **b: jr.uniform(k, shape, **b),
                    "mask": lambda **b: jr.bernoulli(k, JR_KEEP, shape,
                                                     **b)}[mode]
            whole = draw(device=dev)
            part = draw(**blk)
            check(torch.equal(part, whole[tuple(index)]),
                  f"(jax random) {mode} block {axis} [{start}, {stop}) of "
                  f"{shape} is not the slice of the whole draw")
            del whole, part
    torch.cuda.synchronize()
    launches_checked = kt.launches - before
    big = JR_SHAPES[-1]
    n = math.prod(big)
    times = dict(
        mask_ms=cuda_ms(lambda: jr.bernoulli(k, JR_KEEP, big, device=dev),
                        iters=20),
        uniform_ms=cuda_ms(lambda: jr.uniform(k, big, device=dev),
                           iters=20),
        plain_mask_ms=cuda_ms(lambda: jr.bernoulli_reference(
            k, JR_KEEP, big, device=dev), iters=3, warmup=1),
        plain_uniform_ms=cuda_ms(lambda: jr.uniform_reference(
            k, big, device=dev), iters=3, warmup=1),
        torch_rand_ms=cuda_ms(lambda: torch.rand(big, device=dev),
                              iters=20),
        bytes_ms=n / HBM_BYTES_PER_S * 1e3,
        ops_ms=n * THREEFRY_OPS / F32_OPS_PER_S * 1e3,
        uniform_bytes_ms=4 * n / HBM_BYTES_PER_S * 1e3)
    torch.cuda.empty_cache()
    cfg = get_config(PRESET, INIT_OPTS).model
    model = build_model(cfg).to(dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    init_weights_(model, 0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    held = hold_init_digest(model, "jax random")
    del model
    torch.cuda.empty_cache()
    log("jax random", f"threefry2x32 known answers, {len(JAX_KEYS)} keys "
        f"and {len(JAX_DRAWS)} draws of jax.random reproduced; "
        f"csrc/threefry.cu bitwise equal to the plain version over "
        f"{checked} elements of {len(JR_SHAPES)} shapes (bits, uniforms, "
        f"masks) and {len(JR_BLOCKS)} axis blocks ({launches_checked} "
        f"launches); at {big} ({n} elements): mask "
        f"{times['mask_ms']:.5f} ms (plain {times['plain_mask_ms']:.3f}), "
        f"uniform {times['uniform_ms']:.5f} ms (plain "
        f"{times['plain_uniform_ms']:.3f}), torch.rand "
        f"{times['torch_rand_ms']:.5f} ms; bound mask "
        f"{max(times['bytes_ms'], times['ops_ms']):.5f} ms (bytes "
        f"{times['bytes_ms']:.5f}, ops {times['ops_ms']:.5f}), uniform "
        f"{max(times['uniform_bytes_ms'], times['ops_ms']):.5f} ms; the "
        f"flagship's init_weights_(seed=0) on the card in {init_s:.3f} s: "
        f"JAX's model.init over {held['entries']} entries (sums exact in "
        f"{held['exact_sums']}, largest sample gap {held['worst_ulp']:.3g} "
        f"ulp) on {smi}")
    return dict(times=times, init_s=init_s, held=held, max_abs_err=err)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cudnn.benchmark = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log("device", f"{kind} | {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | devices {torch.cuda.device_count()}")

    t = time.perf_counter()
    # the four nvcc processes leave half the cores to (bf16 tiny)'s CPU
    # side; it is joined before anything is timed
    threads = torch.get_num_threads()
    with ThreadPoolExecutor(1) as pool:
        try:
            cpu_ref = pool.submit(bf16_tiny_cpu, max(1, threads // 2))
            cuda_build.build_all((*dcnv3.SOURCES, jr.SOURCE))
            dcnv3.build_kernels()
            jr.build_kernel()
            built = time.perf_counter() - t
            bf16_tiny_ref = cpu_ref.result()
        finally:
            torch.set_num_threads(threads)
    sources = (dcnv3.SOURCE, dcnv3.BWD_SOURCE, dcnv3.GROUPED_SOURCE,
               dcnv3.GROUPED_BWD_SOURCE, jr.SOURCE)
    log("build", f"{', '.join(sources)} built in {built:.1f}s; "
        f"(bf16 tiny)'s CPU side beside it, done at "
        f"{time.perf_counter() - t:.1f}s")
    for src in sources:
        lib = cuda_build.library_path(src)
        for line in (lib.parent / "build.log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log("build", f"{src}: {line.strip()}")

    gen = torch.Generator().manual_seed(0)
    k = phase_kernel(gen)
    k2 = phase_backward_kernel(gen)
    grad_err = phase_core_autograd(gen)
    gk = phase_grouped(gen)
    kb = phase_bf16_kernels(gen)
    gb = phase_grouped_bf16(gen)
    t = time.perf_counter()
    kr = phase_k1_rows(gen)
    log("k1 rows", f"the phase took {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    jrd = phase_jax_random(smi)
    log("jax random", f"the phase took {time.perf_counter() - t:.1f}s")

    t = time.perf_counter()
    im = drawn_model(PRESET, seed=0)
    log("serve", f"flagship {PRESET} built at full width in "
        f"{time.perf_counter() - t:.1f}s")
    s = phase_serve(im)
    log("timing", f"median request_ms={s['request_ms']:.3f} (max "
        f"{s['max_ms']:.3f}, n={s['n']}) peak_mem_gib={s['peak_gib']:.3f} "
        f"on {smi}")
    tf = phase_tf32(im)
    for mode in ("default", "tf32"):
        log("tf32", f"{mode} vs f32 over the 3 images: least class "
            f"agreement {min(a for a, _ in tf[mode]):.6f}, largest logit "
            f"difference {max(d for _, d in tf[mode]):.6g}; tiny model vs "
            f"CPU {tf['tiny_' + mode]:.6g} (f32: {tf['tiny_f32']:.6g})")
    err = phase_small_reference()
    log("reference", f"tiny model 64x64 card vs CPU max|diff|={err:.3g} "
        f"(tol {MODEL_TOL})")
    ev = phase_eval(im)
    fi = phase_firing(smi)
    tt = phase_tta(im, smi)
    sv = phase_serving(im, gen, smi)
    tl_ = phase_tools(im, smi)
    bs = phase_bf16_serve(im)
    log("bf16 serve", f"median request_ms={bs['request_ms']:.3f} (max "
        f"{bs['max_ms']:.3f}, n={bs['n']}) peak_mem_gib={bs['peak_gib']:.3f}"
        f" against f32 {s['request_ms']:.3f}; K1 bf16 launches "
        f"{bs['launches']['k1_bf16']} over 3 requests; least class agreement "
        f"with f32 {bs['agreement']:.6f}, largest logit gap {bs['gap']:.6g} "
        f"on {smi}")
    del im
    torch.cuda.empty_cache()

    tr = phase_train()
    log("train", f"auction (preset default): median step_ms="
        f"{tr['step_ms']:.3f} (max {tr['max_ms']:.3f}, n={tr['n']}) "
        f"peak_mem_gib={tr['peak_gib']:.3f} repaired_gt per step "
        f"{tr['repaired']} on {smi}")
    auc = phase_auction(tr["costs"])
    ov = phase_overflow(tr["trainer"], tr["batches"][0])
    del tr["trainer"], tr["costs"], tr["batches"]
    torch.cuda.empty_cache()
    pt = phase_point_train(tr, smi)
    torch.cuda.empty_cache()
    pr = phase_presets(gen, smi)
    torch.cuda.empty_cache()
    host = phase_host_train()
    log("train", f"host matcher: median step_ms={host['step_ms']:.3f} (max "
        f"{host['max_ms']:.3f}, n={host['n']}) peak_mem_gib="
        f"{host['peak_gib']:.3f} on {smi}; auction/host step ms "
        f"{tr['step_ms'] / host['step_ms']:.3f}")
    t_err = phase_small_train()
    log("train", f"tiny model 3 steps card vs CPU max rel|diff| of total: "
        f"auction {t_err['auction']:.3g}, host {t_err['host']:.3g} "
        f"(tol {TRAIN_RTOL})")
    torch.cuda.empty_cache()
    bt = phase_bf16_train()
    for tag in ("bf16", "bf16+remat+packed"):
        r = bt[tag]
        log("bf16 train", f"{tag}: median step_ms={r['step_ms']:.3f} (max "
            f"{r['max_ms']:.3f}, n={r['n']}) peak_mem_gib="
            f"{r['peak_gib']:.3f}; K1/K2 bf16 launches "
            f"{r['launches']['k1_bf16']}/{r['launches']['k2_bf16']} over "
            f"{BF16_WARMUP + BF16_TIMED} steps; f32 step_ms "
            f"{tr['step_ms']:.3f} on {smi}")
    bty = phase_bf16_tiny(bf16_tiny_ref)
    torch.cuda.empty_cache()
    cli = phase_train_cli(tr["step_ms"], smi)
    ref = phase_reference()
    v3 = {}
    for variant in V3_PRESETS:
        v3[variant] = phase_v3(variant, gen, smi)
        torch.cuda.empty_cache()
        log(variant, f"request {v3[variant]['req_ms']:.3f} ms against the "
            f"flagship's {s['request_ms']:.3f}; step "
            f"{v3[variant]['step_ms']:.3f} ms against the flagship's "
            f"{tr['step_ms']:.3f} on {smi}")
    pan = phase_panoptic(smi)
    torch.cuda.empty_cache()
    var = {}
    for name in VARIANTS:
        var[name] = phase_variant(name, smi)
        torch.cuda.empty_cache()
    t_fpn = time.perf_counter()
    fpn = phase_fpn(smi)
    fpn_train = phase_fpn_train(smi)
    fam = phase_fpn_family(smi)
    log("fpn family", f"the FPN phases took {time.perf_counter() - t_fpn:.1f}"
        f"s; {FPN_PRESET} request {fpn['req_ms']:.3f} ms against the "
        f"flagship's {s['request_ms']:.3f}, step {fpn_train['step_ms']:.3f} "
        f"ms at batch {fpn_train['batch']} against the flagship's "
        f"{tr['step_ms']:.3f} on {smi}")
    t_new = time.perf_counter()
    fb = phase_fpn_bf16(smi)
    dd = phase_ddd17(smi)
    de = phase_deformable(smi)
    log("deformable", f"(fpn bf16), (ddd17) and (deformable) took "
        f"{time.perf_counter() - t_new:.1f}s; {FPN_PRESET} at bf16: request "
        f"{fb['req_ms']['bf16']:.3f} ms against f32 "
        f"{fb['req_ms']['f32']:.3f}, step {fb['step_ms']['bf16']:.3f} ms "
        f"against {fb['step_ms']['f32']:.3f}, peaks "
        f"{fb['step_peak']['bf16']:.3f} / {fb['step_peak']['f32']:.3f} GiB "
        f"on {smi}")
    t_new = time.perf_counter()
    dp = phase_distributed(smi)
    torch.cuda.empty_cache()
    lib = phase_library(smi)
    log("library", f"(distributed) and (library) took "
        f"{time.perf_counter() - t_new:.1f}s")
    torch.cuda.empty_cache()
    par = phase_tp_spatial(smi)
    torch.cuda.empty_cache()
    sfam = phase_spatial_families(smi)
    torch.cuda.empty_cache()
    t_new = time.perf_counter()
    bu = phase_burnin(smi)
    torch.cuda.empty_cache()
    le = phase_learning(smi)
    torch.cuda.empty_cache()
    ini = phase_init(smi)
    log("init", f"(burnin), (learning) and (init) took "
        f"{time.perf_counter() - t_new:.1f}s")

    # the main path's launches: serve, the three eval modes, the train
    # steps at the defaults, the overflow step, the host-matcher steps,
    # the train CLI's two runs and the eval CLI on its best checkpoint,
    # the firing CLI, the TTA requests and the Inferencer, the point-loss
    # steps, the Cityscapes and COCO-Stuff eval CLIs and the Cityscapes
    # steps, ..., the FPN family's paths in f32 and bf16, the DDD17 eval
    # and train CLIs, each counted from 0 just before it
    paths = [ev[mode]["launches"] for mode in EVAL_MODES] + [
        tr["launches"], ov["launches"], host["launches"], *cli["launches"],
        fi["launches"], tt["launches"], tt["inf_launches"], pt["launches"],
        pr[CITYSCAPES]["launches"], pr[COCO_STUFF]["launches"],
        pr["train"]["launches"], sv["launches"], sv["seq_launches"],
        sv["loop_launches"], tl_["export_launches"],
        *(v3[v]["req_launches"] for v in V3_PRESETS),
        *(v3[v]["launches"] for v in V3_PRESETS),
        pan["eval_launches"], pan["cli_launches"],
        *(var[n]["req_launches"] for n in VARIANTS),
        *(var[n]["launches"] for n in VARIANTS),
        fpn["launches"], fpn_train["launches"], *fam["launches"],
        *fb["launches"], *dd["launches"], *dp["launches"],
        *par["launches"], *sfam["launches"]]
    k1_launches = s["launches"] + sum(p["k1"] for p in paths)
    k2_launches = sum(p["k2"] for p in paths)
    grouped = [s["grouped"][i] + sum(p["grouped"][i] for p in paths)
               for i in (0, 1)]
    grouped_bf16 = [s["grouped_bf16"][i]
                    + sum(p["grouped_bf16"][i] for p in paths)
                    for i in (0, 1)]
    # the bf16 paths: the bf16 requests, both bf16 train runs, (burnin),
    # (learning) and (init)
    bf16_paths = [bs["launches"], bt["bf16"]["launches"],
                  bt["bf16+remat+packed"]["launches"], *par["launches"],
                  *sfam["launches"], bu["launches"], le["launches"],
                  ini["launches"]]
    k1_bf16 = sum(p["k1_bf16"] for p in bf16_paths)
    k2_bf16 = sum(p["k2_bf16"] for p in bf16_paths)
    # the threefry kernel on every path above (each counted once), and the
    # (init) phase's init_trainer, whose weights it draws
    counted = {id(p): p for p in paths + bf16_paths}
    threefry_launches = (sum(p["threefry"] for p in counted.values())
                         + ini["init_launches"]["threefry"])

    def row(name, source, tpu_name, launches, max_abs_err, t):
        return dict(
            name=name, route="cuda",
            source=f"spike2former_tpu_torch/csrc/{source}",
            replaces="spike2former_tpu/ops/pallas/dcnv3_kernel.py:"
                     f"{TPU_LINE[tpu_name]}",
            launches=launches, max_abs_err=max_abs_err, ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=max(t["bytes_ms"], t["ops_ms"]),
            bound_by=("bytes" if t["bytes_ms"] >= t["ops_ms"]
                      else "operations"),
            library_ms=t["library_ms"])

    # K1 and K3-K6 at the serve shape, K2 and K7 at the train shape
    k1_path_err = max(s["max_abs_err"], fi["held"]["k1"], tt["held"]["k1"],
                      pt["held"]["k1"], pr["k1_err"], sv["held"]["k1"],
                      *(v3[v]["held"]["k1"] for v in V3_PRESETS),
                      *(var[n]["held"]["k1"] for n in VARIANTS),
                      dp["held"]["k1"], kr["max_abs_err"], par["k1_err"],
                      sfam["k1_err"])
    k2_path_err = max(pt["held"]["k2"], pr["k2_err"],
                      *(v3[v]["held"]["k2"] for v in V3_PRESETS),
                      *(var[n]["held"]["k2"] for n in VARIANTS),
                      dp["held"]["k2"])
    kernels = [
        row("dcnv3_sample", dcnv3.SOURCE, "dcnv3_sample_pallas_t5",
            k1_launches, max(k["max_abs_err"], k1_path_err), k[1]),
        row("dcnv3_sample_bwd", dcnv3.BWD_SOURCE,
            "dcnv3_sample_pallas_t5_bwd", k2_launches,
            max(k2["max_abs_err"], grad_err, k2_path_err), k2)]
    for name, (_, layout) in GROUPED_FORWARD.items():
        kernels.append(row(
            f"dcnv3_sample_grouped[{layout}] ({name})", dcnv3.GROUPED_SOURCE,
            name, grouped[0], gk["errs"][name], gk["times"][name, "serve"]))
    kernels.append(row(
        f"dcnv3_sample_grouped_bwd ({GROUPED_BACKWARD})",
        dcnv3.GROUPED_BWD_SOURCE, GROUPED_BACKWARD, grouped[1],
        gk["errs"][GROUPED_BACKWARD],
        gk["times"][GROUPED_BACKWARD, "train"]))
    # the bf16 forms: K1 at the serve shape, K2 at the train shape
    kernels.append(row("dcnv3_sample[bf16]", dcnv3.SOURCE,
                       "dcnv3_sample_pallas_t5", k1_bf16,
                       max(kb["k1_err"], kr["bf16_err"],
                           sfam["k1_bf16_err"], bu["held"]["k1"],
                           le["held"]["k1"], ini["held"]["k1"]),
                       kb["k1", 1]))
    kernels.append(row("dcnv3_sample_bwd[bf16]", dcnv3.BWD_SOURCE,
                       "dcnv3_sample_pallas_t5_bwd", k2_bf16,
                       max(kb["k2_err"], bu["held"]["k2"],
                           le["held"]["k2"], ini["held"]["k2"]),
                       kb["k2", 6]))
    # the bf16 forms of K3-K7: the forwards at the serve shape, K7 at the
    # train shape
    for name, (_, layout) in GROUPED_FORWARD.items():
        kernels.append(row(
            f"dcnv3_sample_grouped[{layout},bf16] ({name})",
            dcnv3.GROUPED_SOURCE, name, grouped_bf16[0], gb["errs"][name],
            gb["times"][name, "serve"]))
    kernels.append(row(
        f"dcnv3_sample_grouped_bwd[bf16] ({GROUPED_BACKWARD})",
        dcnv3.GROUPED_BWD_SOURCE, GROUPED_BACKWARD, grouped_bf16[1],
        gb["errs"][GROUPED_BACKWARD],
        gb["times"][GROUPED_BACKWARD, "train"]))
    jt = jrd["times"]
    kernels.append(dict(
        name="threefry", route="cuda",
        source=f"spike2former_tpu_torch/csrc/{jr.SOURCE}",
        replaces="spike2former_tpu/models/fpn.py:144",
        launches=threefry_launches, max_abs_err=jrd["max_abs_err"],
        ms=jt["mask_ms"], plain_ms=jt["plain_mask_ms"],
        bound_ms=max(jt["bytes_ms"], jt["ops_ms"]),
        bound_by="bytes" if jt["bytes_ms"] >= jt["ops_ms"] else "operations",
        library_ms=None))
    log("summary", f"K1 launches: serve {s['launches']}, eval "
        f"{[ev[m]['launches']['k1'] for m in EVAL_MODES]}, train "
        f"{tr['launches']['k1']}, overflow {ov['launches']['k1']}, host "
        f"{host['launches']['k1']}; K2: train {tr['launches']['k2']}, "
        f"overflow {ov['launches']['k2']}, host {host['launches']['k2']}; "
        f"train CLI K1/K2 {[(n['k1'], n['k2']) for n in cli['launches']]}; "
        f"reference CLI max|diff| {ref['err']:.3g}; auction "
        f"{auc['ms']:.3f} ms; bf16 K1 launches {k1_bf16}, K2 {k2_bf16}; "
        f"bf16 tiny card vs CPU gap {bty['gap']:.3g}, train rel "
        f"{bty['train_rel']:.3g}; firing K1 {fi['launches']['k1']} "
        f"(4 images), TTA K1 {tt['launches']['k1']} (3 requests of 6 "
        f"variants), Inferencer K1 {tt['inf_launches']['k1']}, point steps "
        f"K1/K2 {pt['launches']['k1']}/{pt['launches']['k2']}, Cityscapes "
        f"eval K1 {pr[CITYSCAPES]['launches']['k1']}, COCO-Stuff eval K1 "
        f"{pr[COCO_STUFF]['launches']['k1']}, Cityscapes steps K1/K2 "
        f"{pr['train']['launches']['k1']}/{pr['train']['launches']['k2']}; "
        f"K1/K2 at the Cityscapes shapes (ms, bound ms) "
        + "; ".join(f"{kn} {sh}: {t['ms']:.5f}, "
                    f"{max(t['bytes_ms'], t['ops_ms']):.5f}"
                    for (kn, sh), t in pr["times"].items())
        + f"; serving K1 {sv['launches']['k1']} (4 threads), "
        f"{sv['seq_launches']['k1']} (one at a time), "
        f"{sv['loop_launches']['k1']} (loop), export run "
        f"{tl_['export_launches']['k1']}; K1 at the largest micro-batch "
        f"N={sv['k1_max'][0]} {sv['k1_max'][1]}x{sv['k1_max'][2]}: "
        f"{sv['k1_max'][3]['ms']:.5f} ms, bound "
        f"{max(sv['k1_max'][3]['bytes_ms'], sv['k1_max'][3]['ops_ms']):.5f}"
        f", grid_sample {sv['k1_max'][3]['library_ms']:.5f}, plain "
        f"{sv['k1_max'][3]['plain_ms']:.5f}; "
        + "; ".join(f"{v} K1/K2 requests {v3[v]['req_launches']['k1']}, "
                    f"steps {v3[v]['launches']['k1']}/"
                    f"{v3[v]['launches']['k2']}" for v in V3_PRESETS)
        + f"; panoptic eval K1 {pan['eval_launches']['k1']} (3 images), "
        f"train CLI K1/K2 {pan['cli_launches']['k1']}/"
        f"{pan['cli_launches']['k2']} ({PAN_ITERS} iterations); "
        + "; ".join(f"{n} K1 requests {var[n]['req_launches']['k1']}, "
                    f"K1/K2 steps {var[n]['launches']['k1']}/"
                    f"{var[n]['launches']['k2']}" for n in VARIANTS)
        + f"; FPN family K1/K2: requests {fpn['launches']['k1']}/"
        f"{fpn['launches']['k2']}, steps {fpn_train['launches']['k1']}/"
        f"{fpn_train['launches']['k2']}, MS-ResNet-104, cascade, eval and "
        f"train CLIs {[(n['k1'], n['k2']) for n in fam['launches']]}; "
        f"data-parallel K1/K2: the one-rank NCCL CLI, then for the tiny "
        f"model and the flagship the one-process reference and the two "
        f"gloo ranks "
        f"{[(n['k1'], n['k2']) for n in dp['launches']]}; library modules "
        f"card vs CPU max|diff| "
        + ", ".join(f"{k} {v:.3g}" for k, v in lib["errs"].items())
        + f"; native runtime built: {lib['runtime']}"
        + "; K1 on a row band (ms, bound ms, grid_sample ms) "
        + "; ".join(f"{h}x{w} {str(dt)[6:]} "
                    f"{'whole' if r0 is None else f'row0 {r0}'}: "
                    f"{t['ms']:.5f}, {max(t['bytes_ms'], t['ops_ms']):.5f}, "
                    f"{t['library_ms']:.5f}"
                    for (h, w, dt, r0), t in kr["times"].items())
        + f"; (tp)/(spatial) K1/K2 launches "
        f"{[(n['k1'], n['k2'], n['k1_bf16']) for n in par['launches']]}"
        + f"; (spatial families) K1 launches (f32, bf16) "
        f"{[(n['k1'], n['k1_bf16']) for n in sfam['launches']]}"
        + f"; (burnin) bf16 K1/K2 {bu['launches']['k1_bf16']}/"
        f"{bu['launches']['k2_bf16']} ({BURNIN_RUN} steps, "
        f"{BURNIN_VALS} val forwards), (learning) bf16 K1/K2 "
        f"{le['launches']['k1_bf16']}/{le['launches']['k2_bf16']} "
        f"({LEARN_ITERS} iterations, {LEARN_VAL} val images twice), "
        f"(init) bf16 K1/K2 {ini['launches']['k1_bf16']}/"
        f"{ini['launches']['k2_bf16']} ({INIT_STEPS} steps), the DCN "
        f"masks' first non-zero spike at step {ini['fired_at']}; threefry "
        f"launches {threefry_launches}: point steps "
        f"{pt['launches']['threefry']}, FPN requests/steps "
        f"{fpn['launches']['threefry']}/{fpn_train['launches']['threefry']}"
        f", FPN family {[n['threefry'] for n in fam['launches']]}, FPN "
        f"bf16 {[n['threefry'] for n in fb['launches']]}, DDD17 "
        f"{[n['threefry'] for n in dd['launches']]}, flagship train "
        f"{tr['launches']['threefry']}, (burnin) "
        f"{bu['launches']['threefry']}, (learning) "
        f"{le['launches']['threefry']}, (init)'s init "
        f"{ini['init_launches']['threefry']}")
    log("total", f"chip_smoke took {time.perf_counter() - T0:.1f}s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ddp-worker"]:
        sys.exit(ddp_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--par-worker"]:
        sys.exit(par_worker(sys.argv[2:]))
    sys.exit(main())
