"""Drive the PyTorch port's main path on one CUDA card and check its kernels.

    python3 chip_smoke.py
    python3 chip_smoke.py --multi-card   # phase 6 alone, one rank per card

Needs one NVIDIA Hopper card (the kernels are built for sm_90a at first use
into build/torch_ext) and the ``stylemesh_tpu_torch`` package beside this
file. Exits nonzero, with no result line, when CUDA is unavailable or any
phase fails. Phases:

1. main path: the full-method bench workload (4096² x 4 Laplacian atlas,
   V = 4 views, content 256x341, UV levels 256..784 px high, multi style
   pyramid, bf16 VGG trunk on the conv kernels K5-K8, the route kernel and
   conv1_1's stem kernels, float32 K1/K2, Adam) through
   ``TexturePipeline.prepare_batch`` and ``train_step``; every loss must be
   finite, the launch counts of K1-K8, the route kernel and the stem
   kernels over the timed steps above zero, K6's launches that write route
   codes (``conv_relu_pool.switch_launches``) one a level a step and none
   in ``prepare_batch``,
   and K1's and K2's one a step (one launch over all pyramid levels each),
   as the one-pass update's (Adam and the clamp over the four layers),
   and the profile of a step must show no cuDNN convolution and no float32
   GEMM (no ``bmm``, no SIMT sgemm): every style layer's Gram goes through
   K3/K4 and conv1_1 through its stem kernels; a profile of ``loss_fn`` and
   ``torch.autograd.grad`` alone (no Adam) with the ops' input shapes must
   show one K1 and one K2 launch, at most one fill of each texture layer
   (K2's zeroed gradient), and no float32 add of texture-layer-shaped
   tensors but the one per layer that joins the regularizer's gradient to
   K2's; a profile of the train step itself (``eager_step``) with the ops'
   input shapes must show no PyTorch op on a texture layer's shape that
   runs on the card but K2's fill, one a layer: the regularizer's value and
   gradient are ``adam.cu``'s (the value kernels, and the update's fold),
   launched once a step each;
2. reference: a small configuration trained on the card and on the CPU
   (plain versions), float32, losses compared;
2b. the same small configuration in bf16 (the kernel trunk), the losses of
   the first step compared;
4. run loop: a ScanNet-layout scene of 16 views (480x640 photos, UV levels
   256..784) written to a temporary directory, trained by the port's CLI
   (``--preset scannet_full --bfloat16``: K1/K2 in their bf16 mode, the
   kernel trunk, ``--tb_logs``) for one epoch of batches of 4 views
   repeated twice; the losses must be finite, ``texture.npz`` written,
   K1/K2's bf16 mode launched once each a train step, and K3-K8 launched.
   The run ends with the CLI's post chain: every view's ``styled/<idx>.png``,
   ``styled.mp4`` of 16 frames, the eval JSON's six accuracies finite with
   ``lpips_calibrated`` false, the ``post_*`` phases in ``wallclock.json``
   and an event file must exist, and the post chain must launch float32 K1
   (2 render launches) and K1's per-view form (12 warps: one a pairing,
   eval chunk and image kind) and nothing else, apart from the train
   steps. The same post chain then runs on the CPU (plain versions) from
   the exported texture: its frames within 1/255 of the card's, its eval
   of the card's frames within 1e-4 (MSE) and 1e-3 (LPIPS) relative;
5. K9: the same CLI call with ``STYLEMESH_CONV_FLIPVJP=0
   STYLEMESH_FAST_CONV=1`` (the unfused trunk), one step per batch; K9 must
   be launched and K5-K8 and the stem kernels not, and the profile of a
   bench step under the same settings must show no cuDNN convolution but
   conv1_1's forward and input gradient;
6. multi-device, on the same scene, each CLI call also run on one rank (in
   this process) as its reference; the 2-rank calls go through
   ``python -m torch.distributed.run --standalone --nproc_per_node 2``, both
   ranks on this one card over gloo, so their step times are not
   multi-card numbers:
   [atlas] ``--shard_atlas`` over 2 ranks, in the CLI's bf16 K1/K2 mode and
   again with ``--kernel_compute f32``: every rank must launch the banded
   K1/K2 of its mode once a train step and no unbanded K1/K2, the first
   step's losses must lie within 1e-4 relative of the one-rank run's, and
   the exported texture must have the full shapes and be finite; the f32
   run also runs the post chain, on rank 0 alone (one eval, one set of
   frames, finite accuracies);
   [dp] ``--data_parallel`` over 2 ranks, the first step's losses within
   1e-4; then ``--preset scannet_dip`` (``gram_mode='average'``) over 2
   ranks: finite losses and the Gram cache's count equal to one rank's;
   [multistyle] two ``--style_image_path`` on one rank: style 0's first
   step within 1e-4 of the single-style run, one export per style; then
   one style per rank, each style's first step within 1e-4 of the
   one-rank sweep's. ``--multi-card`` runs this phase alone, one rank per
   card (NCCL);
3. kernels: each kernel against its plain PyTorch version at the main path's
   shapes and inputs, timed with CUDA events beside the plain version and one
   PyTorch library call computing the same function (kernel and library:
   median, min and max of 20 launches after a warm-up; plain: mean of 5),
   (K3/K4 at every (level, style layer) pair of the bench step, their
   bound counting the features only in pixel tiles with a live mask, their
   library call one cuBLAS ``bmm`` over the masked features),
   with its bound on an H100 SXM (3.35 TB/s HBM, 989 TFLOP/s dense bf16)
   and, for the convs, its achieved TFLOP/s; conv1_1's stem kernels
   (forward with bias and relu, and the input gradient of a random
   cotangent, masked inside the kernel) at each level against the plain
   im2col product: every element within one bf16 ulp (of the larger value,
   or of 2^-9 of the largest where an element is smaller), the largest
   difference in bf16 ulps logged; at every K5 and K9 shape, K5
   without bias and relu must equal K9 bit for bit, and at every block-tail
   shape K6 must equal maxpool2 of K5's relu output, K7's maps K5's output
   and K6's, K6 with route codes K6 and its codes the plain rule on K5's
   relu output, and K8 (from those codes) K5 with the flipped kernel on the
   routed cotangent, bit for bit; the route kernel (``pool_route``, the 128-channel tail's pool
   backward from K7's pre-pool map) at conv2_2's shape of each level
   against its plain chain, bit for bit, timed beside it; bound: the map
   read and dr written once, the pooled cotangent read once; K1/K2 (both
   modes) and the banded K1/K2 for the 4 bands of
   D = 4 at each level alone (each against its plain version, the bands'
   sum against the unbanded K1/K2), then all of them at step level, as the
   main path calls them: one launch over the 4 levels each, against their
   plain versions, timed (K2 with its zero fill; the banded forms for rank
   0's bands of D = 2); K1 at the post chain's shapes: the render (8 views
   of the 784-px UV level over the 4 layers, one launch) and the eval's
   warps (K1's per-view form, one launch for 8 3-channel 256x341 images,
   each at its own grid, with +-inf, NaN, huge and border entries; also
   equal bit for bit to 8 launches of the shared-layer form, one a view),
   each against its plain version and timed per call; the warp call's
   device time also with the calls queued back to back behind a spin
   kernel, beside one ``F.grid_sample``'s; the one-pass update (``update``:
   Adam and the clamp, one launch over the bench atlas's four layers)
   against its plain version, the chain of PyTorch elementwise kernels it
   replaced: p, m and v each within 1e-6 of its largest value, the share
   of elements equal bit for bit logged, with the bench configuration's
   regularizer coefficients folded in: equal bit for bit; bound: p, g, m,
   v read and p, m, v written once; the regularizer's value
   (``tex_reg_value``) against a float64 sum, 1e-6 of the value, timed
   beside the plain float32 ``mean`` chain; bound: the atlas read once;
7. the demo room (after phase 3): the port's ``build_demo_scene`` (24 views
   of 480x640, the native bake at 480x640 and heights 256..960, the frame
   renders and the bake timed apart); views 0-3 re-baked by
   ``bake_scene(backend="torch")`` on the card and by the native backend,
   timed in ms per view; every view and size of the torch bake held against
   the same scan in float64 with tests/test_native.py's bounds (more than
   99% of the pixels with the same hit and winning triangle, there UV
   within 1e-4, depth within 1e-4 relative, angle and LOD within 1e-3), the
   native bake's own gap to float64 reported beside it; the torch
   rasterizer's peak memory at 960x1280 with full 256-face chunks; one
   480x640 view of the room with each wall split into 128x128 quads
   (196,608 faces), torch against native with those bounds, both timed;
   the full-method step of phase 1's configuration on the room (V = 4
   views spread over the orbit, UV levels 256..784, 1 warm-up and 5 timed
   steps): finite losses, K1-K8 and the stem kernels launched, K1 and K2
   once a step, the step's profile as in phase 1; K1 and K2 at step level
   on the room's UV maps against phase 3's synthetic batch; and the two
   quality gates of tests/test_quality_gates.py at its sizes, steps and
   thresholds (float32): self-reproduction PSNR (under 16 dB at the start,
   over 24 dB and 9 dB more at the end) and the circle-uniformity
   separation of the full arm and the only-2D arm (its seven assertions).

The last two lines of standard output are the ``{"kernels": [...]}`` JSON
line and the ``{"ok": true, "device": ...}`` JSON line.
"""

import contextlib
import io
import json
import math
import os
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from stylemesh_tpu_torch import cli, kernels, preprocess
from stylemesh_tpu_torch.convert import batch_from_numpy
from stylemesh_tpu_torch.data import demo_scene
from stylemesh_tpu_torch.data.loading import (SceneCache, load_extrinsics,
                                              rescale_intrinsics)
from stylemesh_tpu_torch.data.scenes import discover_scannet_scenes, select_scene
from stylemesh_tpu_torch.data.synthetic import synthetic_view_batch
from stylemesh_tpu_torch.eval.circles import measure_circles_for_scene
from stylemesh_tpu_torch.eval.reprojection import EVAL_CHUNK
from stylemesh_tpu_torch.geometry import mesh_io, native, project, rasterize
from stylemesh_tpu_torch.models.pipeline import PipelineConfig, TexturePipeline
from stylemesh_tpu_torch.models import vgg
from stylemesh_tpu_torch.models.texture import sample_texture
from stylemesh_tpu_torch.models.vgg import init_vgg_params, vgg_features
from stylemesh_tpu_torch.ops import (adam_kernels, conv_im2col, conv_kernels,
                                     gram_kernels, head_kernels)
from stylemesh_tpu_torch.ops import grid_sample as gs
from stylemesh_tpu_torch.ops.color import gatys_post
from stylemesh_tpu_torch.ops.resize import resize_bilinear
from stylemesh_tpu_torch.optimize import RENDER_CHUNK, render_styled_frames

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12   # dense bf16 tensor-core peak
STEPS = 5                  # timed train steps
REPS = 20                  # launches per kernel / library timing (median)
PLAIN_REPS = 5             # launches per plain-version timing (mean)

REPO = Path(__file__).resolve().parent
SAMPLE_SRC = "stylemesh_tpu_torch/kernels/csrc/sample.cu"
GEMM_SRC = "stylemesh_tpu_torch/kernels/csrc/conv_gemm.cu"
BWD_SRC = "stylemesh_tpu_torch/kernels/csrc/conv_pool_bwd.cu"
STEM_SRC = "stylemesh_tpu_torch/kernels/csrc/conv_stem.cu"
ADAM_SRC = "stylemesh_tpu_torch/kernels/csrc/adam.cu"
KERNELS = {  # launches: (wrapper, attribute holding its launch count);
    # unit: what the row's launches_per_unit counts per (default a step)
    "K1_gather": dict(source="stylemesh_tpu_torch/kernels/csrc/sample.cu",
                      replaces="stylemesh_tpu/ops/splat_pallas.py:486",
                      launches=(gs.gather_levels, "launches"), rel_tol=1e-5),
    "K1_gather_bf16": dict(source="stylemesh_tpu_torch/kernels/csrc/sample.cu",
                           replaces="stylemesh_tpu/ops/splat_pallas.py:486",
                           launches=(gs.gather_levels, "bf16_launches"),
                           rel_tol=1e-5),
    "K2_splat": dict(source="stylemesh_tpu_torch/kernels/csrc/sample.cu",
                     replaces="stylemesh_tpu/ops/splat_pallas.py:421",
                     launches=(gs.splat_levels, "launches"), rel_tol=1e-4),
    "K2_splat_bf16": dict(source="stylemesh_tpu_torch/kernels/csrc/sample.cu",
                          replaces="stylemesh_tpu/ops/splat_pallas.py:421",
                          launches=(gs.splat_levels, "bf16_launches"),
                          rel_tol=1e-4),
    "K3_gram_fwd": dict(source="stylemesh_tpu_torch/kernels/csrc/gram.cu",
                        replaces="stylemesh_tpu/ops/gram_pallas.py:140",
                        launches=(gram_kernels.masked_gram_sums, "launches"),
                        rel_tol=1e-3),
    "K4_gram_bwd": dict(source="stylemesh_tpu_torch/kernels/csrc/gram.cu",
                        replaces="stylemesh_tpu/ops/gram_pallas.py:208",
                        launches=(gram_kernels.masked_gram_sums_grad, "launches"),
                        rel_tol=1e-2),
    "K5_conv3x3": dict(source=GEMM_SRC,
                       replaces="stylemesh_tpu/ops/conv_pallas.py:232",
                       launches=(conv_kernels.conv3x3, "launches"),
                       rel_tol=1e-2),
    "K6_conv_relu_pool": dict(source=GEMM_SRC,
                              replaces="stylemesh_tpu/ops/head_pallas.py:487",
                              launches=(head_kernels.conv_relu_pool, "launches"),
                              rel_tol=1e-2),
    "K7_conv_relu_pool_dual": dict(
        source=GEMM_SRC, replaces="stylemesh_tpu/ops/head_pallas.py:234",
        launches=(head_kernels.conv_relu_pool, "dual_launches"), rel_tol=1e-2),
    # K6 at 64 channels in a forward whose backward runs: the pooled map and
    # each window's route codes, K8's input
    "K6_conv_relu_pool_codes": dict(
        source=GEMM_SRC, replaces="stylemesh_tpu/ops/head_pallas.py:487",
        launches=(head_kernels.conv_relu_pool, "switch_launches"),
        rel_tol=1e-2),
    "K8_conv_relu_pool_bwd": dict(
        source=BWD_SRC, replaces="stylemesh_tpu/ops/head_pallas.py:413",
        launches=(head_kernels.conv_relu_pool_bwd, "launches"), rel_tol=1e-2),
    "K9_conv3x3_mxu": dict(source=GEMM_SRC,
                           replaces="stylemesh_tpu/ops/conv_pallas.py:136",
                           launches=(conv_kernels.conv3x3_mxu, "launches"),
                           rel_tol=1e-2),
    # the 128-channel tail's pool backward before K5, whose TPU path is the
    # pool's elementwise VJP under XLA (no pallas_call); bit for bit
    "pool_route": dict(source=BWD_SRC,
                       replaces="stylemesh_tpu/models/vgg.py:466",
                       launches=(head_kernels.pool_route, "launches"),
                       rel_tol=0.0),
    # the banded form, reached through grid_sample.py::grid_sample_banded_cf
    "K1_gather_banded": dict(
        source=SAMPLE_SRC, replaces="stylemesh_tpu/ops/grid_sample.py:185",
        launches=(gs.gather_levels, "banded_launches"), rel_tol=1e-5),
    "K1_gather_banded_bf16": dict(
        source=SAMPLE_SRC, replaces="stylemesh_tpu/ops/grid_sample.py:185",
        launches=(gs.gather_levels, "banded_bf16_launches"), rel_tol=1e-5),
    "K2_splat_banded": dict(
        source=SAMPLE_SRC, replaces="stylemesh_tpu/ops/grid_sample.py:210",
        launches=(gs.splat_levels, "banded_launches"), rel_tol=1e-4),
    "K2_splat_banded_bf16": dict(
        source=SAMPLE_SRC, replaces="stylemesh_tpu/ops/grid_sample.py:210",
        launches=(gs.splat_levels, "banded_bf16_launches"), rel_tol=1e-4),
    # K1 (f32) on the post chain's paths, per call of the render and of the
    # eval's warp; their launches in the run are read from the CLI's
    # post-chain line, by phase
    "K1_gather_post_render": dict(
        source=SAMPLE_SRC, replaces="stylemesh_tpu/ops/splat_pallas.py:486",
        launches=(gs.gather_levels, "launches"), unit="call", rel_tol=1e-5),
    "K1_gather_warp": dict(
        source=SAMPLE_SRC, replaces="stylemesh_tpu/ops/splat_pallas.py:486",
        launches=(gs.gather_each, "launches"), unit="call", rel_tol=1e-5),
    # conv1_1, whose TPU path is an XLA im2col product (no pallas_call)
    "stem_fwd": dict(source=STEM_SRC,
                     replaces="stylemesh_tpu/ops/conv_im2col.py:37",
                     launches=(conv_im2col.stem_forward, "launches"),
                     rel_tol=2 ** -7),
    "stem_bwd": dict(source=STEM_SRC,
                     replaces="stylemesh_tpu/ops/conv_im2col.py:67",
                     launches=(conv_im2col.stem_backward, "launches"),
                     rel_tol=2 ** -7),
    # Adam and the clamp, whose TPU path is optax.adam and clamp_texture in
    # one XLA fusion (no pallas_call)
    "update": dict(source=ADAM_SRC,
                   replaces="stylemesh_tpu/models/pipeline.py:250",
                   launches=(adam_kernels.adam_clamp_, "launches"),
                   rel_tol=1e-6),
    # the texture regularizer's value, read once; its TPU path is
    # texture_regularizer under XLA (no pallas_call)
    "tex_reg_value": dict(source=ADAM_SRC,
                          replaces="stylemesh_tpu/models/texture.py:111",
                          launches=(adam_kernels.tex_reg_value, "launches"),
                          rel_tol=1e-6),
}
# the kernels each driven path must launch
BENCH_KERNELS = ("K1_gather", "K2_splat", "K3_gram_fwd", "K4_gram_bwd",
                 "K5_conv3x3", "K6_conv_relu_pool", "K6_conv_relu_pool_codes",
                 "K7_conv_relu_pool_dual",
                 "K8_conv_relu_pool_bwd", "stem_fwd", "stem_bwd", "pool_route")
TRUNK_KERNELS = BENCH_KERNELS[4:]
ONCE_A_STEP = ("K1_gather", "K2_splat", "update", "tex_reg_value")
RUN_KERNELS = ("K1_gather_bf16", "K2_splat_bf16") + BENCH_KERNELS[2:]
K9_ENV = {"STYLEMESH_CONV_FLIPVJP": "0", "STYLEMESH_FAST_CONV": "1"}
# Tolerances, relative to the largest |value| of the plain version:
# K1 float32, the same arithmetic but fused multiply-adds: 1e-5 (its bf16
#    mode: the same arithmetic, unfused, 1e-5 as well). The same for the
#    banded K1 against its plain version, and for the sum of its band
#    partials against the unbanded K1 (one more float32 sum per pixel).
# K2 float32 atomics sum in another order than index_add_: 1e-4 (either
#    mode, banded or not).
# K3 float32 sums over up to 819 280 pixels in another order: 1e-3.
# K4 rounds a float32 sum to bf16: two bf16 ulps of the largest element
#    (2 * 2^-8 ~ 1e-2).
# K5-K7 round float32 sums taken in another order to bf16: 1e-2 (two ulps).
# K8 as K5: its plain version routes by the same codes, so no tie can
#    break the other way (1e-2).
# K9 is K5 without bias and relu: 1e-2 (and K5 with bias=None, relu=False
#    must equal it bit for bit: one C entry).
# update: the same float32 operations in the same order as its plain
#    version's PyTorch kernels; where those fuse a multiply-add a rounding
#    may differ: 1e-6 (each of p, m and v against its own largest value).
# tex_reg_value: sums in double against a float64 sum: 1e-6 of the value.
# stem_fwd / stem_bwd (conv1_1) round float32 sums taken in another order
#    to bf16 once: one bf16 ulp of each element (2^-7 of the largest), and
#    by check_ulps one ulp of the element itself, or of 2^-9 of the
#    largest where the element is smaller (a sum near zero moves by more
#    than its own bf16 spacing when its float32 order changes).
# Between the kernels, bit for bit (one mainloop at K5's N tile): K6 is
#    maxpool2 of K5's relu output, K7's pre-pool map is that output and its
#    pooled map K6's, K6 with codes is K6 and its codes the plain rule's on
#    K5's relu output, K8 is K5 with the flipped kernel on the routed
#    cotangent.


def log(msg):
    print(msg, flush=True)


def bench_config(compute_dtype=torch.bfloat16, **overrides):
    """bench.py::_bench_cfg of the JAX package, V = 4."""
    cfg = dict(
        steps_per_epoch=1,
        texture_width=4096, texture_height=4096, hierarchical_layers=4,
        use_angle_weight=True, use_depth_scaling=True,
        content_weight=7e1, style_weight=1e-4, tex_reg_weight=5e3,
        style_pyramid_mode="multi", angle_threshold=30.0,
        learning_rate=1.0, decay_step_size=3,
        remat_vgg=False, remat_min_px=600_000,
        compute_dtype=compute_dtype,
        precision="default" if compute_dtype == torch.bfloat16 else "highest")
    cfg.update(overrides)
    return PipelineConfig(**cfg)


def style_image(h, w):
    rng = np.random.default_rng(0)
    return torch.from_numpy(
        (rng.random((1, h, w, 3), dtype=np.float32) - 0.45) * 255.0)


def bench_workload():
    """The bench step's workload: the pipeline of :func:`bench_config` with
    random VGG weights and a random 512x683 style image, and bench.py's view
    batch (V = 4, 256x341 content, UV levels 256..784); (pipe, batch)."""
    batch = synthetic_view_batch(
        num_views=4, content_hw=(256, 341), level_heights=(256, 432, 608, 784),
        aspect=1280.0 / 960.0, min_depth=0.25, seed=0, depth_range=(0.4, 7.0))
    pipe = TexturePipeline(bench_config(), init_vgg_params(rng=0, scale=0.05),
                           style_image(512, 683))
    return pipe, batch


def cuda_times(fn, reps=REPS):
    """(median, min, max) milliseconds of ``fn`` on the card, each of
    ``reps`` calls after a warm-up timed with its own pair of events."""
    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    times = sorted(start.elapsed_time(end) for start, end in pairs)
    return statistics.median(times), times[0], times[-1]


def cuda_ms(fn, reps=PLAIN_REPS):
    """Mean milliseconds of ``fn`` on the card over ``reps`` calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def reset_counts():
    for spec in KERNELS.values():
        setattr(*spec["launches"], 0)


def read_counts():
    return {name: getattr(*spec["launches"]) for name, spec in KERNELS.items()}


# ---------------------------------------------------------------- phase 1


def main_path():
    t0 = time.perf_counter()
    pipe, batch = bench_workload()
    state = pipe.init()
    aux = pipe.prepare_batch(batch)
    torch.cuda.synchronize()
    log(f"[main] setup (batch, style targets, init, prepare_batch): "
        f"{time.perf_counter() - t0:.3f} s")
    switches = head_kernels.conv_relu_pool.switch_launches
    t0 = time.perf_counter()
    aux = pipe.prepare_batch(batch)
    torch.cuda.synchronize()
    prepare_ms = (time.perf_counter() - t0) * 1e3
    switches = head_kernels.conv_relu_pool.switch_launches - switches
    log(f"[main] prepare_batch: {switches} K6 launches with route codes")
    if switches:
        raise RuntimeError("prepare_batch's encodes wrote route codes")
    for _ in range(2):  # warm-up: the eager step, then the graphs' capture
        losses = pipe.train_step(state, batch, aux)
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    history = [pipe.train_step(state, batch, aux) for _ in range(STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()

    history = [{k: float(v) for k, v in l.items()} for l in [losses] + history]
    for i, l in enumerate(history):
        log(f"[main] step {i}: " + json.dumps(l))
        if not all(math.isfinite(x) for x in l.values()):
            raise RuntimeError(f"non-finite loss at step {i}: {l}")
    for name in BENCH_KERNELS:
        log(f"[main] {name}: {counts[name]} launches in {STEPS} steps")
        if counts[name] == 0:
            raise RuntimeError(f"{name} was not launched on the main path")
    for name in ONCE_A_STEP:  # one launch over all levels or layers
        if counts[name] != STEPS:
            raise RuntimeError(f"{name}: {counts[name]} launches in {STEPS} "
                               f"steps, not one a step")
    # conv1_2 at each level: one K6 with route codes, one K8
    for name in ("K6_conv_relu_pool_codes", "K8_conv_relu_pool_bwd"):
        if counts[name] != len(batch.uv) * STEPS:
            raise RuntimeError(f"{name}: {counts[name]} launches in {STEPS} "
                               f"steps, not one a level a step")
    result = dict(step_ms=wall / STEPS * 1e3,
                  views_per_s=STEPS * batch.num_views / wall,
                  prepare_batch_ms=prepare_ms,
                  peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    log("[main] " + json.dumps(result))
    profile_step(pipe, state, batch, aux, result["step_ms"])
    profile_loss_grad(pipe, state, batch, aux)
    profile_train_step(pipe, state, batch, aux)
    return pipe, state, batch, aux, counts


def profile_step(pipe, state, batch, aux, step_ms):
    """Device time of one step by kernel and by PyTorch op (torch.profiler),
    and the device busy share of the unprofiled step time. The step is
    ``eager_step``, the same kernels as the replayed graphs, launched by
    the ops the profile names."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pipe.eager_step(state, batch, aux)
        torch.cuda.synchronize()
    events = prof.key_averages()
    on_device = [e for e in events if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in on_device) / 1e3
    log(f"[profile] device busy {device_ms:.3f} ms of a {step_ms:.3f} ms step "
        f"({device_ms / step_ms:.3f})")
    ops = [e for e in events
           if e.device_type == DeviceType.CPU and e.self_device_time_total > 0]
    for label, rows in (("kernel", on_device), ("op", ops)):
        for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:15]:
            log(f"[profile] {label} {e.self_device_time_total / 1e3:9.3f} ms "
                f"x{e.count:<4d} {e.key[:90]}")
    library_convs = sorted({e.key for e in events
                            if "convolution" in e.key or "cudnn" in e.key.lower()})
    if library_convs:
        raise RuntimeError(f"the bf16 step ran library convolutions: {library_convs}")
    log("[profile] no cuDNN convolution in the step")
    no_float32_grams(prof)


FILL_OPS = ("aten::fill_", "aten::zero_")
ADAM_CU_KERNELS = ("adam_clamp_kernel", "tex_reg_partials_kernel",
                   "tex_reg_finish_kernel")
ADD_OPS = ("aten::add", "aten::add_")


def profile_loss_grad(pipe, state, batch, aux):
    """Profile ``loss_fn`` and ``torch.autograd.grad`` of the bench step
    (no Adam, whose in-place updates are layer-shaped) with the ops' input
    shapes. Raise unless K1 and K2 were launched once each, no texture layer
    was filled more than once (K2's zeroed gradient), and no float32 add
    took texture-layer-shaped inputs but autograd's one per layer that joins
    the regularizer's gradient to K2's (none when the regularizer is off):
    the levels' gradients are summed inside K2. Logs the fills, adds and
    launches it saw."""
    from torch.profiler import ProfilerActivity, profile

    layers = list(state.texture.layers)
    shapes = [tuple(l.shape) for l in layers]
    allowed_adds = 1 if pipe.config.tex_reg_weight > 0 else 0
    torch.cuda.synchronize()
    reset_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        total, _, _ = pipe.loss_fn(state.texture, batch, aux, state.gram_cache)
        torch.autograd.grad(total, layers)
        torch.cuda.synchronize()
    counts = read_counts()

    def layer_shape(e):
        return next((tuple(x) for x in e.input_shapes if tuple(x) in shapes),
                    None)

    def outermost(e, names):
        p = e.cpu_parent
        while p is not None:
            if p.name in names:
                return False
            p = p.cpu_parent
        return True

    fills = {sh: 0 for sh in shapes}
    adds = {sh: 0 for sh in shapes}
    for e in prof.events():
        sh = layer_shape(e)
        if sh is None:
            continue
        if e.name in FILL_OPS and outermost(e, FILL_OPS):
            fills[sh] += 1
        elif e.name in ADD_OPS:
            adds[sh] += 1
    for sh in shapes:
        log(f"[loss_grad] layer {sh}: {fills[sh]} fills, {adds[sh]} float32 "
            f"adds (allowed {allowed_adds}: the regularizer's gradient)")
    log(f"[loss_grad] K1 {counts['K1_gather']} launches, K2 "
        f"{counts['K2_splat']} launches in one loss_fn + autograd.grad")
    if counts["K1_gather"] != 1 or counts["K2_splat"] != 1:
        raise RuntimeError("loss_fn + autograd.grad did not launch K1 and K2 "
                           "once each")
    if any(n > 1 for n in fills.values()):
        raise RuntimeError(f"more than one fill of a texture layer: {fills}")
    if any(n > allowed_adds for n in adds.values()):
        raise RuntimeError(f"layer-shaped float32 adds of the levels' "
                           f"gradients: {adds}")


def profile_train_step(pipe, state, batch, aux):
    """Profile the train step (``eager_step``: the replayed graphs' kernels)
    with the ops' input shapes. Raise if an ATen op whose input has a
    texture layer's shape ran on the card, but for one fill of each layer
    (K2's zeroed gradient): the regularizer's value, its gradient and
    Adam are ``adam.cu``'s kernels, no PyTorch op. Logs the device ms of
    those kernels and of every layer-shaped op it saw."""
    from torch.profiler import ProfilerActivity, profile

    shapes = {tuple(l.shape) for l in state.texture.layers}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        pipe.eager_step(state, batch, aux)
        torch.cuda.synchronize()
    fills, others = {sh: 0 for sh in shapes}, {}
    for e in prof.events():
        sh = next((tuple(x) for x in e.input_shapes if tuple(x) in shapes),
                  None)
        if sh is None or not e.kernels or not e.name.startswith("aten::"):
            continue  # K1's launch runs inside its autograd op, no aten op
        if e.name in FILL_OPS:
            fills[sh] += 1
        else:
            key = f"{e.name} {sh}"
            others[key] = others.get(key, 0.0) + sum(
                k.duration for k in e.kernels) / 1e3
    ours = {}
    for e in prof.key_averages():
        name = next((k for k in ADAM_CU_KERNELS if k in e.key), None)
        if name is not None and e.self_device_time_total > 0:
            ours[name] = e.self_device_time_total / 1e3
    log(f"[train_step] adam.cu device ms: {json.dumps(ours)}; layer-shaped "
        f"fills {json.dumps({str(k): n for k, n in fills.items()})}; other "
        f"layer-shaped ops (device ms): {json.dumps(others)}")
    if len(ours) != len(ADAM_CU_KERNELS):
        raise RuntimeError(f"the step did not run the update and the "
                           f"regularizer's value kernels: {ours}")
    if others or any(n > 1 for n in fills.values()):
        raise RuntimeError("the train step ran PyTorch ops on texture "
                           "layers beyond K2's fill")


def no_float32_grams(prof):
    """Raise if the profiled bf16 step ran a ``bmm`` (the plain float32
    masked Gram's product; K3/K4 are no PyTorch op) or any float32 GEMM on
    the CUDA cores (SIMT sgemm, cuBLAS's ``f32f32`` ffma kernels; conv1_1's
    stem kernels are no PyTorch op either)."""
    bmm = sum(1 for e in prof.events() if e.name == "aten::bmm")
    sgemm = {}
    attributed = sum(len(e.kernels) for e in prof.events())
    if not attributed:
        raise RuntimeError("the profile attributes no kernel to an op")
    for e in prof.events():
        for k in e.kernels:
            name = k.name.lower()
            if "sgemm" in name or "gemm_f32f32" in name:
                sgemm[e.name] = sgemm.get(e.name, 0) + 1
    log(f"[profile] aten::bmm calls: {bmm}; float32 CUDA-core GEMM launches "
        f"by op: {sgemm} (of {attributed} kernels attributed to ops)")
    if bmm or sgemm:
        raise RuntimeError("the bf16 step ran a float32 GEMM: a Gram off "
                           "K3/K4 or conv1_1 off its stem kernels")


# ---------------------------------------------------------------- phase 2


def small_runs(compute_dtype, steps):
    """The losses of ``steps`` train steps of a small configuration, on the
    card (kernels) and on the CPU (plain versions)."""
    runs = {}
    for device in ("cuda", "cpu"):
        batch = synthetic_view_batch(
            num_views=2, content_hw=(32, 43), level_heights=(32, 48),
            seed=0, depth_range=(0.2, 0.45), device=device)
        cfg = bench_config(compute_dtype, texture_width=64, texture_height=64,
                           hierarchical_layers=2, style_min_size=16)
        pipe = TexturePipeline(cfg, init_vgg_params(rng=0, he=True, device=device),
                               style_image(64, 85), device=device)
        state = pipe.init()
        aux = pipe.prepare_batch(batch)
        runs[device] = [{k: float(v) for k, v in
                         pipe.train_step(state, batch, aux).items()}
                        for _ in range(steps)]
    return runs


def reference_check():
    """A small float32 configuration on the card (kernels) against the same
    on the CPU (plain versions)."""
    runs = small_runs(torch.float32, 3)
    runs = {d: [l["total"] for l in r] for d, r in runs.items()}
    for i, (a, b) in enumerate(zip(runs["cuda"], runs["cpu"])):
        rel = abs(a - b) / abs(b)
        log(f"[reference] step {i}: cuda {a!r} cpu {b!r} rel {rel:.3e}")
        # step 0 differs only by float32 summation order; later steps also
        # by Adam's sign(g) at near-zero gradients
        if not rel <= (1e-4 if i == 0 else 1e-3):
            raise RuntimeError(f"reference check failed at step {i}")


def reference_check_bf16():
    """Phase 2b: the small configuration in bf16 (the conv kernels K5-K8 on
    the card, their plain versions on the CPU); the losses of the first step
    within 2e-2 relative. Both round every VGG activation to bf16 once after
    float32 sums taken in different orders, so a value can land one bf16
    rounding apart and move a relu or a pool's maximum (the bound of the
    bf16 loss parity test against the JAX package)."""
    runs = small_runs(torch.bfloat16, 1)
    for k in ("content", "style", "total"):
        a, b = runs["cuda"][0][k], runs["cpu"][0][k]
        rel = abs(a - b) / abs(b)
        log(f"[reference bf16] step 0 {k}: cuda {a!r} cpu {b!r} rel {rel:.3e}")
        if not rel <= 2e-2:
            raise RuntimeError(f"bf16 reference check failed for {k}")


# ------------------------------------------------------------ phases 4, 5

SCENE = "scene0000_00"
SCENE_HW = (480, 640)
SCENE_VIEWS = 16
SCENE_LEVELS = (256, 432, 608, 784)


def write_scene(root, n=SCENE_VIEWS):
    """A ScanNet-layout scene of ``n`` views under ``root/train/images``
    (the layout of tests/test_data.py) from a synthetic panning camera:
    color jpg and uint16 depth png (mm) at 480x640, ``uv_<h>/<i>.npy``
    holding (u, v) in [0, 1] and zeros where no surface is seen,
    ``uv/<i>.angle.npy``, poses and ``<scene>.txt`` intrinsics; plus a
    512x683 style jpg. Returns the style image's path."""
    from PIL import Image

    b = synthetic_view_batch(num_views=n, content_hw=SCENE_HW,
                             level_heights=SCENE_LEVELS,
                             aspect=SCENE_HW[1] / SCENE_HW[0], min_depth=0.25,
                             seed=0, depth_range=(0.4, 7.0), numpy_arrays=True)
    sp = root / "train" / "images" / SCENE
    for sub in ["color", "depth", "pose", "uv"] + [f"uv_{h}" for h in SCENE_LEVELS]:
        (sp / sub).mkdir(parents=True)
    rng = np.random.default_rng(0)
    h, w = SCENE_HW
    mask = b.mask[..., 0] > 0
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            sp / "color" / f"{i}.jpg", quality=95)
        depth_mm = np.where(mask[i], np.round(b.depth[i, ..., 0] * 1000.0), 0)
        Image.fromarray(depth_mm.astype(np.uint16)).save(sp / "depth" / f"{i}.png")
        np.savetxt(sp / "pose" / f"{i}.txt", b.extrinsics[i])
        np.save(sp / "uv" / f"{i}.angle.npy",
                np.repeat(b.angle_guidance[i], 3, axis=-1))
        for lh, grid in zip(SCENE_LEVELS, b.uv):
            lw = grid.shape[2]
            m = mask[i][(np.arange(lh) * h) // lh][:, (np.arange(lw) * w) // lw]
            uv = np.where(m[..., None], (grid[i] + 1.0) * 0.5, 0.0)
            np.save(sp / f"uv_{lh}" / f"{i}.npy", uv.astype(np.float32))
    with open(sp / f"{SCENE}.txt", "w") as f:
        f.write(f"fx_color = {w}.0\nfy_color = {w}.0\nmx_color = {w / 2}\n"
                f"my_color = {h / 2}\ncolorWidth = {w}\ncolorHeight = {h}\n")
    style = root / "style.jpg"
    Image.fromarray(rng.integers(0, 256, (512, 683, 3), dtype=np.uint8)).save(style)
    return str(style)


def cli_argv(tag, root, style, index_repeat, extra=(), preset="scannet_full",
             post=False):
    """The CLI's arguments for a run on the scene; with ``post`` the run
    ends with the post chain (the CLI's default), else
    ``--no_post_steps``."""
    return ["--preset", preset, "--root_path", str(root), "--scene", SCENE,
            "--style_image_path", style, "--bfloat16", "--batch_size", "4",
            "--max_epochs", "1", "--index_repeat", str(index_repeat),
            *([] if post else ["--no_post_steps"]),
            "--log_dir", str(root / f"runs_{tag}"), *extra]


def read_metrics(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def first_step_losses(log_dir):
    """The logged train losses of step 1, by key."""
    prefix = "Batch/Loss/train/"
    return {r["tag"][len(prefix):]: r["value"] for r in read_metrics(log_dir)
            if r["tag"].startswith(prefix) and r["step"] == 1}


def run_result(tag, log_dir, exports=("texture.npz",)):
    """Check a run's logs and exports; its step time from wallclock.json."""
    records = read_metrics(log_dir)
    totals = [r["value"] for r in records
              if r["tag"].startswith("Batch/Loss/train/total")]
    if not totals or not all(math.isfinite(r["value"]) for r in records):
        raise RuntimeError(f"[{tag}] missing or non-finite losses")
    for name in exports:
        if not os.path.exists(os.path.join(log_dir, name)):
            raise RuntimeError(f"[{tag}] {name} was not written")
    with open(os.path.join(log_dir, "wallclock.json")) as f:
        wall = json.load(f)
    steps = wall["train_steps"]["steps"]
    return dict(steps=steps,
                step_ms=wall["train_steps"]["total_s"] / max(steps - 1, 1) * 1e3,
                views_per_s=(steps - 1) * 4 / wall["train_steps"]["total_s"],
                first_total=totals[0], last_total=totals[-1],
                phases={k: v["total_s"] for k, v in wall.items()
                        if "total_s" in v})


def cli_run(tag, root, style, index_repeat, required, forbidden=(), extra=(),
            preset="scannet_full", exports=("texture.npz",),
            per_step=("gather_bf16", "splat_bf16"), post=False):
    """One CLI training run on the scene, on one rank in this process; the
    launch counts of this run alone (set to 0 just before it, read just
    after), and the run's closing line (``train``): its train steps must
    launch each sampling kernel of ``per_step`` once a step. With ``post``
    the run ends with the post chain (:func:`check_post`), whose float32
    K1 launches must be all the run's but the epoch texture image's (the
    train steps and the validation run K1 in its bf16 mode)."""
    argv = cli_argv(tag, root, style, index_repeat, extra, preset, post)
    log(f"[{tag}] python -m stylemesh_tpu_torch.cli " + " ".join(argv))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = _Tee(sys.stdout)
    with contextlib.redirect_stdout(out):
        state, log_dir = cli.main(argv)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = read_counts()
    (rank_line,) = rank_lines(out.getvalue()).values()
    check_ranks(tag, {0: rank_line}, per_step, ())
    result = run_result(tag, log_dir, exports)
    result.update(state_step=state.step, wall_s=wall_s,
                  peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"[{tag}] " + json.dumps(result))
    for name, n in counts.items():
        log(f"[{tag}] {name}: {n} launches in {result['steps']} steps")
    for name in required:
        if counts[name] == 0:
            raise RuntimeError(f"[{tag}] {name} was not launched")
    for name in forbidden:
        if counts[name] != 0:
            raise RuntimeError(f"[{tag}] {name} was launched {counts[name]} times")
    post_result = None
    if post:
        post_result = check_post(tag, log_dir, out.getvalue(),
                                 tb="--tb_logs" in extra)
        # besides the post chain, each epoch's texture image
        # (``texture_image``, one launch) runs K1 in float32
        f32 = sum(n.get("gather", 0) for n in post_result["launches"].values())
        each = post_result["launches"]["post_eval"]["gather_each"]
        epochs = int(argv[argv.index("--max_epochs") + 1])
        if (counts["K1_gather"] != f32 + epochs
                or counts["K1_gather_warp"] != each
                or rank_line["train_launches"]["gather"]):
            raise RuntimeError(f"[{tag}] float32 K1 launched {counts['K1_gather']}"
                               f" times, the post chain {f32}; its per-view "
                               f"form {counts['K1_gather_warp']}, the eval "
                               f"{each}")
    return dict(counts=counts, steps=result["steps"], log_dir=log_dir,
                state=state, train=rank_line, argv=argv, post=post_result)


POST_LAUNCHES = re.compile(r"^post-chain launches: (\{.*\})$", re.M)


def check_post(tag, log_dir, out, views=SCENE_VIEWS, tb=False):
    """Check the post chain of a CLI run: every view's styled frame, a
    video of ``views`` frames, one eval JSON with the six accuracies finite
    and ``lpips_calibrated`` false, the ``post_*`` phases in
    ``wallclock.json``, with ``tb`` an event file, and the sampling kernels'
    launches of its one post-chain line (``out``): float32 K1 only, one
    launch per render chunk of 8 views, and in the eval two launches of its
    per-view form per pairing and chunk of EVAL_CHUNK views (colour and
    mask warps). Returns the phases' seconds and the launches."""
    import cv2

    styled = sorted(os.listdir(os.path.join(log_dir, "styled")))
    if styled != sorted(f"{i}.png" for i in range(views)):
        raise RuntimeError(f"[{tag}] styled/ holds {styled}")
    cap = cv2.VideoCapture(os.path.join(log_dir, "styled.mp4"))
    frames = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    outputs = [f for f in os.listdir(log_dir) if f.endswith("_output.json")]
    if frames != views or len(outputs) != 1:
        raise RuntimeError(f"[{tag}] styled.mp4 of {frames} frames, eval "
                           f"outputs {outputs}")
    with open(os.path.join(log_dir, outputs[0])) as f:
        results = json.load(f)
    acc = results["accuracies"]
    if (len(acc) != 6 or not all(math.isfinite(v) for v in acc.values())
            or results["lpips_calibrated"] is not False):
        raise RuntimeError(f"[{tag}] eval results {results}")
    with open(os.path.join(log_dir, "wallclock.json")) as f:
        wall = json.load(f)
    phases = {k: wall[k]["total_s"] for k in ("post_render", "post_video",
                                              "post_eval")}
    if tb and not any(f.startswith("events.out.tfevents")
                      for f in os.listdir(log_dir)):
        raise RuntimeError(f"[{tag}] --tb_logs wrote no event file")
    lines = POST_LAUNCHES.findall(out)
    if len(lines) != 1 or out.count("reprojection eval:") != 1:
        raise RuntimeError(f"[{tag}] {len(lines)} post-chain launch lines, "
                           f"{out.count('reprojection eval:')} evals")
    launches = json.loads(lines[0])
    want = {"post_render": {"gather": -(-views // RENDER_CHUNK)},
            "post_eval": {"gather_each": 2 * 3 * -(-views // EVAL_CHUNK)}}
    if launches != want:
        raise RuntimeError(f"[{tag}] post-chain launches {launches}, "
                           f"expected {want}")
    log(f"[{tag}] post chain: {json.dumps(phases)} s; accuracies "
        f"{json.dumps(acc)}; launches {json.dumps(launches)}")
    return dict(phases=phases, launches=launches, accuracies=acc)


def post_chain_on_cpu(tag, argv, log_dir):
    """The post chain of a card run again on the CPU (plain versions): the
    run's exported texture rendered and held against the card's frames
    (within 1/255), and the eval of the card's styled folder held against
    the card's eval (MSE within 1e-4 relative, LPIPS within 1e-3). Prints
    the gaps found."""
    from PIL import Image

    from stylemesh_tpu_torch.eval.reprojection import (
        eval_reprojection_consistency,
    )
    from stylemesh_tpu_torch.optimize import build_lpips, discover_scene
    from stylemesh_tpu_torch.presets import apply_preset, explicit_cli_keys
    from stylemesh_tpu_torch.utils.checkpoint import load_texture_npz

    t0 = time.perf_counter()
    args = cli.build_parser().parse_args(argv)
    args = apply_preset(args, args.preset,
                        explicit=explicit_cli_keys(cli.build_parser, argv))
    run, _ = cli.configs_from_args(args)
    cache = SceneCache(discover_scene(run), resize_size=run.resize_size)
    texture = load_texture_npz(os.path.join(log_dir, "texture.npz"),
                               device="cpu")
    cpu_dir = os.path.join(log_dir, "cpu")
    frames = render_styled_frames(texture, cache, os.path.join(cpu_dir, "styled"))
    worst, differing = 0, 0
    for path in frames:
        a = np.asarray(Image.open(path), np.int16)
        b = np.asarray(Image.open(os.path.join(
            log_dir, "styled", os.path.basename(path))), np.int16)
        worst = max(worst, int(np.abs(a - b).max()))
        differing += int((a != b).any(-1).sum())
    results = eval_reprojection_consistency(
        cache, os.path.join(log_dir, "styled"), out_dir=cpu_dir, seed=42,
        lpips_fn=build_lpips(run.vgg_model_path, device="cpu"),
        save_images=False, device="cpu")
    (card_json,) = [f for f in os.listdir(log_dir) if f.endswith("_output.json")]
    with open(os.path.join(log_dir, card_json)) as f:
        card = json.load(f)
    if card["pairs"] != results["pairs"]:
        raise RuntimeError(f"[{tag}] the CPU eval drew other pairs")
    gaps = {k: abs(card["accuracies"][k] - v) / abs(v)
            for k, v in results["accuracies"].items()}
    log(f"[{tag} on the CPU] render: max |card - cpu| {worst}/255, "
        f"{differing} pixels differ; eval relative gaps {json.dumps(gaps)} "
        f"({time.perf_counter() - t0:.3f} s)")
    if worst > 1 or any(g > (1e-3 if k.endswith("_lpips") else 1e-4)
                        for k, g in gaps.items()):
        raise RuntimeError(f"[{tag}] the card's post chain differs from "
                           f"the CPU's")
    return dict(render_max_diff=worst, eval_gaps=gaps)


class _Tee(io.StringIO):
    """Keeps what is written and passes it on to ``out``."""

    def __init__(self, out):
        super().__init__()
        self.out = out

    def write(self, text):
        self.out.write(text)
        return super().write(text)


def conv1_1_only(prof):
    """Raise unless every library convolution op of the profile (forward or
    backward) is conv1_1's: its weight [64, 3, 3, 3] among the op's input
    shapes."""
    seen, bad = [], []
    for e in prof.key_averages(group_by_input_shape=True):
        if not (e.key.startswith("aten::") and "conv" in e.key):
            continue
        shapes = [list(x) for x in e.input_shapes if x]
        (seen if [64, 3, 3, 3] in shapes else bad).append(f"{e.key} {shapes}")
    for line in seen:
        log(f"[k9] conv1_1 op: {line}")
    if bad:
        raise RuntimeError(f"the K9 step ran other library convolutions: {bad}")
    if not seen:
        raise RuntimeError("the K9 step's profile shows no conv1_1 op")


def k9_step(pipe, state, batch, aux):
    """The bench step under the K9 settings: profiled once (conv routes;
    the eager step, whose ops the profile names), then timed over STEPS
    steps (the first captures the K9 route's graphs). Returns K9's
    launches per step."""
    from torch.profiler import ProfilerActivity, profile

    reset_counts()
    pipe.train_step(state, batch, aux)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        pipe.eager_step(state, batch, aux)
        torch.cuda.synchronize()
    conv1_1_only(prof)
    t0 = time.perf_counter()
    for _ in range(STEPS):
        losses = pipe.train_step(state, batch, aux)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / STEPS * 1e3
    counts = read_counts()
    if not all(math.isfinite(float(v)) for v in losses.values()):
        raise RuntimeError("non-finite loss in the K9 bench step")
    log(f"[k9] bench step on the unfused trunk: {step_ms:.3f} ms "
        f"({STEPS * batch.num_views / (step_ms * STEPS / 1e3):.3f} views/s); "
        f"K9 {counts['K9_conv3x3_mxu']} launches in {STEPS + 2} steps")
    if counts["K9_conv3x3_mxu"] == 0 or any(counts[k] for k in TRUNK_KERNELS):
        raise RuntimeError(f"the K9 bench step launched {counts}")
    return counts["K9_conv3x3_mxu"] / (STEPS + 2)


def run_loop_phases(pipe, state, batch, aux, smi):
    """Phases 4, 5 and 6; returns {kernel: (launches, launches per step)}
    for the kernels these runs drive first: K1/K2's bf16 mode (the CLI run),
    K9 (the K9 CLI run; per step from the K9 bench step, since the run's
    count also holds the style targets', content targets' and validation's
    launches) and the banded K1/K2 (rank 0 of the atlas runs); and
    {kernel: (launches, None)} for K1 in the post chain (the CLI run, by
    phase: the render, the eval's warps), whose launches per call
    :func:`kernel_phase` measures."""
    with tempfile.TemporaryDirectory(prefix="stylemesh_chip_smoke_") as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        style = write_scene(root)
        log(f"[run] scene written in {time.perf_counter() - t0:.3f} s")
        run = cli_run("run", root, style, 2, RUN_KERNELS,
                      forbidden=("K9_conv3x3_mxu",), extra=["--tb_logs"],
                      post=True)
        log(f"[post] {json.dumps(run['post']['phases'])} | {smi}")
        post_chain_on_cpu("run", run["argv"], run["log_dir"])
        train = run["train"]
        launches = {k: (run["counts"][k], train["train_launches"][key]
                        / train["train_steps"])
                    for k, key in (("K1_gather_bf16", "gather_bf16"),
                                   ("K2_splat_bf16", "splat_bf16"))}
        for k, phase, key in (
                ("K1_gather_post_render", "post_render", "gather"),
                ("K1_gather_warp", "post_eval", "gather_each")):
            launches[k] = (run["post"]["launches"][phase][key], None)
        os.environ.update(K9_ENV)
        try:
            run = cli_run("k9", root, style, 1, ("K9_conv3x3_mxu",),
                          forbidden=TRUNK_KERNELS)
            launches["K9_conv3x3_mxu"] = (run["counts"]["K9_conv3x3_mxu"],
                                          k9_step(pipe, state, batch, aux))
        finally:
            for k in K9_ENV:
                os.environ.pop(k, None)
        launches.update(multi_device_phases(root, style))
    return launches


# ---------------------------------------------------------------- phase 6

TORCHRUN_TIMEOUT_S = 420
RANK_LINE = re.compile(r"\[rank (\d+)/\d+\] (?=\{)")
UNBANDED = ("gather", "gather_bf16", "splat", "splat_bf16")


def torchrun(tag, argv, nproc):
    """The CLI on ``nproc`` ranks; returns each rank's closing line
    (run_training's JSON: backend, device, train-step launches, Gram cache
    count, memory) and the ranks' output. Raises when a rank fails. The
    ranks are killed with their launcher at the time limit."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(nproc), "-m", "stylemesh_tpu_torch.cli",
           *argv]
    log(f"[{tag}] " + " ".join(cmd[1:]))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=TORCHRUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        log(out[-6000:])
        raise RuntimeError(f"[{tag}] did not finish in {TORCHRUN_TIMEOUT_S} s")
    wall_s = time.perf_counter() - t0
    for line in out.splitlines():
        if line.startswith("[rank") or line.startswith("epoch"):
            log(f"[{tag}] {line}")
    if proc.returncode != 0:
        log(out[-6000:])
        raise RuntimeError(f"[{tag}] exited with {proc.returncode}")
    ranks = rank_lines(out)
    if sorted(ranks) != list(range(nproc)):
        raise RuntimeError(f"[{tag}] closing lines of ranks {sorted(ranks)}")
    log(f"[{tag}] {nproc} ranks in {wall_s:.3f} s")
    return ranks, out


def rank_lines(out):
    """Each rank's closing JSON line in a run's output, by rank."""
    decoder = json.JSONDecoder()
    return {int(m.group(1)): decoder.raw_decode(out, m.end())[0]
            for m in RANK_LINE.finditer(out)}


def compare_first_step(tag, log_dir, ref_losses, rtol=1e-4, key_map=None):
    got = first_step_losses(log_dir)
    for k, want in ref_losses.items():
        v = got[(key_map or {}).get(k, k)]
        rel = abs(v - want) / max(abs(want), 1e-30)
        log(f"[{tag}] step 1 {k}: {v!r} vs one rank {want!r} (rel {rel:.3e})")
        if not rel <= rtol:
            raise RuntimeError(f"[{tag}] step 1 {k} differs from one rank")


def check_ranks(tag, ranks, launched, not_launched):
    """Each rank on a card, over NCCL when every rank has a card of its own
    and gloo otherwise (a single rank: no backend); the sampling kernels it
    launched in its train steps: each of ``launched`` once a step, and a
    gather launch for every splat launch of each mode."""
    backend = ("nccl" if len(ranks) <= torch.cuda.device_count() else "gloo")
    for r, line in sorted(ranks.items()):
        counts, steps = line["train_launches"], line["train_steps"]
        if (len(ranks) > 1 and line["backend"] != backend
                or not line["device"].startswith("cuda")):
            raise RuntimeError(f"[{tag}] rank {r} ran on {line}, "
                               f"expected {backend}")
        for k in launched:
            if counts[k] != steps:
                raise RuntimeError(f"[{tag}] rank {r} launched {k} "
                                   f"{counts[k]} times in {steps} steps")
        for k in not_launched:
            if counts[k] != 0:
                raise RuntimeError(f"[{tag}] rank {r} launched {k} "
                                   f"{counts[k]} times")
        for k in counts:
            if k.startswith("splat") and counts[k] != counts[
                    k.replace("splat", "gather")]:
                raise RuntimeError(f"[{tag}] rank {r}: {counts}, not one "
                                   f"gather launch per splat launch")


def check_export(tag, log_dir, ref_dir):
    """The exported texture has the one-rank run's full shapes and is
    finite; its normwise distance from the one-rank export is printed."""
    got = np.load(os.path.join(log_dir, "texture.npz"))
    want = np.load(os.path.join(ref_dir, "texture.npz"))
    if got.files != want.files:
        raise RuntimeError(f"[{tag}] texture.npz holds {got.files}")
    for k in want.files:
        a, b = got[k], want[k]
        if a.shape != b.shape or not np.isfinite(a).all():
            raise RuntimeError(f"[{tag}] {k}: shape {a.shape}, finite "
                               f"{np.isfinite(a).all()}")
        dist = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
        log(f"[{tag}] texture {k} {a.shape}: normwise distance from one "
            f"rank {dist:.3e}")


def extra_styles(root, n):
    """``n`` random style images besides phase 4's."""
    from PIL import Image

    paths = []
    for i in range(n):
        paths.append(str(root / f"style{i + 2}.jpg"))
        Image.fromarray(np.random.default_rng(i + 1).integers(
            0, 256, (480, 600 + 8 * i, 3), dtype=np.uint8)).save(paths[-1])
    return paths


def multi_device_phases(root, style, nproc=2):
    """Phase 6 on the scene of phase 4, over ``nproc`` ranks. Returns the
    banded K1/K2's launches (rank 0 of the atlas runs) and launches per
    train step."""
    one = cli_run("one_rank", root, style, 1, RUN_KERNELS,
                  extra=["--shard_atlas"])
    ref = first_step_losses(one["log_dir"])
    launches = {}
    for tag, mode, names in (
            ("atlas", "bf16", ("K1_gather_banded_bf16", "K2_splat_banded_bf16")),
            ("atlas_f32", "f32", ("K1_gather_banded", "K2_splat_banded"))):
        extra = ["--shard_atlas"] + (["--kernel_compute", "f32"]
                                     if mode == "f32" else [])
        # the f32 run ends with the post chain, on rank 0 alone
        ranks, out = torchrun(tag, cli_argv(tag, root, style, 1, extra,
                                            post=mode == "f32"), nproc)
        suffix = "_bf16" if mode == "bf16" else ""
        check_ranks(tag, ranks, ("gather_banded" + suffix,
                                 "splat_banded" + suffix), UNBANDED)
        log_dir = str(root / f"runs_{tag}" / "version_0")
        result = run_result(tag, log_dir)
        log(f"[{tag}] " + json.dumps(result))
        if mode == "bf16":  # the one-rank run is the CLI's bf16 mode
            compare_first_step(tag, log_dir, ref)
        else:
            check_post(tag, log_dir, out)
        check_export(tag, log_dir, one["log_dir"])
        steps = ranks[0]["train_steps"]
        for name, key in zip(names, ("gather_banded" + suffix,
                                     "splat_banded" + suffix)):
            n = ranks[0]["train_launches"][key]
            launches[name] = (n, n / steps)

    ranks, _ = torchrun("dp", cli_argv("dp", root, style, 1,
                                       ["--data_parallel"]), nproc)
    check_ranks("dp", ranks, ("gather_bf16", "splat_bf16"),
                ("gather_banded_bf16", "splat_banded_bf16"))
    log_dir = str(root / "runs_dp" / "version_0")
    log("[dp] " + json.dumps(run_result("dp", log_dir)))
    compare_first_step("dp", log_dir, ref)

    dip = cli_run("dip_one_rank", root, style, 1,
                  ("K1_gather_bf16", "K2_splat_bf16"), preset="scannet_dip")
    count = int(dip["state"].gram_cache.count)
    ranks, _ = torchrun("dip", cli_argv("dip", root, style, 1,
                                        ["--data_parallel"],
                                        preset="scannet_dip"), nproc)
    log("[dip] " + json.dumps(run_result(
        "dip", str(root / "runs_dip" / "version_0"))))
    for r, line in ranks.items():
        log(f"[dip] rank {r}: Gram cache count {line['gram_cache_count']} "
            f"(one rank: {count})")
        if line["gram_cache_count"] != count:
            raise RuntimeError("[dip] the Gram cache count differs")

    # a sweep of 2 styles on one rank, then of one style per rank
    styles = extra_styles(root, max(nproc - 1, 1))
    sweep = cli_run("multistyle", root, style, 1, RUN_KERNELS,
                    extra=["--style_image_path", styles[0]],
                    exports=("texture_style0.npz", "texture_style1.npz"),
                    per_step=())  # a launch of each per style and step
    compare_first_step("multistyle", sweep["log_dir"],
                       {"total": ref["total"]},
                       key_map={"total": "total_style0"})
    sweep_ref = first_step_losses(sweep["log_dir"])
    ranks, _ = torchrun("multistyle_ranks", cli_argv(
        "multistyle_ranks", root, style, 1,
        [a for p in styles[:nproc - 1] for a in ("--style_image_path", p)]),
        nproc)
    check_ranks("multistyle_ranks", ranks, ("gather_bf16", "splat_bf16"),
                ("gather_banded_bf16", "splat_banded_bf16"))
    log_dir = str(root / "runs_multistyle_ranks" / "version_0")
    log("[multistyle_ranks] " + json.dumps(run_result(
        "multistyle_ranks", log_dir,
        [f"texture_style{s}.npz" for s in range(nproc)])))
    compare_first_step("multistyle_ranks", log_dir,
                       {k: sweep_ref[k] for k in ("total_style0",
                                                  "total_style1")})
    return launches


# ---------------------------------------------------------------- phase 3


def bound_ms(bytes_moved, flops=0.0):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_flops = flops / BF16_FLOP_PER_S * 1e3
    return max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops else "operations")


def check(name, got, want, where=""):
    """Kernel output(s) against the plain version's. With ``max_share`` in
    the kernel's spec, that share of the elements may lie beyond the
    tolerance."""
    got = [got] if torch.is_tensor(got) else got
    want = [want] if torch.is_tensor(want) else want
    spec = KERNELS[name]
    scale = max(w.float().abs().max().item() for w in want)
    tol = spec["rel_tol"] * scale
    diffs = [(g.float() - w.float()).abs() for g, w in zip(got, want)]
    err = max(d.max().item() for d in diffs)
    share = (sum((d > tol).sum().item() for d in diffs)
             / sum(d.numel() for d in diffs))
    log(f"[kernel] {name} {where}: max_abs_err {err:.6g} tol {tol:.6g} "
        f"share beyond {share:.3g}")
    if not share <= spec.get("max_share", 0.0):
        raise RuntimeError(f"{name} disagrees with its plain version")
    return err, tol


def same_bits(what, got, want):
    """Raise unless two kernel outputs are equal bit for bit."""
    if not torch.equal(got, want):
        raise RuntimeError(f"{what}: not equal bit for bit")


def same_as_k9(where, x, w9, y):
    """Raise unless K9 on ``(x, w9)`` equals ``y``, K5's output without bias
    and relu, bit for bit (the two wrappers share one C entry)."""
    if not torch.equal(conv_kernels.conv3x3_mxu(x, w9), y):
        raise RuntimeError(f"K5 (no bias, no relu) and K9 differ at {where}")


def touched_texels(grid, layers, row0s=None, heights=None):
    """Distinct texels the grid's corners read, over the layers; for bands
    (``row0s``, ``heights`` of the full layers) only those in the band."""
    total = 0
    for l, layer in enumerate(layers):
        h = layer.shape[0] if heights is None else heights[l]
        row0 = 0 if row0s is None else row0s[l]
        iy0, iy1, ix0, ix1, _, _ = gs.corner_indices_weights(
            grid, h, layer.shape[1])
        w = layer.shape[1]
        idx = torch.cat([(iy * w + ix).reshape(-1) for iy, ix in
                         ((iy0, ix0), (iy0, ix1), (iy1, ix0), (iy1, ix1))])
        rows = idx // w
        idx = idx[(rows >= row0) & (rows < row0 + layer.shape[0])]
        total += torch.unique(idx).numel()
    return total


def bands_of(layers, rank, d):
    """Rank ``rank``'s row bands of every layer when split into ``d``."""
    heights = [l.shape[0] for l in layers]
    row0s = [rank * h // d for h in heights]
    bands = [l[r:r + h // d].clone()  # a rank's own allocation
             for l, r, h in zip(layers, row0s, heights)]
    return bands, row0s, heights


def banded_checks(where, layers, grid, g, note):
    """The banded K1/K2 at one pyramid level, in both modes, for the 4 bands
    of D = 4: each band against its plain version, the bands' partials
    summed against the unbanded K1 and their gradients stacked against the
    unbanded K2."""
    shapes = [tuple(l.shape[:2]) for l in layers]
    for compute, k1, k2 in (("f32", "K1_gather_banded", "K2_splat_banded"),
                            ("bf16", "K1_gather_banded_bf16",
                             "K2_splat_banded_bf16")):
        total, parts = 0, [[] for _ in layers]
        for b in range(4):
            bands, row0s, heights = bands_of(layers, b, 4)
            bshapes = [tuple(x.shape[:2]) for x in bands]
            band = (row0s, heights)
            (out,) = gs.gather_levels(bands, [grid], compute, band)
            note(k1, check(k1, out, gs.gather_levels_plain(
                bands, [grid], compute, band)[0], f"{where} band {b} of 4"))
            total = total + out
            grads = gs.splat_levels([g], [grid], bshapes, compute, band)
            note(k2, check(k2, grads, gs.splat_levels_plain(
                [g], [grid], bshapes, compute, band),
                f"{where} band {b} of 4"))
            for acc, x in zip(parts, grads):
                acc.append(x)
        note(k1, check(k1, total, gs.gather_levels(layers, [grid], compute)[0],
                       f"{where} 4 bands summed vs K1"))
        note(k2, check(k2, [torch.cat(p) for p in parts],
                       gs.splat_levels([g], [grid], shapes, compute),
                       f"{where} 4 bands stacked vs K2"))
        del total, parts


def sampling_step(layers, grids, cots, add):
    """K1/K2 as the main path calls them, one launch over the step's levels:
    held against their plain versions and timed in both modes, unbanded and
    for rank 0's bands of D = 2. The yardsticks: ``F.grid_sample`` of every
    layer at every level (K1), one ``torch.autograd.grad`` over all the
    levels' ``F.grid_sample`` renders with PyTorch's accumulation of the
    levels' gradients (K2). Bounds: K1 the grids, outputs and touched
    texels; K2 the cotangents, the grid of the pixels whose cotangent is
    not all zero (the kernel reads no other) and the dense gradient written
    once."""
    where = f"step, {len(grids)} levels"
    shapes = [tuple(l.shape[:2]) for l in layers]
    npx = sum(g.numel() // 2 for g in grids)
    live_px = sum(int((c != 0).any(-1).sum()) for c in cots)
    log(f"[kernel] K2 {where}: {live_px} of {npx} pixels with a nonzero "
        f"cotangent")
    layers_cf = [l.permute(2, 0, 1)[None] for l in layers]
    opts = dict(mode="bilinear", padding_mode="border", align_corners=True)

    def library_gather():
        return [sum(F.grid_sample(x.expand(g.shape[0], -1, -1, -1), g, **opts)
                    for x in layers_cf) for g in grids]

    leaves = [x.detach().requires_grad_() for x in layers_cf]
    lib_renders = [sum(F.grid_sample(x.expand(g.shape[0], -1, -1, -1), g,
                                     **opts) for x in leaves) for g in grids]
    lib_cots = [c.permute(0, 3, 1, 2) for c in cots]

    def library_splat():
        return torch.autograd.grad(lib_renders, leaves, lib_cots,
                                   retain_graph=True)

    bands, row0s, heights = bands_of(layers, 0, 2)
    bshapes = [tuple(x.shape[:2]) for x in bands]
    band = (row0s, heights)
    runs = (
        ("", "unbanded", shapes,
         lambda c: gs.gather_levels(layers, grids, c),
         lambda c: gs.gather_levels_plain(layers, grids, c),
         lambda c: gs.splat_levels(cots, grids, shapes, c),
         lambda c: gs.splat_levels_plain(cots, grids, shapes, c),
         sum(touched_texels(g, layers) for g in grids)),
        ("_banded", "rank 0 of 2", bshapes,
         lambda c: gs.gather_levels(bands, grids, c, band),
         lambda c: gs.gather_levels_plain(bands, grids, c, band),
         lambda c: gs.splat_levels(cots, grids, bshapes, c, band),
         lambda c: gs.splat_levels_plain(cots, grids, bshapes, c, band),
         sum(touched_texels(g, bands, row0s, heights) for g in grids)))
    for suffix, at, tshapes, gather, gather_plain, splat, splat_plain, \
            touched in runs:
        f32_ms = {}
        for compute in ("f32", "bf16"):
            mode = "" if compute == "f32" else "_bf16"
            lib = compute == "f32" and not suffix
            for k, fn, plain, library, nbytes in (
                    (f"K1_gather{suffix}{mode}", gather, gather_plain,
                     library_gather, npx * (8 + 12) + 12 * touched),
                    (f"K2_splat{suffix}{mode}", splat, splat_plain,
                     library_splat,
                     npx * 12 + live_px * 8
                     + 12 * sum(a * b for a, b in tshapes))):
                err = check(k, fn(compute), plain(compute), f"{where} {at}")
                ms = add(k, f"{where} {at}", err, lambda f=fn, c=compute: f(c),
                         lambda f=plain, c=compute: f(c),
                         library if lib else None, nbytes,
                         f32_mode_ms=f32_ms.get(k[:2]))
                f32_ms.setdefault(k[:2], ms)
    del lib_renders, leaves


def update_step(pipe, state, add):
    """The one-pass update on copies of the bench state's layers and
    moments, from a gradient a third of whose elements are exactly zero
    (texels no view touched), at step 0's scalars, the bench
    configuration's regularizer coefficients folded in: held against its
    plain version (p, m and v each, and the share of elements equal bit for
    bit, which must be all), then timed. Bound: p, g, m and v read, p, m
    and v written, once. Then the regularizer's value against a float64
    sum, and timed. Bound: the layers read once."""
    layers = [l.detach().clone() for l in state.texture.layers]
    mus = [m.clone() for m in state.mu]
    nus = [v.clone() for v in state.nu]
    gen = torch.Generator(device="cuda").manual_seed(21)
    grads = [torch.randn(l.shape, generator=gen, device="cuda")
             * (torch.rand(l.shape, generator=gen, device="cuda") > 1 / 3)
             for l in layers]
    scalars = torch.tensor([1.0, 1.0 - adam_kernels.ADAM_B1,
                            1.0 - adam_kernels.ADAM_B2], device="cuda")
    coefs = pipe.config.tex_reg_coefficients()
    ref = [[t.clone() for t in ts] for ts in (layers, mus, nus)]
    adam_kernels.adam_clamp_(layers, grads, mus, nus, scalars, coefs)
    adam_kernels.adam_clamp_plain_(ref[0], grads, ref[1], ref[2], scalars,
                                   coefs)
    err, tol = 0.0, 0.0
    for what, got, want in zip("pmv", (layers, mus, nus), ref):
        e, t = check("update", got, want, f"bench atlas, {what}")
        err, tol = max(err, e), max(tol, t)
    n = sum(l.numel() for l in layers)
    same = sum(int((g == w).sum()) for got, want in zip((layers, mus, nus), ref)
               for g, w in zip(got, want))
    log(f"[kernel] update bench atlas: {same / (3 * n):.6f} of p, m and v "
        f"equal bit for bit")
    if same != 3 * n:
        raise RuntimeError("update: not equal bit for bit to its plain version")
    add("update", "bench atlas", (err, tol),
        lambda: adam_kernels.adam_clamp_(layers, grads, mus, nus, scalars,
                                         coefs),
        lambda: adam_kernels.adam_clamp_plain_(ref[0], grads, ref[1], ref[2],
                                               scalars, coefs),
        None, 28 * n)
    weights = pipe.config.resolved_tex_reg_weights()
    value = adam_kernels.tex_reg_value(layers, weights)
    same_bits("tex_reg_value, two calls", value,
              adam_kernels.tex_reg_value(layers, weights))
    want = sum(w * (l.double() ** 2).mean() for w, l in zip(weights, layers))
    add("tex_reg_value", "bench atlas",
        check("tex_reg_value", value, want.float(), "bench atlas"),
        lambda: adam_kernels.tex_reg_value(layers, weights),
        lambda: adam_kernels.tex_reg_value_plain(layers, weights),
        None, 4 * n)


def cotangent(like, mask=None, seed=0):
    """A random bf16 cotangent shaped as ``like``, zero where ``mask`` is
    False."""
    gen = torch.Generator(device=like.device).manual_seed(seed)
    g = torch.randn(like.shape, generator=gen, device=like.device)
    g = g.to(torch.bfloat16)
    return g if mask is None else torch.where(mask, g, torch.zeros_like(g))


def trunk_kernels(where, pipe, pred, add):
    """K5-K8 at one pyramid level: the trunk walked as ``vgg_features``
    walks it for the loss's layers (``vgg._routes``), each kernel launch of
    the step's forward and backward repeated on its inputs (random
    cotangents, masked as the backward masks them) and held against its
    plain version. Where a conv's input gradient finishes its input's
    cotangent (``vgg._finishes``), the finishing variant is checked: K5
    with the input's relu mask and, where the input is a loss tap, the
    tap's cotangent; K8 with the tap's cotangent."""
    nchw = lambda t: t.permute(0, 3, 1, 2)  # noqa: E731
    keys = pipe.loss.layers
    last = max(i for i, (name, _) in enumerate(vgg._TRUNK) if name in keys)
    h = pred.to(torch.bfloat16).contiguous()
    routes = vgg._routes(tuple(h.shape), keys, last, "max")
    for i, (name, conv) in enumerate(vgg._TRUNK[:last + 1]):
        if routes[i] == "pool":
            h = vgg._pool_nhwc(h, "max")
        if conv is None:
            continue
        p = pipe.vgg_params[conv]
        w9, w9t, b = vgg.kernel_layout(p)
        w_lib = p["weight"].to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        wt_lib = p["weight"].flip(2, 3).transpose(0, 1).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        b_lib = b.to(torch.bfloat16)
        v, hh, ww, cin = h.shape
        cout = w9.shape[1]
        flops = 2.0 * 9 * cin * cout * v * hh * ww
        at = f"{where} {conv} {tuple(h.shape)}->{cout}"
        if routes[i] == "stem":  # conv1_1: the stem kernels
            h = stem_kernels(at, h, w9, b, w_lib, b_lib, flops, i, add)
            continue
        # the input's relu mask, and its tap's cotangent where it is a tap
        m = h if vgg._finishes(routes, i) else None
        t = (cotangent(h, seed=100 + i)
             if m is not None and vgg._TRUNK[i - 1][0] in keys else None)
        x_bytes, w_bytes = h.numel() * 2, w9.numel() * 2
        if routes[i] == "tail":
            library = lambda x=h: F.max_pool2d(F.relu(F.conv2d(  # noqa: E731
                nchw(x), w_lib, b_lib, padding=1)), 2)
            y = conv_kernels.conv3x3(h, w9, b, relu=True)  # K5's relu output
            if cin == 64:
                pooled = head_kernels.conv_relu_pool(h, w9, b)
                err = check("K6_conv_relu_pool", pooled,
                            head_kernels.conv_relu_pool_plain(h, w9, b), at)
                same_bits(f"K6 vs maxpool2(K5) at {at}", pooled,
                          head_kernels.maxpool2(y))
                add("K6_conv_relu_pool", at, err,
                    lambda x=h: head_kernels.conv_relu_pool(x, w9, b),
                    lambda x=h: head_kernels.conv_relu_pool_plain(x, w9, b),
                    library, x_bytes + w_bytes + 4 * cout
                    + pooled.numel() * 2, flops)
                switched, codes = head_kernels.conv_relu_pool(
                    h, w9, b, with_codes=True)
                err = check("K6_conv_relu_pool_codes", switched,
                            head_kernels.conv_relu_pool_plain(h, w9, b), at)
                same_bits(f"K6 with codes vs K6 at {at}", switched, pooled)
                same_bits(f"K6's codes vs the plain rule on K5 at {at}", codes,
                          head_kernels.pool_codes_plain(y))
                add("K6_conv_relu_pool_codes", at, err,
                    lambda x=h: head_kernels.conv_relu_pool(
                        x, w9, b, with_codes=True),
                    lambda x=h: head_kernels.conv_relu_pool_plain(
                        x, w9, b, with_codes=True),
                    library, x_bytes + w_bytes + 4 * cout
                    + pooled.numel() * 2 + codes.numel() * 4, flops)
                del switched
                g = cotangent(pooled, seed=i)
                hw = tuple(h.shape[1:3])
                dx = head_kernels.conv_relu_pool_bwd(codes, g, w9t, hw, t)
                err = check("K8_conv_relu_pool_bwd", dx,
                            head_kernels.conv_relu_pool_bwd_plain(
                                codes, g, w9t, hw, t), at)
                k5_routed = conv_kernels.conv3x3(
                    head_kernels.pool_route_plain(y, g), w9t)
                same_bits(f"K8 vs K5 on the routed cotangent"
                          f"{'' if t is None else ', + t'} at {at}", dx,
                          k5_routed if t is None else k5_routed + t)
                del dx, k5_routed
                x_leaf = nchw(h).detach().requires_grad_()
                lib_out = F.max_pool2d(F.relu(F.conv2d(
                    x_leaf, w_lib, b_lib, padding=1)), 2)
                # bytes: the codes and g read, dx written (t read), w9t
                add("K8_conv_relu_pool_bwd",
                    at + ("" if t is None else " with t"), err,
                    lambda: head_kernels.conv_relu_pool_bwd(
                        codes, g, w9t, hw, t),
                    lambda: head_kernels.conv_relu_pool_bwd_plain(
                        codes, g, w9t, hw, t),
                    lambda: torch.autograd.grad(
                        lib_out, x_leaf, nchw(g), retain_graph=True),
                    codes.numel() * 4 + g.numel() * 2 + x_bytes + w_bytes
                    + (0 if t is None else x_bytes), flops)
                del x_leaf, lib_out
                h = pooled
            else:
                pooled, pre = head_kernels.conv_relu_pool(h, w9, b, with_pre=True)
                err = check("K7_conv_relu_pool_dual", [pooled, pre],
                            head_kernels.conv_relu_pool_plain(h, w9, b, True), at)
                same_bits(f"K7's pre-pool map vs K5 at {at}", pre, y)
                same_bits(f"K7's pooled map vs K6 at {at}", pooled,
                          head_kernels.conv_relu_pool(h, w9, b))
                add("K7_conv_relu_pool_dual", at, err,
                    lambda x=h: head_kernels.conv_relu_pool(
                        x, w9, b, with_pre=True),
                    lambda x=h: head_kernels.conv_relu_pool_plain(
                        x, w9, b, True),
                    library, x_bytes + w_bytes + 4 * cout
                    + (pooled.numel() + pre.numel()) * 2, flops)
                # its backward: pool routing from pre, then K5 (flipped)
                g = cotangent(pooled, seed=i)
                dr = head_kernels.pool_route(pre, g)
                dr_plain = head_kernels.pool_route_plain(pre, g)
                err = check("pool_route", dr, dr_plain, at)
                same_bits(f"pool_route vs its plain version at {at}",
                          dr.view(torch.int16), dr_plain.view(torch.int16))
                del dr_plain
                log(f"[kernel] pool_route {at}: bit for bit")
                add("pool_route", at, err,
                    lambda: head_kernels.pool_route(pre, g),
                    lambda: head_kernels.pool_route_plain(pre, g), None,
                    2 * pre.numel() * 2 + g.numel() * 2)
                k5_backward(at, dr, w9t, wt_lib, flops, add, m, t)
                h = pooled
            del y
            continue
        y = conv_kernels.conv3x3(h, w9, b, relu=True)
        err = check("K5_conv3x3", y, conv_kernels.conv3x3_plain(h, w9, b, True), at)
        add("K5_conv3x3", at + " forward", err,
            lambda x=h: conv_kernels.conv3x3(x, w9, b, True),
            lambda x=h: conv_kernels.conv3x3_plain(x, w9, b, True),
            lambda x=h: F.relu(F.conv2d(nchw(x), w_lib, b_lib, padding=1)),
            x_bytes + w_bytes + 4 * cout + y.numel() * 2, flops)
        k5_backward(at, cotangent(y, y > 0, seed=i), w9t, wt_lib, flops, add,
                    m, t)
        h = y


def bf16_ulp(v):
    """The spacing of bf16 numbers at ``|v|`` (float32; 2^(e - 7) for |v|
    in [2^e, 2^(e + 1)))."""
    e = torch.floor(torch.log2(v.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def check_ulps(name, got, want, where):
    """Raise unless every element of ``got`` lies within one bf16 ulp of
    ``want``'s: the ulp of the larger of the two, or of 2^-9 of the largest
    plain value where the element is smaller. Logs and returns the largest
    difference in bf16 ulps of the element itself (no floor), and logs how
    many elements lie beyond one such ulp and their largest value."""
    g, w = got.float(), want.float()
    d = (g - w).abs()
    ulp = bf16_ulp(torch.maximum(g.abs(), w.abs()))
    floor = bf16_ulp(w.abs().max()) * 2.0 ** -9
    ulps = (d / ulp).max().item()
    beyond = d > ulp
    n_beyond = int(beyond.sum().item())
    at_most = (torch.maximum(g.abs(), w.abs())[beyond].max().item()
               if n_beyond else 0.0)
    floored = (d / torch.maximum(ulp, floor)).max().item()
    log(f"[kernel] {name} {where}: largest difference {ulps:.4g} bf16 ulps "
        f"of the element; {n_beyond} of {d.numel()} elements beyond one ulp, "
        f"all of |value| <= {at_most:.4g} (floor ulp {floor.item():.4g}: "
        f"{floored:.4g})")
    if not floored <= 1.0:
        raise RuntimeError(f"{name} lies beyond one bf16 ulp of its plain "
                           f"version")
    return ulps


def stem_kernels(at, x, w9, b, w_lib, b_lib, flops, seed, add):
    """conv1_1's stem kernels at one level, as the step runs them: the
    forward (bias, relu) and the input gradient of a random cotangent
    (masked by y > 0 in the kernel), each against its plain version (the
    im2col product, the input gradient's on the kernel's y, so that both
    apply one relu mask) and timed beside it and beside cuDNN's conv of the
    same function. Returns the kernel's y."""
    nchw = lambda t: t.permute(0, 3, 1, 2)  # noqa: E731
    y = conv_im2col.stem_forward(x, w9, b)
    want = conv_im2col.stem_forward_plain(x, w9, b)
    add("stem_fwd", at + " forward",
        check("stem_fwd", y, want, at) + (check_ulps("stem_fwd", y, want, at),),
        lambda: conv_im2col.stem_forward(x, w9, b),
        lambda: conv_im2col.stem_forward_plain(x, w9, b),
        lambda: F.relu(F.conv2d(nchw(x), w_lib, b_lib, padding=1)),
        x.numel() * 2 + w9.numel() * 2 + b.numel() * 4 + y.numel() * 2, flops)
    g = cotangent(y, seed=seed)
    dx = conv_im2col.stem_backward(g, y, w9)
    want = conv_im2col.stem_backward_plain(g, y, w9)
    lib_leaf = nchw(x).detach().requires_grad_()
    lib_out = F.relu(F.conv2d(lib_leaf, w_lib, b_lib, padding=1))
    add("stem_bwd", at + " input gradient",
        check("stem_bwd", dx, want, at) + (check_ulps("stem_bwd", dx, want,
                                                      at),),
        lambda: conv_im2col.stem_backward(g, y, w9),
        lambda: conv_im2col.stem_backward_plain(g, y, w9),
        lambda: torch.autograd.grad(lib_out, [lib_leaf], nchw(g),
                                    retain_graph=True),
        g.numel() * 2 + y.numel() * 2 + w9.numel() * 2 + dx.numel() * 2,
        flops)
    return y


def k5_backward(at, g, w9t, wt_lib, flops, add, m=None, t=None):
    """K5 as an input gradient: the masked cotangent, the flipped kernel, no
    bias, relu off. With ``m``, the variant that finishes the cotangent of
    its input ``m``, a relu output (its mask, and the tap's cotangent ``t``
    if given), against its plain version and, bit for bit, against the
    passes it replaces: K5, the bf16 sum with ``t``, the mask."""
    if m is None:
        dx = conv_kernels.conv3x3(g, w9t)
        err = check("K5_conv3x3", dx, conv_kernels.conv3x3_plain(g, w9t), at)
        same_as_k9(at + " input gradient", g, w9t, dx)
        add("K5_conv3x3", at + " input gradient", err,
            lambda: conv_kernels.conv3x3(g, w9t),
            lambda: conv_kernels.conv3x3_plain(g, w9t),
            lambda: F.conv2d(g.permute(0, 3, 1, 2), wt_lib, padding=1),
            g.numel() * 2 + w9t.numel() * 2 + dx.numel() * 2, flops)
        return
    dx = conv_kernels.conv3x3_masked(g, w9t, m, t)
    err = check("K5_conv3x3", dx,
                conv_kernels.conv3x3_masked_plain(g, w9t, m, t), at)
    k5 = conv_kernels.conv3x3(g, w9t)
    same_bits(f"K5's finishing input gradient vs its passes at {at}", dx,
              conv_kernels.relu_mask(k5 if t is None else k5 + t, m))
    del k5
    m_nchw = m.permute(0, 3, 1, 2)
    t_nchw = None if t is None else t.permute(0, 3, 1, 2)

    def library():
        y = F.conv2d(g.permute(0, 3, 1, 2), wt_lib, padding=1)
        return conv_kernels.relu_mask(y if t is None else y + t_nchw, m_nchw)

    add("K5_conv3x3", at + (" input gradient, masked" if t is None
                            else " input gradient, masked, with t"), err,
        lambda: conv_kernels.conv3x3_masked(g, w9t, m, t),
        lambda: conv_kernels.conv3x3_masked_plain(g, w9t, m, t),
        library,
        g.numel() * 2 + w9t.numel() * 2 + dx.numel() * 2 + m.numel() * 2
        + (0 if t is None else t.numel() * 2), flops)


def k9_kernels(where, pipe, pred, add):
    """K9 at one pyramid level: the unfused trunk walked as ``vgg_features``
    walks it under the K9 settings for the loss's layers; every conv with
    Cin >= 64 forward, and as an input gradient (flipped kernel) of a random
    cotangent masked by the relu, against its plain version."""
    nchw = lambda t: t.permute(0, 3, 1, 2)  # noqa: E731
    keys = pipe.loss.layers
    last = max(i for i, (name, _) in enumerate(vgg._TRUNK) if name in keys)
    h = pred.to(torch.bfloat16).contiguous()
    for i, (name, conv) in enumerate(vgg._TRUNK[:last + 1]):
        if conv is None:
            h = vgg._pool_nhwc(h, "max")
            continue
        p = pipe.vgg_params[conv]
        if h.shape[-1] < 64:  # conv1_1 stays on the library conv
            with torch.no_grad():
                h = torch.relu(vgg._conv3x3(h, p, "default"))
            continue
        w9, w9t, _ = vgg.kernel_layout(p)
        w_lib = p["weight"].to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        wt_lib = p["weight"].flip(2, 3).transpose(0, 1).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        v, hh, ww, cin = h.shape
        cout = w9.shape[1]
        flops = 2.0 * 9 * cin * cout * v * hh * ww
        at = f"{where} {conv} {tuple(h.shape)}->{cout}"
        y = conv_kernels.conv3x3_mxu(h, w9)
        err = check("K9_conv3x3_mxu", y, conv_kernels.conv3x3_mxu_plain(h, w9), at)
        same_as_k9(at + " forward", h, w9, conv_kernels.conv3x3(h, w9))
        add("K9_conv3x3_mxu", at + " forward", err,
            lambda x=h: conv_kernels.conv3x3_mxu(x, w9),
            lambda x=h: conv_kernels.conv3x3_mxu_plain(x, w9),
            lambda x=h: F.conv2d(nchw(x), w_lib, padding=1),
            h.numel() * 2 + w9.numel() * 2 + y.numel() * 2, flops)
        h = torch.relu(y + p["bias"].to(torch.bfloat16))
        g = cotangent(h, h > 0, seed=i)
        dx = conv_kernels.conv3x3_mxu(g, w9t)
        err = check("K9_conv3x3_mxu", dx, conv_kernels.conv3x3_mxu_plain(g, w9t), at)
        same_as_k9(at + " input gradient", g, w9t, conv_kernels.conv3x3(g, w9t))
        add("K9_conv3x3_mxu", at + " input gradient", err,
            lambda: conv_kernels.conv3x3_mxu(g, w9t),
            lambda: conv_kernels.conv3x3_mxu_plain(g, w9t),
            lambda: F.conv2d(nchw(g), wt_lib, padding=1),
            g.numel() * 2 + w9t.numel() * 2 + dx.numel() * 2, flops)


def kernel_phase(pipe, state, batch, aux, launches):
    rows = {name: dict(ms=0.0, ms_min=0.0, ms_max=0.0, plain_ms=0.0,
                       library_ms=0.0, library_ms_min=0.0, library_ms_max=0.0,
                       f32_mode_ms=0.0, bound_ms=0.0, by_bytes=0.0, by_ops=0.0,
                       err=0.0, tol=0.0, flops=0.0, ulps=None)
            for name in KERNELS}

    def add(name, where, err_tol, fn, plain_fn, library_fn, nbytes, flops=0.0,
            f32_mode_ms=None):
        """Time one launch of the kernel (``fn``, median of REPS with min and
        max), its plain version (mean of PLAIN_REPS) and the library call
        (``library_fn``, like the kernel) and accumulate them; returns the
        kernel's median. Its bound is the larger of its bytes over HBM
        bandwidth and its flops over the bf16 peak. A bf16 mode has no
        library call computing its function (``library_fn`` None); it is
        timed beside its f32 mode instead. A third entry of ``err_tol`` is
        the largest difference in bf16 ulps (:func:`check_ulps`)."""
        ms, lo, hi = cuda_times(fn)
        plain_ms = cuda_ms(plain_fn)
        r = rows[name]
        r["err"] = max(r["err"], err_tol[0])
        r["tol"] = max(r["tol"], err_tol[1])
        if len(err_tol) > 2:
            r["ulps"] = max(r["ulps"] or 0.0, err_tol[2])
        r["ms"] += ms
        r["ms_min"] += lo
        r["ms_max"] += hi
        r["plain_ms"] += plain_ms
        if library_fn is None:
            r["library_ms"] = None
            if f32_mode_ms is not None:
                r["f32_mode_ms"] += f32_mode_ms
            other = ("library none" if f32_mode_ms is None
                     else f"f32 mode {f32_mode_ms:.4f}")
        else:
            lib, lib_lo, lib_hi = cuda_times(library_fn)
            r["library_ms"] += lib
            r["library_ms_min"] += lib_lo
            r["library_ms_max"] += lib_hi
            other = f"library {lib:.4f} ({lib_lo:.4f}-{lib_hi:.4f})"
        b_ms, b_by = bound_ms(nbytes, flops)
        r["bound_ms"] += b_ms
        r["by_bytes" if b_by == "bytes" else "by_ops"] += b_ms
        r["flops"] += flops
        rate = f", {flops / ms / 1e9:.1f} TFLOP/s" if flops else ""
        log(f"[kernel] {name} {where}: {ms:.4f} ms ({lo:.4f}-{hi:.4f}; bound "
            f"{b_ms:.4f} by {b_by}), plain {plain_ms:.4f}, {other}{rate}")
        return ms

    def note(name, err_tol):
        """Record a check's error of a kernel timed elsewhere."""
        r = rows[name]
        r["err"] = max(r["err"], err_tol[0])
        r["tol"] = max(r["tol"], err_tol[1])

    layers = [l.detach() for l in state.texture.layers]
    shapes = [tuple(l.shape[:2]) for l in layers]
    cots = []
    for i, grid in enumerate(batch.uv):
        v, h, w, _ = grid.shape
        with torch.no_grad():
            pred = sample_texture(state.texture, [grid])[0]
        trunk_kernels(f"level {i}", pipe, pred, add)
        k9_kernels(f"level {i}", pipe, pred, add)
        # K1 / K2 at this level alone, checked; timed at step level below.
        # The cotangent is zero where the level's gradient weight is zero, as
        # on the main path.
        gen = torch.Generator(device="cuda").manual_seed(i)
        g = torch.randn((v, h, w, 3), generator=gen, device="cuda")
        g = (g * aux.grad_weights[i]).contiguous()
        cots.append(g)
        for compute, mode in (("f32", ""), ("bf16", "_bf16")):
            note(f"K1_gather{mode}", check(
                f"K1_gather{mode}",
                gs.gather_levels(layers, [grid], compute)[0],
                gs.gather_levels_plain(layers, [grid], compute)[0],
                f"level {i}"))
            note(f"K2_splat{mode}", check(
                f"K2_splat{mode}",
                gs.splat_levels([g], [grid], shapes, compute),
                gs.splat_levels_plain([g], [grid], shapes, compute),
                f"level {i}"))
        banded_checks(f"level {i}", layers, grid, g, note)

        # K3 / K4 at the fused (level, layer) pairs
        fused = aux.loss_aux["gram_masks"][i]
        if not fused:
            continue
        with torch.no_grad():
            pred = sample_texture(state.texture, [grid])[0]
            encs = vgg_features(pipe.vgg_params, pred, list(fused),
                                compute_dtype=torch.bfloat16,
                                precision="default")
        for k, m in fused.items():
            f = encs[k].reshape(v, -1, encs[k].shape[-1]).contiguous()
            _, p, c = f.shape
            kk = m.shape[1]
            live_px = float(m.float().sum())
            # what this run's masks need: f is read only in pixel tiles
            # with a live mask (K3's of 64 pixels, K4's of 128), K4 writes
            # all of dF, and K3 computes the upper triangle of each Gram
            fwd_bytes = live_tile_px(m, gram_kernels._FWD_PX) * c * 2
            bwd_bytes = live_tile_px(m, 128) * c * 2
            log(f"[kernel] level {i} {k}: V={v} P={p} C={c} K={kk} "
                f"mask density {live_px / (v * kk * p):.3f}")
            err = check("K3_gram_fwd", gram_kernels.masked_gram_sums(f, m),
                        gram_kernels.masked_gram_sums_plain(f, m))
            # cuBLAS yardstick: one batched product over the V K masked
            # feature maps (made outside the timing)
            fm = (f[:, None] * m[..., None]).reshape(v * kk, p, c)
            fk = f[:, None].expand(v, kk, p, c).reshape(v * kk, p, c)
            add("K3_gram_fwd", f"level {i} {k}", err,
                lambda: gram_kernels.masked_gram_sums(f, m),
                lambda: gram_kernels.masked_gram_sums_plain(f, m),
                lambda: torch.bmm(fm.transpose(1, 2), fk,
                                  out_dtype=torch.float32),
                fwd_bytes + m.numel() * 2 + v * kk * c * c * 4,
                c * (c + 1) * live_px)
            del fm, fk
            gen = torch.Generator(device="cuda").manual_seed(100 + i)
            dg = torch.randn((v, kk, c, c), generator=gen, device="cuda")
            s = dg + dg.transpose(-1, -2)
            s16 = s.to(torch.bfloat16)
            err = check("K4_gram_bwd",
                        gram_kernels.masked_gram_sums_grad(f, m, s),
                        gram_kernels.masked_gram_sums_grad_plain(f, m, s))
            # [m_1 f | m_2 f] [S_1; S_2]: one product, bf16 out
            fcat = (f[:, None] * m[..., None]).permute(0, 2, 1, 3).reshape(
                v, p, kk * c)
            scat = s16.reshape(v, kk * c, c)
            add("K4_gram_bwd", f"level {i} {k}", err,
                lambda: gram_kernels.masked_gram_sums_grad(f, m, s),
                lambda: gram_kernels.masked_gram_sums_grad_plain(f, m, s),
                lambda: torch.bmm(fcat, scat),
                bwd_bytes + f.numel() * 2 + m.numel() * 2 + s16.numel() * 2,
                2.0 * c * c * live_px)
            del fcat, scat

    sampling_step(layers, list(batch.uv), cots, add)
    update_step(pipe, state, add)
    # the post chain's K1 launches in phase 4: its calls (the render's
    # chunks; per pairing and eval chunk, a colour and a mask warp) times
    # the launches measured in one call, one for each
    calls = {"K1_gather_post_render": -(-SCENE_VIEWS // RENDER_CHUNK),
             "K1_gather_warp": 3 * 2 * -(-SCENE_VIEWS // EVAL_CHUNK)}
    for name, per_call in post_chain_kernels(state.texture, batch.uv[-1],
                                             add).items():
        n = launches[name][0]
        if per_call != 1 or n != calls[name] * per_call:
            raise RuntimeError(f"{name}: {n} launches in the post chain, "
                               f"{calls[name]} calls of {per_call}")
        launches[name] = (n, per_call)
    out = []
    for name, spec in KERNELS.items():
        r = rows[name]
        n, per_unit = launches[name]
        row = dict(
            name=name, route="cuda", source=spec["source"],
            replaces=spec["replaces"], launches=n, launches_per_unit=per_unit,
            unit=spec.get("unit", "step"),
            max_abs_err=r["err"], tol=r["tol"], ms=r["ms"],
            kernel_ms=r["ms"], ms_min=r["ms_min"], ms_max=r["ms_max"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by="bytes" if r["by_bytes"] >= r["by_ops"] else "operations",
            library_ms=r["library_ms"])
        if r["library_ms"] is not None:
            row.update(library_ms_min=r["library_ms_min"],
                       library_ms_max=r["library_ms_max"])
        if r["flops"]:
            row["tflop_per_s"] = r["flops"] / r["ms"] / 1e9
        if r["ulps"] is not None:
            row["max_ulps"] = r["ulps"]
        if r["library_ms"] is None and name.endswith("_bf16"):
            row["f32_mode_ms"] = r["f32_mode_ms"]
        out.append(row)
    return out


WARP_HW = (256, 341)  # phase 4's content size: 480x640 at --resize_size 256
# warp-grid entries far outside [-1, 1]: where 1e-8 + z is 0 a projection
# is +-inf (NaN where its numerator is 0 too), and the border exactly
WARP_SPECIALS = (float("inf"), -float("inf"), float("nan"), 1e30, -1e30,
                 1.0, -1.0)


def post_chain_kernels(texture, top_level, add):
    """K1 (float32) at the post chain's shapes, through the post chain's own
    calls, against its plain version and timed: the render
    (``sample_texture`` under ``no_grad``, as ``render_styled_frames`` calls
    it, at RENDER_CHUNK views of the finest UV level, the bench batch's
    views repeated) and one warp of the eval (``project._warp``, as
    ``reproject`` calls it, of EVAL_CHUNK views' 3-channel images, each at
    its own grid, with 30% of the grid entries from WARP_SPECIALS: K1's
    per-view form, also held bit for bit against one launch of the
    shared-layer form per view, which the warps made before the per-view
    form, timed beside it). Returns {kernel: launches in one call}, read
    from the kernel's counter around one call of each. Yardsticks:
    ``F.grid_sample`` of every layer at the render grid; one
    ``F.grid_sample`` of the images at their grids. Bounds: grids, outputs
    and touched texels."""
    opts = dict(mode="bilinear", padding_mode="border", align_corners=True)
    layers = [l.detach() for l in texture.layers]
    grid = torch.cat([top_level] * -(-RENDER_CHUNK // top_level.shape[0]))
    grid = grid[:RENDER_CHUNK].contiguous()
    npx = grid.numel() // 2
    where = f"post render {tuple(grid.shape[:-1])}, {len(layers)} layers"
    layers_cf = [l.permute(2, 0, 1)[None] for l in layers]

    @torch.no_grad()
    def render():
        return sample_texture(texture, [grid])[0]

    def launches_of(fn, wrapper=gs.gather_levels):
        n0 = wrapper.launches
        fn()
        return wrapper.launches - n0

    per_call = {"K1_gather_post_render": launches_of(render)}
    err = check("K1_gather_post_render", render(),
                gs.gather_levels_plain(layers, [grid])[0], where)
    add("K1_gather_post_render", where, err, render,
        lambda: gs.gather_levels_plain(layers, [grid])[0],
        lambda: sum(F.grid_sample(x.expand(RENDER_CHUNK, -1, -1, -1), grid,
                                  **opts) for x in layers_cf),
        npx * (8 + 12) + 12 * touched_texels(grid, layers))
    del grid

    gen = torch.Generator(device="cuda").manual_seed(7)
    h, w = WARP_HW
    images = (torch.rand((EVAL_CHUNK, h, w, 3), generator=gen, device="cuda")
              - 0.45) * 255.0
    grids = torch.rand((EVAL_CHUNK, h, w, 2), generator=gen,
                       device="cuda") * 3.0 - 1.5
    pick = torch.rand(grids.shape, generator=gen, device="cuda") < 0.3
    idx = torch.randint(0, len(WARP_SPECIALS), grids.shape, generator=gen,
                        device="cuda")
    specials = torch.tensor(WARP_SPECIALS, device="cuda")
    grids = torch.where(pick, specials[idx], grids).contiguous()
    where = f"warp {EVAL_CHUNK} x {WARP_HW}, +-inf / NaN / huge / border"

    def warps():
        return project._warp(images, grids)

    def warps_plain():
        return gs.gather_each_plain(images, grids)

    def warps_library():
        return F.grid_sample(images.permute(0, 3, 1, 2), grids, **opts)

    def warps_shared():
        # the shared-layer form, one launch a view
        return torch.stack([gs.gather_levels([x], [g])[0]
                            for x, g in zip(images, grids)])

    per_call["K1_gather_warp"] = launches_of(warps, gs.gather_each)
    out = warps()
    if not torch.isfinite(out).all():
        raise RuntimeError("K1 gave a non-finite warp")
    err = check("K1_gather_warp", out, warps_plain(), where)
    same_bits("K1_gather_warp vs the shared-layer form a view", out,
              warps_shared())
    add("K1_gather_warp", where, err, warps, warps_plain, warps_library,
        sum(g.numel() // 2 * (8 + 12) + 12 * touched_texels(g, [x])
            for x, g in zip(images, grids)))
    ms, lo, hi = cuda_times(warps_shared)
    log(f"[kernel] K1_gather_warp as {EVAL_CHUNK} launches of the "
        f"shared-layer form: {ms:.4f} ms ({lo:.4f}-{hi:.4f})")
    log(f"[kernel] K1_gather_warp device time a call, queued back to back: "
        f"{device_ms_per_call(warps):.4f} ms; one F.grid_sample of the "
        f"images {device_ms_per_call(warps_library):.4f} ms")
    return per_call


SPIN_CYCLES = 50_000_000  # ~25 ms of the card's clock: longer than queuing


def device_ms_per_call(fn, reps=REPS):
    """The device time of one call of ``fn`` without the host's gaps: REPS
    calls queued behind a spin kernel (``torch.cuda._sleep``), so that the
    card runs them back to back, between two CUDA events, over the count.
    Raises when the spin ended before the host had queued every call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    if start.query():
        raise RuntimeError("the spin ended before the calls were queued")
    end.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------- phase 7

DEMO_VIEWS = 24                # tools/make_demo_scene.py's room
DEMO_BAKE_VIEWS = (0, 1, 2, 3)  # re-baked by the torch backend
SPLIT_GRID = 128               # quads per wall side: 6 * 2 * 128^2 faces
# tests/test_native.py's bounds: hit agreement, then where both hit
AGREE, UV_ATOL, DEPTH_RTOL, ANGLE_ATOL, LOD_ATOL = 0.99, 1e-4, 1e-4, 1e-3, 1e-3


def split_room(n=SPLIT_GRID):
    """The demo room with each wall split into an n x n grid of quads (two
    triangles each): positions and UVs bilinear over the wall's corners, so
    the UVs stay inside the wall's island, and the wall's normal at each of
    its vertices."""
    room = demo_scene.room_mesh()
    g = np.linspace(0.0, 1.0, n + 1)
    s, t = (a[..., None] for a in np.meshgrid(g, g, indexing="xy"))
    parts = {"v": [], "uv": [], "n": [], "f": []}
    for q in range(6):
        corners = slice(4 * q, 4 * q + 4)

        def bilinear(c):
            c = np.asarray(c, np.float64)
            return ((1 - s) * (1 - t) * c[0] + s * (1 - t) * c[1]
                    + s * t * c[2] + (1 - s) * t * c[3]).reshape(-1, c.shape[1])

        base = sum(len(v) for v in parts["v"])
        parts["v"].append(bilinear(room.vertices[corners]))
        parts["uv"].append(bilinear(room.uvs[corners]))
        parts["n"].append(np.repeat(room.normals[4 * q][None], (n + 1) ** 2, 0))
        idx = base + np.arange((n + 1) ** 2).reshape(n + 1, n + 1)
        a, b, c, d = idx[:-1, :-1], idx[:-1, 1:], idx[1:, 1:], idx[1:, :-1]
        parts["f"] += [np.stack([a, b, c], -1).reshape(-1, 3),
                       np.stack([a, c, d], -1).reshape(-1, 3)]
    return mesh_io.Mesh(
        vertices=np.concatenate(parts["v"]).astype(np.float32),
        faces=np.concatenate(parts["f"]).astype(np.int32),
        uvs=np.concatenate(parts["uv"]).astype(np.float32),
        normals=np.concatenate(parts["n"]).astype(np.float32))


def raster_maps(mesh, pose, k, hw, dtype=torch.float32):
    """The torch rasterizer's maps (uv, angle, depth, hit, lod) of one view
    on the card, computed in ``dtype`` (float64: the precision reference),
    as numpy, and the index of each pixel's winning (clipped) triangle."""
    fv, fuv, fn = rasterize._camera_faces(mesh.vertices, mesh.faces, mesh.uvs,
                                          mesh.normals, pose, "cuda")
    fv, fuv, fn = fv.to(dtype), fuv.to(dtype), fn.to(dtype)
    cam = (float(k[0, 0]), float(k[1, 1]), float(k[0, 2]), float(k[1, 2]))
    maps = rasterize._rasterize_impl(fv, fuv, fn, *cam, hw, 256)
    cv, _, _ = rasterize._clip_faces(fv, fuv, fn, *cam, hw)
    _, face = rasterize._depth_scan(cv, *cam, hw, 256)
    return [x.cpu().numpy() for x in maps], face.reshape(hw).cpu().numpy()


def compare_maps(where, got, want, faces=None, gate=True):
    """Hold maps (uv, angle, depth, hit, lod) against others with the
    bounds of tests/test_native.py: a pixel agrees when both miss, or both
    hit (and, with ``faces``, the same triangle won: a pixel on an edge may
    go to the neighbour, as a missed edge pixel may); more than AGREE of the
    pixels agree, and where they agree and hit, UV within UV_ATOL, depth
    within DEPTH_RTOL, angle and LOD within ANGLE_ATOL / LOD_ATOL. Logs the
    agreement and the largest errors; with ``gate``, raises on a miss.
    Returns whether the bounds held."""
    uv_g, ang_g, d_g, hit_g, lod_g = got
    uv_w, ang_w, d_w, hit_w, lod_w = want
    agree = hit_g == hit_w
    if faces is not None:
        agree &= ~hit_g | (faces[0] == faces[1])
    both = agree & hit_g
    err = dict(
        uv=float(np.abs(uv_g - uv_w)[both].max(initial=0.0)),
        depth_rel=float((np.abs(d_g - d_w) / np.maximum(d_w, 1e-12))[both]
                        .max(initial=0.0)),
        angle=float(np.abs(ang_g - ang_w)[both].max(initial=0.0)),
        lod=float(np.abs(lod_g - lod_w)[both].max(initial=0.0)))
    share = float(agree.mean())
    ok = (share > AGREE and both.any() and err["uv"] <= UV_ATOL
          and err["depth_rel"] <= DEPTH_RTOL and err["angle"] <= ANGLE_ATOL
          and err["lod"] <= LOD_ATOL)
    close = ((np.abs(uv_g - uv_w).max(-1) <= UV_ATOL)
             & (np.abs(d_g - d_w) <= DEPTH_RTOL * np.abs(d_w))
             & (np.abs(ang_g - ang_w) <= ANGLE_ATOL)
             & (np.abs(lod_g - lod_w) <= LOD_ATOL))
    within = float(((hit_g == hit_w) & (~hit_g | close)).mean())
    log(f"[bake] {where}: agree {share:.5f}, every map within the bounds at "
        f"{within:.5f} of the pixels, hit {float(hit_g.mean()):.3f}, "
        f"max err uv {err['uv']:.3g} depth rel {err['depth_rel']:.3g} angle "
        f"{err['angle']:.3g} lod {err['lod']:.3g} -> "
        f"{'within' if ok else 'OUTSIDE'} the bounds")
    if gate and not ok:
        raise RuntimeError(f"{where}: the torch bake is outside the bounds")
    return ok


def build_room(root):
    """Step 1: tools/make_demo_scene.py's call, timing the frame renders
    and the bake apart. Returns the scene directory."""
    real_bake = demo_scene.bake_scene
    times = {}

    def timed_bake(*args, **kw):
        t0 = time.perf_counter()
        n = real_bake(*args, **kw)
        times["bake"] = time.perf_counter() - t0
        return n

    t0 = time.perf_counter()
    demo_scene.bake_scene = timed_bake
    try:
        scene = demo_scene.build_demo_scene(str(root), n_views=DEMO_VIEWS,
                                            verbose=False)
    finally:
        demo_scene.bake_scene = real_bake
    total = time.perf_counter() - t0
    log(f"[demo] built the room ({DEMO_VIEWS} views of 480x640, pyramid "
        f"{preprocess.DEFAULT_PYRAMID_HEIGHTS}): frame renders "
        f"{total - times['bake']:.3f} s, native bake {times['bake']:.3f} s")
    return Path(scene)


def bake_backends(root, scene):
    """Step 2: views DEMO_BAKE_VIEWS re-baked by the torch backend on the
    card and by the native one, timed; each view and size held against the
    scan in float64 (the gate; the native maps reported beside it); then one
    480x640 view of the split room, torch against native (the gate)."""
    from stylemesh_tpu_torch.data.scenes import _scannet_intrinsics

    k, size, _ = _scannet_intrinsics(str(scene))
    mesh_path = str(root / "room_uvs_blender.ply")
    pose_dir = str(scene / "pose")
    heights = preprocess.DEFAULT_PYRAMID_HEIGHTS
    ms = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for backend in ("torch", "native"):
        out = root / f"bake_{backend}"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        preprocess.bake_scene(mesh_path, pose_dir, k, size, str(out),
                              base_hw=SCENE_HW, pyramid_heights=heights,
                              backend=backend, frame_ids=DEMO_BAKE_VIEWS,
                              verbose=False, device="cuda")
        torch.cuda.synchronize()
        ms[backend] = (time.perf_counter() - t0) * 1e3 / len(DEMO_BAKE_VIEWS)
    log(f"[bake] room, {len(heights) + 1} sizes a view: torch "
        f"{ms['torch']:.1f} ms/view (peak "
        f"{(torch.cuda.max_memory_allocated() - base) / 1e9:.3f} GB), native "
        f"{ms['native']:.1f} ms/view")

    mesh = mesh_io.load_mesh(mesh_path)
    native_ok = []
    for i in DEMO_BAKE_VIEWS:
        pose = load_extrinsics(os.path.join(pose_dir, f"{i}.txt"))
        for hw in [SCENE_HW] + [(h, int(h * SCENE_HW[1] / SCENE_HW[0]))
                                for h in heights]:
            kk = rescale_intrinsics(k, size, (hw[1], hw[0]))
            got, face32 = raster_maps(mesh, pose, kk, hw)
            ref, face64 = raster_maps(mesh, pose, kk, hw, torch.float64)
            nat = native.rasterize_mesh_native(mesh.vertices, mesh.faces,
                                               mesh.uvs, mesh.normals, pose,
                                               kk, hw)
            where = f"room view {i} {hw[0]}x{hw[1]}"
            compare_maps(f"{where} torch vs float64", got, ref, (face32, face64))
            native_ok.append(compare_maps(f"{where} native vs float64", nat,
                                          ref, gate=False))
            compare_maps(f"{where} torch vs native", got, nat, gate=False)
            level = "uv" if hw == SCENE_HW else f"uv_{hw[0]}"
            uv3 = np.load(root / "bake_torch" / level / f"{i}.npy")
            if not (np.array_equal(uv3[..., :2], got[0])
                    and np.array_equal(uv3[..., 2], got[4])):
                raise RuntimeError(f"{where}: bake_scene wrote other maps "
                                   f"than the torch rasterizer gives")
    log(f"[bake] room: native within the bounds of float64 at "
        f"{sum(native_ok)} of {len(native_ok)} view sizes")

    # the 960x1280 level's peak with full 256-face chunks
    coarse = split_room(32)
    pose = load_extrinsics(os.path.join(pose_dir, "0.txt"))
    kk = rescale_intrinsics(k, size, (1280, 960))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    rasterize.rasterize_mesh(coarse.vertices, coarse.faces, coarse.uvs,
                             coarse.normals, pose, kk, (960, 1280),
                             device="cuda")
    torch.cuda.synchronize()
    log(f"[bake] torch rasterizer at 960x1280, {len(coarse.faces)} faces "
        f"(chunks of 256): {(time.perf_counter() - t0) * 1e3:.1f} ms, peak "
        f"{(torch.cuda.max_memory_allocated() - base) / 1e9:.3f} GB")

    split = split_room()
    times = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for rep in range(2):
        t0 = time.perf_counter()
        got = rasterize.rasterize_mesh(split.vertices, split.faces, split.uvs,
                                       split.normals, pose, k, SCENE_HW,
                                       device="cuda")
        got = [x.cpu().numpy() for x in got]
        times.setdefault("torch", []).append((time.perf_counter() - t0) * 1e3)
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    for rep in range(2):
        t0 = time.perf_counter()
        nat = native.rasterize_mesh_native(split.vertices, split.faces,
                                           split.uvs, split.normals, pose, k,
                                           SCENE_HW)
        times.setdefault("native", []).append((time.perf_counter() - t0) * 1e3)
    log(f"[bake] split room, {len(split.faces)} faces, one 480x640 view: "
        f"torch {times['torch'][0]:.1f} / {times['torch'][1]:.1f} ms "
        f"(first / second call), peak {peak:.3f} GB; native "
        f"{times['native'][0]:.1f} / {times['native'][1]:.1f} ms")
    compare_maps("split room view 0 480x640 torch vs native", got, nat)


def demo_step(scene_root, kernel_rows, synthetic_uv):
    """Step 3: bench.py::_run_demo_bench on the port: the full-method step
    of bench_config() on the room, V = 4 views spread over the orbit, 1
    warm-up and STEPS timed steps; then K1 and K2 on this batch at step
    level beside phase 3's rows on the synthetic batch (``synthetic_uv``,
    the bench batch's UV levels), and how many of K2's atomic adds land on
    one texel on each."""
    scenes = discover_scannet_scenes(str(scene_root / "train" / "images"),
                                     pyramid_levels=4, min_pyramid_height=256)
    cache = SceneCache(select_scene(scenes, min_images=1), resize_size=256)
    n = cache.num_views
    idx = [cache.indices[(i * n) // 4] for i in range(4)]
    batch = batch_from_numpy(cache.get_batch(idx), "cuda")
    pipe = TexturePipeline(bench_config(), init_vgg_params(rng=0, scale=0.05),
                           style_image(512, 683))
    state = pipe.init()
    aux = pipe.prepare_batch(batch)
    for _ in range(2):  # warm-up: the eager step, then the graphs' capture
        losses = pipe.train_step(state, batch, aux)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    history = [pipe.train_step(state, batch, aux) for _ in range(STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    for i, l in enumerate([losses] + history):
        l = {k: float(v) for k, v in l.items()}
        log(f"[demo] step {i}: " + json.dumps(l))
        if not all(math.isfinite(x) for x in l.values()):
            raise RuntimeError(f"demo room: non-finite loss at step {i}")
    for name in BENCH_KERNELS:
        log(f"[demo] {name}: {counts[name]} launches in {STEPS} steps")
        if counts[name] == 0:
            raise RuntimeError(f"{name} was not launched on the demo room")
    for name in ONCE_A_STEP:
        if counts[name] != STEPS:
            raise RuntimeError(f"demo room: {name} launched {counts[name]} "
                               f"times in {STEPS} steps, not one a step")
    step_ms = wall / STEPS * 1e3
    result = dict(step_ms=step_ms, views_per_s=STEPS * 4 / wall,
                  peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                  uv_levels=[tuple(u.shape[1:3]) for u in batch.uv])
    log("[demo] " + json.dumps(result))
    profile_step(pipe, state, batch, aux, step_ms)

    # K1 / K2 at step level on the room's UV maps, as in sampling_step
    layers = [l.detach() for l in state.texture.layers]
    shapes = [tuple(l.shape[:2]) for l in layers]
    grids = list(batch.uv)
    cots = []
    for i, grid in enumerate(grids):
        gen = torch.Generator(device="cuda").manual_seed(i)
        g = torch.randn(tuple(grid.shape[:3]) + (3,), generator=gen,
                        device="cuda")
        cots.append((g * aux.grad_weights[i]).contiguous())
    npx = sum(g.numel() // 2 for g in grids)
    live_px = sum(int((c != 0).any(-1).sum()) for c in cots)
    touched = sum(touched_texels(g, layers) for g in grids)
    rows = {r["name"]: r for r in kernel_rows}
    for name, fn, plain, nbytes in (
            ("K1_gather", lambda: gs.gather_levels(layers, grids),
             lambda: gs.gather_levels_plain(layers, grids),
             npx * (8 + 12) + 12 * touched),
            ("K2_splat", lambda: gs.splat_levels(cots, grids, shapes),
             lambda: gs.splat_levels_plain(cots, grids, shapes),
             npx * 12 + live_px * 8 + 12 * sum(a * b for a, b in shapes))):
        check(name, fn(), plain(), "demo room step")
        t, lo, hi = cuda_times(fn)
        b_ms, by = bound_ms(nbytes)
        r = rows[name]
        log(f"[demo] {name} on the room: {t:.4f} ms ({lo:.4f}-{hi:.4f}; bound "
            f"{b_ms:.4f} by {by}, {b_ms / t:.0%} of it); phase 3 on the "
            f"synthetic batch: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f}, "
            f"{r['bound_ms'] / r['ms']:.0%})")
    # K2 adds 4 corners x layers per sample with a nonzero cotangent; the
    # fewer distinct texels they hit, the more adds contend for one address
    for what, uv, n_live, texels in (("room", grids, live_px, touched),
                                     ("synthetic", synthetic_uv, None, None)):
        n_samples = sum(g.numel() // 2 for g in uv)
        if texels is None:
            texels = sum(touched_texels(g, layers) for g in uv)
        log(f"[demo] {what} UV maps: {n_samples} samples"
            + ("" if n_live is None else f" ({n_live} with a nonzero "
               f"cotangent)")
            + f", {texels} distinct texels over the {len(layers)} layers, "
            f"{4 * len(layers) * n_samples / texels:.2f} corner reads a texel")
    return result


def quality_scene_cache(root, texture, view_hw, heights, resize,
                        frame_hook=None, n_views=6):
    """tests/test_quality_gates.py::_scene_cache with the port."""
    demo_scene.build_demo_scene(str(root), n_views=n_views, view_hw=view_hw,
                                pyramid_heights=heights, texture=texture,
                                shading=False, frame_hook=frame_hook,
                                verbose=False)
    scenes = discover_scannet_scenes(os.path.join(root, "train", "images"),
                                     pyramid_levels=len(heights),
                                     min_pyramid_height=heights[0])
    return SceneCache(select_scene(scenes, min_images=1), resize_size=resize)


def reconstruction_cfg(tex_size):
    """tests/test_quality_gates.py::_reconstruction_cfg: content-only on
    shallow layers of the random VGG, float32 (the JAX config's
    ``use_splat_kernel=False`` has no counterpart: on the card sampling is
    K1/K2, the same function)."""
    return PipelineConfig(
        steps_per_epoch=1, texture_width=tex_size, texture_height=tex_size,
        hierarchical_layers=2,
        content_layers=("r11", "r21"), content_weights=(1.0, 1.0),
        use_angle_weight=True, use_depth_scaling=True,
        content_weight=1.0, style_weight=0.0, tex_reg_weight=0.0,
        style_min_size=16, learning_rate=1.0, decay_step_size=10 ** 6)


def _gate_pipeline(cfg, device):
    rng = np.random.default_rng(0)
    style = torch.from_numpy(
        (rng.random((1, 48, 64, 3), dtype=np.float32) - 0.45) * 255.0)
    return TexturePipeline(cfg, init_vgg_params(rng=0, device=device), style,
                           device=device)


def reconstruct(cache, cfg, steps, device="cuda"):
    """tests/test_quality_gates.py::_optimize: ``steps`` train steps on all
    the cached views; returns (state, batch)."""
    batch = batch_from_numpy(cache.get_batch(cache.indices), device)
    pipe = _gate_pipeline(cfg, device)
    state = pipe.init()
    aux = pipe.prepare_batch(batch)
    for _ in range(steps):
        losses = pipe.train_step(state, batch, aux)
    if not all(math.isfinite(float(v)) for v in losses.values()):
        raise RuntimeError(f"quality gate: non-finite losses {losses}")
    return state, batch


@torch.no_grad()
def masked_psnr(state, batch):
    """tests/test_quality_gates.py::_masked_psnr."""
    hw = tuple(batch.rgb.shape[1:3])
    uv = next((u for u in batch.uv if u.shape[1] == hw[0]), batch.uv[0])
    pred = resize_bilinear(gatys_post(sample_texture(state.texture, [uv])[0]),
                           hw)
    rgb = gatys_post(batch.rgb)
    m = batch.mask
    mse = float((((pred - rgb) ** 2) * m).sum() / (m.sum() * 3))
    return -10 * math.log10(mse + 1e-12)


def self_reproduction_gate(root, device="cuda"):
    """tests/test_quality_gates.py::test_self_reproduction_psnr_gate: the
    rendered views go from under 16 dB (the gray start) to over 24 dB, a
    gain of more than 9 dB. Returns (initial, final) PSNR."""
    cache = quality_scene_cache(root, demo_scene.demo_texture(size=512, seed=0),
                                view_hw=(120, 160), heights=(48, 96), resize=64)
    cfg = reconstruction_cfg(128)
    batch = batch_from_numpy(cache.get_batch(cache.indices), device)
    init_psnr = masked_psnr(_gate_pipeline(cfg, device).init(), batch)
    state, batch = reconstruct(cache, cfg, 75, device)
    final_psnr = masked_psnr(state, batch)
    log(f"[gate] self-reproduction PSNR {init_psnr:.3f} -> {final_psnr:.3f} dB")
    if not (init_psnr < 16.0 and final_psnr > 24.0
            and final_psnr > init_psnr + 9.0):
        raise RuntimeError(f"self-reproduction gate missed: {init_psnr:.3f} "
                           f"-> {final_psnr:.3f} dB")
    return init_psnr, final_psnr


def circle_arm(root, arm, device="cuda"):
    """tests/test_quality_gates.py::_circle_arm."""
    if arm == "full":
        tex = demo_scene.circle_texture(size=1024, radius_px=30, spacing_px=140)
        hook = None
    else:
        tex = np.full((64, 64, 3), 0.82, np.float32)

        def hook(i, img, depth):
            return demo_scene.paint_screen_circles(img, radius_px=14,
                                                   spacing_px=64)

    cache = quality_scene_cache(root, tex, view_hw=(256, 341),
                                heights=(64, 128), resize=128, frame_hook=hook)
    state, _ = reconstruct(cache, reconstruction_cfg(256), 60, device)
    styled = os.path.join(root, "styled")
    render_styled_frames(state.texture, cache, styled, level=-1)
    return measure_circles_for_scene(cache, styled, device=device)


def circle_gate(root, device="cuda"):
    """tests/test_quality_gates.py::test_circle_uniformity_full_vs_only2d:
    its seven assertions. Returns (full, only2d)."""
    root = Path(root)
    full = circle_arm(str(root / "full"), "full", device)
    only2d = circle_arm(str(root / "only2d"), "only2d", device)
    keys = ("n_circles", "corr_depth_3D", "corr_depth_2D")
    log(f"[gate] circles full: { {k: full.get(k) for k in keys} }, only-2D: "
        f"{ {k: only2d.get(k) for k in keys} }")
    checks = {
        "full n_circles >= 40": full["n_circles"] >= 40,
        "only2d n_circles >= 60": only2d["n_circles"] >= 60,
        "full corr_depth_3D < -0.1": full["corr_depth_3D"] < -0.1,
        "only2d corr_depth_3D > 0.35": only2d["corr_depth_3D"] > 0.35,
        "3D separation > 0.7":
            only2d["corr_depth_3D"] - full["corr_depth_3D"] > 0.7,
        "full corr_depth_2D < -0.4": full["corr_depth_2D"] < -0.4,
        "only2d corr_depth_2D > -0.1": only2d["corr_depth_2D"] > -0.1,
    }
    missed = [k for k, ok in checks.items() if not ok]
    if missed:
        raise RuntimeError(f"circle-uniformity gate missed: {missed}")
    return full, only2d


def demo_room_phase(kernel_rows, synthetic_uv):
    """Phase 7: the demo room built and baked by the port, the torch bake
    against float64 and native, the full-method step on the room, and the
    two quality gates."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="stylemesh_demo_room_") as tmp:
        root = Path(tmp)
        scene = build_room(root / "room")
        t0 = time.perf_counter()
        bake_backends(root / "room", scene)
        log(f"[demo] step 2 (bake backends): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        demo_step(root / "room", kernel_rows, synthetic_uv)
        log(f"[demo] step 3 (demo-room step): {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        self_reproduction_gate(root / "psnr")
        circle_gate(root / "circles")
        log(f"[demo] step 4 (quality gates): {time.perf_counter() - t0:.1f} s")
    log(f"[demo] phase 7: {time.perf_counter() - t_phase:.1f} s")


def live_tile_px(m, tile):
    """The pixels, over the views, of the ``tile``-pixel tiles of ``m
    [V, K, P]`` in which some mask is nonzero (the last tile may be short)."""
    v, _, p = m.shape
    n = -(-p // tile)
    live = F.pad(m.ne(0).any(dim=1).float(), (0, n * tile - p))
    live = live.reshape(v, n, tile).amax(dim=2)           # [V, n]
    px = torch.full((n,), float(tile), device=m.device)
    px[-1] = p - (n - 1) * tile
    return float((live * px).sum())


def multi_card():
    """``--multi-card``: phase 6 alone, one rank per card (NCCL), on the
    scene of phase 4."""
    n = torch.cuda.device_count()
    if n < 2:
        raise RuntimeError(f"--multi-card needs 2 or more cards, found {n}")
    with tempfile.TemporaryDirectory(prefix="stylemesh_chip_smoke_") as tmp:
        root = Path(tmp)
        style = write_scene(root)
        launches = multi_device_phases(root, style, nproc=n)
    for name, (count, per_step) in launches.items():
        log(f"[multi-card] {name}: {count} launches on rank 0, "
            f"{per_step:g} per step")


SASS_KERNELS = {  # kernel -> its instantiations' tags in the mangled name
    # K5 / K9, and K5's input gradients that finish their input's cotangent
    # (the mask; the mask and the tap's cotangent)
    "conv3x3_gemm_kernel": tuple(
        f"I{tile}{epi}E" for tile in ("Li1ELi256E", "Li2ELi128E", "Li2ELi64E")
        for epi in ("Lb0ELb0E", "Lb1ELb0E", "Lb1ELb1E")),
    # K6, K7 (DUAL), and K6 with route codes
    "conv_relu_pool_kernel": ("ILi2ELi64ELb0ELb0E", "ILi2ELi128ELb0ELb0E",
                              "ILi2ELi64ELb1ELb0E", "ILi2ELi128ELb1ELb0E",
                              "ILi2ELi64ELb0ELb1E"),
    "conv_relu_pool_bwd_kernel": ("ILb0E", "ILb1E"),
    "gram_fwd_kernel": ("ILi1E", "ILi2E"),
    "gram_bwd_kernel": ("ILi1ELi1E", "ILi2ELi1E", "ILi1ELi2E", "ILi2ELi2E"),
}


STEM_SASS = ("stem_conv_gemm_fwd_kernel", "stem_conv_gemm_bwd_kernel")


def conv_core_sass():
    """Raise unless every instantiation of the wgmma kernels (K5/K9, K6/K7,
    K8, K3, K4) in the built library holds warpgroup MMA instructions (HGMMA
    in its SASS), no kernel of ``gram.cu`` holds a WMMA ``HMMA`` and the
    stem kernels hold their ``mma.sync`` (HMMA); print their count and
    shapes per kernel, and the Gram and stem kernels' registers and local
    memory."""
    lib = kernels.BUILD_DIR / f"{kernels.NAME}.so"
    sass = subprocess.run(["cuobjdump", "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    functions = [fn.split("\n", 1) for fn in sass.split("Function : ")[1:]]
    for name, tags in SASS_KERNELS.items():
        for tag in tags:
            mangled = f"{len(name)}{name}{tag}"
            bodies = [body for head, body in functions if mangled in head]
            found = [m.group(1) for body in bodies
                     for m in re.finditer(r"(HGMMA\.\w+\.F32\.BF16)", body)]
            log(f"[build] {name}{tag} SASS: {len(found)} HGMMA instructions "
                f"({', '.join(sorted(set(found)))})")
            if not bodies or not found:
                raise RuntimeError(f"{name}{tag}: no HGMMA in its SASS")
    hmma = [head.split()[0] for head, body in functions
            if "gram_" in head and re.search(r"\bHMMA\.", body)]
    if hmma:
        raise RuntimeError(f"mma.sync (HMMA) left in the Gram kernels: {hmma}")
    for name in STEM_SASS:
        bodies = [body for head, body in functions if name in head]
        found = [m.group(1) for body in bodies
                 for m in re.finditer(r"(HMMA\.\w+\.F32\.BF16)", body)]
        log(f"[build] {name} SASS: {len(found)} HMMA instructions "
            f"({', '.join(sorted(set(found)))})")
        if not found:
            raise RuntimeError(f"{name}: no mma.sync (HMMA) in its SASS")
    usage = subprocess.run(["cuobjdump", "-res-usage", str(lib)],
                           capture_output=True, text=True, check=True).stdout
    for fn, regs, local in re.findall(
            r"Function ([^\s:]+):\s*REG:(\d+)[^\n]*?LOCAL:(\d+)", usage):
        if "gram_" in fn or "stem_" in fn:
            log(f"[build] {fn}: {regs} registers, {local} bytes of local "
                f"memory (spills)")


def main(argv):
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"[device] {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    kernels.library()
    log(f"[build] kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    conv_core_sass()
    if argv == ["--multi-card"]:
        multi_card()
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if argv:
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2

    pipe, state, batch, aux, counts = main_path()
    launches = {k: (counts[k], counts[k] / STEPS)
                for k in BENCH_KERNELS + ONCE_A_STEP[2:]}
    reference_check()
    reference_check_bf16()
    launches.update(run_loop_phases(pipe, state, batch, aux, smi))
    rows = kernel_phase(pipe, state, batch, aux, launches)
    demo_room_phase(rows, list(batch.uv))
    for r in rows:
        other = (f"library {r['library_ms']:.4f} ({r['library_ms_min']:.4f}-"
                 f"{r['library_ms_max']:.4f})" if r["library_ms"] is not None
                 else f"f32 mode {r['f32_mode_ms']:.4f}" if "f32_mode_ms" in r
                 else "library none")
        rate = (f", {r['tflop_per_s']:.1f} TFLOP/s" if "tflop_per_s" in r
                else "")
        if "max_ulps" in r:
            rate += f", largest difference {r['max_ulps']:.4g} bf16 ulps"
        unit, per = r["unit"], r["launches_per_unit"]
        log(f"[kernel] {r['name']}: {r['ms']:.4f} ms/{unit} ({r['ms_min']:.4f}-"
            f"{r['ms_max']:.4f}; bound {r['bound_ms']:.4f} "
            f"by {r['bound_by']}), plain {r['plain_ms']:.4f}, {other}, "
            f"{per:g} launches/{unit}, {r['launches']} launches{rate}")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
