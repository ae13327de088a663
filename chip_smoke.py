"""Drive the PyTorch port's main path on one CUDA card and check its kernels.

    python3 chip_smoke.py
    python3 chip_smoke.py --multi-card   # phase 6 alone, one rank per card

Needs one NVIDIA Hopper card (the kernels are built for sm_90a at first use
into build/torch_ext) and the ``stylemesh_tpu_torch`` package beside this
file. Exits nonzero, with no result line, when CUDA is unavailable or any
phase fails. Phases:

1. main path: the full-method bench workload (4096² x 4 Laplacian atlas,
   V = 4 views, content 256x341, UV levels 256..784 px high, multi style
   pyramid, bf16 VGG trunk on the conv kernels K5-K8, float32 K1/K2, Adam)
   through ``TexturePipeline.prepare_batch`` and ``train_step``; every loss
   must be finite, K1-K8's launch counts over the timed steps above zero,
   and the profile of a step must show no cuDNN convolution and no float32
   Gram (no ``bmm``, no SIMT sgemm but conv1_1's im2col product): every
   style layer's Gram goes through K3/K4;
2. reference: a small configuration trained on the card and on the CPU
   (plain versions), float32, losses compared;
2b. the same small configuration in bf16 (the kernel trunk), the losses of
   the first step compared;
4. run loop: a ScanNet-layout scene of 16 views (480x640 photos, UV levels
   256..784) written to a temporary directory, trained by the port's CLI
   (``--preset scannet_full --bfloat16``: K1/K2 in their bf16 mode, the
   kernel trunk) for one epoch of batches of 4 views repeated twice; the
   losses must be finite, ``texture.npz`` written, and K1/K2's bf16 mode,
   K3-K8 launched;
5. K9: the same CLI call with ``STYLEMESH_CONV_FLIPVJP=0
   STYLEMESH_FAST_CONV=1`` (the unfused trunk), one step per batch; K9 must
   be launched and K5-K8 not, and the profile of a bench step under the same
   settings must show no cuDNN convolution but conv1_1's forward and input
   gradient;
6. multi-device, on the same scene, each CLI call also run on one rank (in
   this process) as its reference; the 2-rank calls go through
   ``python -m torch.distributed.run --standalone --nproc_per_node 2``, both
   ranks on this one card over gloo, so their step times are not
   multi-card numbers:
   [atlas] ``--shard_atlas`` over 2 ranks, in the CLI's bf16 K1/K2 mode and
   again with ``--kernel_compute f32``: every rank must launch the banded
   K1/K2 of its mode and no unbanded K1/K2 in its train steps, the first
   step's losses must lie within 1e-4 relative of the one-rank run's, and
   the exported texture must have the full shapes and be finite;
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
   and, for the convs, its achieved TFLOP/s; at every K5 and K9 shape, K5
   without bias and relu must equal K9 bit for bit, and at every block-tail
   shape K6 must equal maxpool2 of K5's relu output, K7's maps K5's output
   and K6's, and K8 K5 with the flipped kernel on the routed cotangent, bit
   for bit; the banded K1/K2 for the 4 bands of D = 4
   (each against its plain version, their sum against the unbanded K1/K2),
   timed for rank 0's band of D = 2.

The last two lines of standard output are the ``{"kernels": [...]}`` JSON
line and the ``{"ok": true, "device": ...}`` JSON line.
"""

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

from stylemesh_tpu_torch import cli, kernels
from stylemesh_tpu_torch.data.synthetic import synthetic_view_batch
from stylemesh_tpu_torch.models.pipeline import PipelineConfig, TexturePipeline
from stylemesh_tpu_torch.models import vgg
from stylemesh_tpu_torch.models.texture import sample_texture
from stylemesh_tpu_torch.models.vgg import init_vgg_params, vgg_features
from stylemesh_tpu_torch.ops import conv_kernels, gram_kernels, head_kernels
from stylemesh_tpu_torch.ops import grid_sample as gs

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12   # dense bf16 tensor-core peak
STEPS = 5                  # timed train steps
REPS = 20                  # launches per kernel / library timing (median)
PLAIN_REPS = 5             # launches per plain-version timing (mean)

REPO = Path(__file__).resolve().parent
SAMPLE_SRC = "stylemesh_tpu_torch/kernels/csrc/sample.cu"
GEMM_SRC = "stylemesh_tpu_torch/kernels/csrc/conv_gemm.cu"
BWD_SRC = "stylemesh_tpu_torch/kernels/csrc/conv_pool_bwd.cu"
KERNELS = {  # launches: (wrapper, attribute holding its launch count)
    "K1_gather": dict(source="stylemesh_tpu_torch/kernels/csrc/sample.cu",
                      replaces="stylemesh_tpu/ops/splat_pallas.py:486",
                      launches=(gs.gather_layers, "launches"), rel_tol=1e-5),
    "K1_gather_bf16": dict(source="stylemesh_tpu_torch/kernels/csrc/sample.cu",
                           replaces="stylemesh_tpu/ops/splat_pallas.py:486",
                           launches=(gs.gather_layers, "bf16_launches"),
                           rel_tol=1e-5),
    "K2_splat": dict(source="stylemesh_tpu_torch/kernels/csrc/sample.cu",
                     replaces="stylemesh_tpu/ops/splat_pallas.py:421",
                     launches=(gs.splat_layers, "launches"), rel_tol=1e-4),
    "K2_splat_bf16": dict(source="stylemesh_tpu_torch/kernels/csrc/sample.cu",
                          replaces="stylemesh_tpu/ops/splat_pallas.py:421",
                          launches=(gs.splat_layers, "bf16_launches"),
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
    "K8_conv_relu_pool_bwd": dict(
        source=BWD_SRC, replaces="stylemesh_tpu/ops/head_pallas.py:413",
        launches=(head_kernels.conv_relu_pool_bwd, "launches"), rel_tol=1e-2,
        max_share=2e-3),
    "K9_conv3x3_mxu": dict(source=GEMM_SRC,
                           replaces="stylemesh_tpu/ops/conv_pallas.py:136",
                           launches=(conv_kernels.conv3x3_mxu, "launches"),
                           rel_tol=1e-2),
    # the banded form, reached through grid_sample.py::grid_sample_banded_cf
    "K1_gather_banded": dict(
        source=SAMPLE_SRC, replaces="stylemesh_tpu/ops/grid_sample.py:185",
        launches=(gs.gather_layers_banded, "banded_launches"), rel_tol=1e-5),
    "K1_gather_banded_bf16": dict(
        source=SAMPLE_SRC, replaces="stylemesh_tpu/ops/grid_sample.py:185",
        launches=(gs.gather_layers_banded, "banded_bf16_launches"),
        rel_tol=1e-5),
    "K2_splat_banded": dict(
        source=SAMPLE_SRC, replaces="stylemesh_tpu/ops/grid_sample.py:210",
        launches=(gs.splat_layers_banded, "banded_launches"), rel_tol=1e-4),
    "K2_splat_banded_bf16": dict(
        source=SAMPLE_SRC, replaces="stylemesh_tpu/ops/grid_sample.py:210",
        launches=(gs.splat_layers_banded, "banded_bf16_launches"),
        rel_tol=1e-4),
}
# the kernels each driven path must launch
BENCH_KERNELS = ("K1_gather", "K2_splat", "K3_gram_fwd", "K4_gram_bwd",
                 "K5_conv3x3", "K6_conv_relu_pool", "K7_conv_relu_pool_dual",
                 "K8_conv_relu_pool_bwd")
TRUNK_KERNELS = BENCH_KERNELS[4:]
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
# K8 as K5, but a value that rounds differently can break a tie in a pool
#    window and route that window's gradient to another pixel: at most 2e-3
#    of the elements may lie farther than 1e-2 from the plain version.
# K9 is K5 without bias and relu: 1e-2 (and K5 with bias=None, relu=False
#    must equal it bit for bit: one C entry).
# Between the kernels, bit for bit (one mainloop at K5's N tile): K6 is
#    maxpool2 of K5's relu output, K7's pre-pool map is that output and its
#    pooled map K6's, K8 is K5 with the flipped kernel on the routed
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
    batch = synthetic_view_batch(
        num_views=4, content_hw=(256, 341), level_heights=(256, 432, 608, 784),
        aspect=1280.0 / 960.0, min_depth=0.25, seed=0, depth_range=(0.4, 7.0))
    vgg = init_vgg_params(rng=0, scale=0.05)
    t0 = time.perf_counter()
    pipe = TexturePipeline(bench_config(), vgg, style_image(512, 683))
    state = pipe.init()
    aux = pipe.prepare_batch(batch)
    torch.cuda.synchronize()
    log(f"[main] setup (style targets, init, prepare_batch): "
        f"{time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    aux = pipe.prepare_batch(batch)
    torch.cuda.synchronize()
    prepare_ms = (time.perf_counter() - t0) * 1e3
    losses = pipe.train_step(state, batch, aux)  # warm-up
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
    result = dict(step_ms=wall / STEPS * 1e3,
                  views_per_s=STEPS * batch.num_views / wall,
                  prepare_batch_ms=prepare_ms,
                  peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    log("[main] " + json.dumps(result))
    profile_step(pipe, state, batch, aux, result["step_ms"])
    return pipe, state, batch, aux, counts


def profile_step(pipe, state, batch, aux, step_ms):
    """Device time of one step by kernel and by PyTorch op (torch.profiler),
    and the device busy share of the unprofiled step time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pipe.train_step(state, batch, aux)
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


def no_float32_grams(prof):
    """Raise if the profiled bf16 step ran a ``bmm`` (the plain float32
    masked Gram's product; K3/K4 are no PyTorch op) or a float32 GEMM on
    the CUDA cores (SIMT sgemm, cuBLAS's ``f32f32`` ffma kernels) from any
    op but ``mm`` (conv1_1's im2col product, float32 by design)."""
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
    if bmm or set(sgemm) - {"aten::mm"}:
        raise RuntimeError("the bf16 step ran a float32 Gram off K3/K4")


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
SCENE_LEVELS = (256, 432, 608, 784)


def write_scene(root, n=16):
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


def cli_argv(tag, root, style, index_repeat, extra=(), preset="scannet_full"):
    return ["--preset", preset, "--root_path", str(root), "--scene", SCENE,
            "--style_image_path", style, "--bfloat16", "--batch_size", "4",
            "--max_epochs", "1", "--index_repeat", str(index_repeat),
            "--no_post_steps", "--log_dir", str(root / f"runs_{tag}"),
            *extra]


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
            preset="scannet_full", exports=("texture.npz",)):
    """One CLI training run on the scene, on one rank in this process; the
    launch counts of this run alone (set to 0 just before it, read just
    after)."""
    argv = cli_argv(tag, root, style, index_repeat, extra, preset)
    log(f"[{tag}] python -m stylemesh_tpu_torch.cli " + " ".join(argv))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    state, log_dir = cli.main(argv)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = read_counts()
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
    return dict(counts=counts, steps=result["steps"], log_dir=log_dir,
                state=state)


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
    """The bench step under the K9 settings: profiled once (conv routes),
    then timed over STEPS steps. Returns K9's launches per step."""
    from torch.profiler import ProfilerActivity, profile

    reset_counts()
    pipe.train_step(state, batch, aux)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        pipe.train_step(state, batch, aux)
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


def run_loop_phases(pipe, state, batch, aux):
    """Phases 4, 5 and 6; returns {kernel: (launches, launches per step)}
    for the kernels these runs drive first: K1/K2's bf16 mode (the CLI
    run), K9 (the K9 CLI run; per step from the K9 bench step, since the
    run's count also holds the style targets', content targets' and
    validation's launches) and the banded K1/K2 (rank 0 of the atlas
    runs)."""
    with tempfile.TemporaryDirectory(prefix="stylemesh_chip_smoke_") as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        style = write_scene(root)
        log(f"[run] scene written in {time.perf_counter() - t0:.3f} s")
        run = cli_run("run", root, style, 2, RUN_KERNELS,
                      forbidden=("K9_conv3x3_mxu",))
        launches = {k: (run["counts"][k], run["counts"][k] / run["steps"])
                    for k in ("K1_gather_bf16", "K2_splat_bf16")}
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
    count, memory). Raises when a rank fails. The ranks are killed with
    their launcher at the time limit."""
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
    decoder = json.JSONDecoder()
    ranks = {int(m.group(1)): decoder.raw_decode(out, m.end())[0]
             for m in RANK_LINE.finditer(out)}
    if sorted(ranks) != list(range(nproc)):
        raise RuntimeError(f"[{tag}] closing lines of ranks {sorted(ranks)}")
    log(f"[{tag}] {nproc} ranks in {wall_s:.3f} s")
    return ranks


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
    and gloo otherwise; the kernels it launched in its train steps."""
    backend = ("nccl" if len(ranks) <= torch.cuda.device_count() else "gloo")
    for r, line in sorted(ranks.items()):
        counts = line["train_launches"]
        if line["backend"] != backend or not line["device"].startswith("cuda"):
            raise RuntimeError(f"[{tag}] rank {r} ran on {line}, "
                               f"expected {backend}")
        for k in launched:
            if counts[k] == 0:
                raise RuntimeError(f"[{tag}] rank {r} did not launch {k}")
        for k in not_launched:
            if counts[k] != 0:
                raise RuntimeError(f"[{tag}] rank {r} launched {k} "
                                   f"{counts[k]} times")


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
        ranks = torchrun(tag, cli_argv(tag, root, style, 1, extra), nproc)
        suffix = "_bf16" if mode == "bf16" else ""
        check_ranks(tag, ranks, ("gather_banded" + suffix,
                                 "splat_banded" + suffix), UNBANDED)
        log_dir = str(root / f"runs_{tag}" / "version_0")
        result = run_result(tag, log_dir)
        log(f"[{tag}] " + json.dumps(result))
        if mode == "bf16":  # the one-rank run is the CLI's bf16 mode
            compare_first_step(tag, log_dir, ref)
        check_export(tag, log_dir, one["log_dir"])
        steps = ranks[0]["train_steps"]
        for name, key in zip(names, ("gather_banded" + suffix,
                                     "splat_banded" + suffix)):
            n = ranks[0]["train_launches"][key]
            launches[name] = (n, n / steps)

    ranks = torchrun("dp", cli_argv("dp", root, style, 1, ["--data_parallel"]),
                     nproc)
    check_ranks("dp", ranks, ("gather_bf16", "splat_bf16"),
                ("gather_banded_bf16", "splat_banded_bf16"))
    log_dir = str(root / "runs_dp" / "version_0")
    log("[dp] " + json.dumps(run_result("dp", log_dir)))
    compare_first_step("dp", log_dir, ref)

    dip = cli_run("dip_one_rank", root, style, 1,
                  ("K1_gather_bf16", "K2_splat_bf16"), preset="scannet_dip")
    count = int(dip["state"].gram_cache.count)
    ranks = torchrun("dip", cli_argv("dip", root, style, 1, ["--data_parallel"],
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
                    exports=("texture_style0.npz", "texture_style1.npz"))
    compare_first_step("multistyle", sweep["log_dir"],
                       {"total": ref["total"]},
                       key_map={"total": "total_style0"})
    sweep_ref = first_step_losses(sweep["log_dir"])
    ranks = torchrun("multistyle_ranks", cli_argv(
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
        iy0, iy1, ix0, ix1, _, _ = gs._corner_indices_weights(
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


def banded_kernels(where, layers, grid, g, add):
    """The banded K1/K2 at one pyramid level, in both modes: for D = 4 each
    band against its plain version, the bands' partials summed against the
    unbanded K1 and their gradients stacked against the unbanded K2; then
    rank 0's band of D = 2, timed."""
    shapes = [tuple(l.shape[:2]) for l in layers]
    npx = grid.numel() // 2
    f32_ms = {}
    for compute, k1, k2 in (("f32", "K1_gather_banded", "K2_splat_banded"),
                            ("bf16", "K1_gather_banded_bf16",
                             "K2_splat_banded_bf16")):
        errs = {k1: [], k2: []}
        total, parts = 0, [[] for _ in layers]
        for b in range(4):
            bands, row0s, heights = bands_of(layers, b, 4)
            bshapes = [tuple(x.shape[:2]) for x in bands]
            out = gs.gather_layers_banded(bands, grid, row0s, heights, compute)
            errs[k1].append(check(k1, out, gs.gather_layers_banded_plain(
                bands, grid, row0s, heights, compute), f"{where} band {b} of 4"))
            total = total + out
            grads = gs.splat_layers_banded(g, grid, bshapes, row0s, heights,
                                           compute)
            errs[k2].append(check(k2, grads, gs.splat_layers_banded_plain(
                g, grid, bshapes, row0s, heights, compute),
                f"{where} band {b} of 4"))
            for acc, x in zip(parts, grads):
                acc.append(x)
        errs[k1].append(check(k1, total, gs.gather_layers(layers, grid, compute),
                              f"{where} 4 bands summed vs K1"))
        errs[k2].append(check(k2, [torch.cat(p) for p in parts],
                              gs.splat_layers(g, grid, shapes, compute),
                              f"{where} 4 bands stacked vs K2"))
        del total, parts
        bands, row0s, heights = bands_of(layers, 0, 2)
        bshapes = [tuple(x.shape[:2]) for x in bands]
        at = f"{where} rank 0 of 2"
        for name, fn, plain, nbytes in (
                (k1, lambda: gs.gather_layers_banded(bands, grid, row0s, heights,
                                                     compute),
                 lambda: gs.gather_layers_banded_plain(bands, grid, row0s,
                                                       heights, compute),
                 npx * (8 + 12) + 12 * touched_texels(grid, bands, row0s,
                                                      heights)),
                (k2, lambda: gs.splat_layers_banded(g, grid, bshapes, row0s,
                                                    heights, compute),
                 lambda: gs.splat_layers_banded_plain(g, grid, bshapes, row0s,
                                                      heights, compute),
                 npx * (12 + 8) + 12 * sum(a * b for a, b in bshapes))):
            err_tol = (max(e for e, _ in errs[name]),
                       max(t for _, t in errs[name]))
            ms = add(name, at, err_tol, fn, plain, None, nbytes,
                     f32_mode_ms=None if compute == "f32" else f32_ms[name[:2]])
            f32_ms[name[:2]] = ms if compute == "f32" else f32_ms[name[:2]]


def cotangent(like, mask=None, seed=0):
    """A random bf16 cotangent shaped as ``like``, zero where ``mask`` is
    False."""
    gen = torch.Generator(device=like.device).manual_seed(seed)
    g = torch.randn(like.shape, generator=gen, device=like.device)
    g = g.to(torch.bfloat16)
    return g if mask is None else torch.where(mask, g, torch.zeros_like(g))


def trunk_kernels(where, pipe, pred, add):
    """K5-K8 at one pyramid level: the trunk walked as ``vgg_features``
    walks it for the loss's layers, each kernel launch of the step's forward
    and backward repeated on its inputs (random cotangents, masked as the
    backward masks them) and held against its plain version."""
    nchw = lambda t: t.permute(0, 3, 1, 2)  # noqa: E731
    keys = pipe.loss.layers
    last = max(i for i, (name, _) in enumerate(vgg._TRUNK) if name in keys)
    h = pred.to(torch.bfloat16).contiguous()
    skip_pool = False
    for i, (name, conv) in enumerate(vgg._TRUNK[:last + 1]):
        if conv is None:
            if not skip_pool:
                h = vgg._pool_nhwc(h, "max")
            skip_pool = False
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
        if h.shape[-1] < conv_kernels.CIN_STEP:  # conv1_1: im2col, no kernel
            h = vgg.conv3x3_im2col(h, w9, b, relu=True)
            continue
        x_bytes, w_bytes = h.numel() * 2, w9.numel() * 2
        if (i + 1 <= last and vgg._TRUNK[i + 1][1] is None
                and vgg._fused_pool_wanted(h, cout, "max", name in keys)):
            skip_pool = True
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
                g = cotangent(pooled, seed=i)
                dx = head_kernels.conv_relu_pool_bwd(h, w9, w9t, b, g)
                err = check("K8_conv_relu_pool_bwd", dx,
                            head_kernels.conv_relu_pool_bwd_plain(h, w9, w9t, b, g),
                            at)
                same_bits(f"K8 vs K5 on the routed cotangent at {at}", dx,
                          conv_kernels.conv3x3(head_kernels.pool_route(y, g), w9t))
                del dx
                x_leaf = nchw(h).detach().requires_grad_()
                lib_out = F.max_pool2d(F.relu(F.conv2d(
                    x_leaf, w_lib, b_lib, padding=1)), 2)
                add("K8_conv_relu_pool_bwd", at, err,
                    lambda x=h: head_kernels.conv_relu_pool_bwd(
                        x, w9, w9t, b, g),
                    lambda x=h: head_kernels.conv_relu_pool_bwd_plain(
                        x, w9, w9t, b, g),
                    lambda: torch.autograd.grad(
                        lib_out, x_leaf, nchw(g), retain_graph=True),
                    2 * x_bytes + 2 * w_bytes + 4 * cout + g.numel() * 2,
                    2 * flops)
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
                dr = head_kernels.pool_route(pre, cotangent(pooled, seed=i))
                k5_backward(at, dr, w9t, wt_lib, flops, add)
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
        k5_backward(at, cotangent(y, y > 0, seed=i), w9t, wt_lib, flops, add)
        h = y


def k5_backward(at, g, w9t, wt_lib, flops, add):
    """K5 as an input gradient: the masked cotangent, the flipped kernel, no
    bias, relu off."""
    dx = conv_kernels.conv3x3(g, w9t)
    err = check("K5_conv3x3", dx, conv_kernels.conv3x3_plain(g, w9t), at)
    same_as_k9(at + " input gradient", g, w9t, dx)
    add("K5_conv3x3", at + " input gradient", err,
        lambda: conv_kernels.conv3x3(g, w9t),
        lambda: conv_kernels.conv3x3_plain(g, w9t),
        lambda: F.conv2d(g.permute(0, 3, 1, 2), wt_lib, padding=1),
        g.numel() * 2 + w9t.numel() * 2 + dx.numel() * 2, flops)


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
                       err=0.0, tol=0.0, flops=0.0)
            for name in KERNELS}

    def add(name, where, err_tol, fn, plain_fn, library_fn, nbytes, flops=0.0,
            f32_mode_ms=None):
        """Time one launch of the kernel (``fn``, median of REPS with min and
        max), its plain version (mean of PLAIN_REPS) and the library call
        (``library_fn``, like the kernel) and accumulate them; returns the
        kernel's median. Its bound is the larger of its bytes over HBM
        bandwidth and its flops over the bf16 peak. A bf16 mode has no
        library call computing its function (``library_fn`` None); it is
        timed beside its f32 mode instead."""
        ms, lo, hi = cuda_times(fn)
        plain_ms = cuda_ms(plain_fn)
        r = rows[name]
        r["err"] = max(r["err"], err_tol[0])
        r["tol"] = max(r["tol"], err_tol[1])
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

    layers = [l.detach() for l in state.texture.layers]
    shapes = [tuple(l.shape[:2]) for l in layers]
    layers_cf = [l.permute(2, 0, 1)[None] for l in layers]
    for i, grid in enumerate(batch.uv):
        v, h, w, _ = grid.shape
        npx = v * h * w
        with torch.no_grad():
            pred = sample_texture(state.texture, grid)
        trunk_kernels(f"level {i}", pipe, pred, add)
        k9_kernels(f"level {i}", pipe, pred, add)
        # K1: the sum over layers of the bilinear sample
        lib_in = [l.expand(v, -1, -1, -1) for l in layers_cf]

        def library_gather():
            return sum(F.grid_sample(x, grid, mode="bilinear",
                                     padding_mode="border", align_corners=True)
                       for x in lib_in)

        err = check("K1_gather", gs.gather_layers(layers, grid),
                    gs.gather_layers_plain(layers, grid))
        gather_bytes = npx * (8 + 12) + 12 * touched_texels(grid, layers)
        k1_ms = add("K1_gather", f"level {i}", err,
                    lambda: gs.gather_layers(layers, grid),
            lambda: gs.gather_layers_plain(layers, grid),
            library_gather, gather_bytes)
        err = check("K1_gather_bf16", gs.gather_layers(layers, grid, "bf16"),
                    gs.gather_layers_plain_bf16(layers, grid))
        add("K1_gather_bf16", f"level {i}", err,
            lambda: gs.gather_layers(layers, grid, "bf16"),
            lambda: gs.gather_layers_plain_bf16(layers, grid),
            None, gather_bytes, f32_mode_ms=k1_ms)
        # K2: cotangent zero where the level's gradient weight is zero, as on
        # the main path
        gen = torch.Generator(device="cuda").manual_seed(i)
        g = torch.randn((v, h, w, 3), generator=gen, device="cuda")
        g = (g * aux.grad_weights[i]).contiguous()
        err = check("K2_splat", gs.splat_layers(g, grid, shapes),
                    gs.splat_layers_plain(g, grid, shapes))
        lib_leaf = [x.detach().requires_grad_() for x in lib_in]
        lib_out = sum(F.grid_sample(x, grid, mode="bilinear",
                                    padding_mode="border", align_corners=True)
                      for x in lib_leaf)
        g_cf = g.permute(0, 3, 1, 2)
        splat_bytes = npx * (12 + 8) + 12 * sum(a * b for a, b in shapes)
        k2_ms = add("K2_splat", f"level {i}", err,
                    lambda: gs.splat_layers(g, grid, shapes),
            lambda: gs.splat_layers_plain(g, grid, shapes),
            lambda: torch.autograd.grad(lib_out, lib_leaf, g_cf,
                                                retain_graph=True),
            splat_bytes)
        del lib_out, lib_leaf
        err = check("K2_splat_bf16", gs.splat_layers(g, grid, shapes, "bf16"),
                    gs.splat_layers_plain_bf16(g, grid, shapes))
        add("K2_splat_bf16", f"level {i}", err,
            lambda: gs.splat_layers(g, grid, shapes, "bf16"),
            lambda: gs.splat_layers_plain_bf16(g, grid, shapes),
            None, splat_bytes, f32_mode_ms=k2_ms)
        banded_kernels(f"level {i}", layers, grid, g, add)

        # K3 / K4 at the fused (level, layer) pairs
        fused = aux.loss_aux["gram_masks"][i]
        if not fused:
            continue
        with torch.no_grad():
            pred = sample_texture(state.texture, grid)
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

    out = []
    for name, spec in KERNELS.items():
        r = rows[name]
        n, per_step = launches[name]
        row = dict(
            name=name, route="cuda", source=spec["source"],
            replaces=spec["replaces"], launches=n,
            launches_per_step=per_step,
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
        if r["library_ms"] is None and name.endswith("_bf16"):
            row["f32_mode_ms"] = r["f32_mode_ms"]
        out.append(row)
    return out


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
    "conv3x3_gemm_kernel": ("ILi1ELi256E", "ILi2ELi128E", "ILi2ELi64E"),
    "conv_relu_pool_kernel": ("ILi2ELi64ELb0E", "ILi2ELi128ELb0E",
                              "ILi2ELi64ELb1E", "ILi2ELi128ELb1E"),
    "conv_relu_pool_bwd_kernel": ("",),
    "gram_fwd_kernel": ("ILi1E", "ILi2E"),
    "gram_bwd_kernel": ("ILi1ELi1E", "ILi2ELi1E", "ILi1ELi2E", "ILi2ELi2E"),
}


def conv_core_sass():
    """Raise unless every instantiation of the wgmma kernels (K5/K9, K6/K7,
    K8, K3, K4) in the built library holds warpgroup MMA instructions (HGMMA
    in its SASS) and no kernel of ``gram.cu`` holds a WMMA ``HMMA``; print
    their count and shapes per kernel, and the Gram kernels' registers and
    local memory."""
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
    usage = subprocess.run(["cuobjdump", "-res-usage", str(lib)],
                           capture_output=True, text=True, check=True).stdout
    for fn, regs, local in re.findall(
            r"Function ([^\s:]+):\s*REG:(\d+)[^\n]*?LOCAL:(\d+)", usage):
        if "gram_" in fn:
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
    launches = {k: (counts[k], counts[k] / STEPS) for k in BENCH_KERNELS}
    reference_check()
    reference_check_bf16()
    launches.update(run_loop_phases(pipe, state, batch, aux))
    rows = kernel_phase(pipe, state, batch, aux, launches)
    for r in rows:
        other = (f"library {r['library_ms']:.4f} ({r['library_ms_min']:.4f}-"
                 f"{r['library_ms_max']:.4f})" if r["library_ms"] is not None
                 else f"f32 mode {r['f32_mode_ms']:.4f}" if "f32_mode_ms" in r
                 else "library none")
        rate = (f", {r['tflop_per_s']:.1f} TFLOP/s" if "tflop_per_s" in r
                else "")
        log(f"[kernel] {r['name']}: {r['ms']:.4f} ms/step ({r['ms_min']:.4f}-"
            f"{r['ms_max']:.4f}; bound {r['bound_ms']:.4f} "
            f"by {r['bound_by']}), plain {r['plain_ms']:.4f}, {other}, "
            f"{r['launches_per_step']:g} launches/step{rate}")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
