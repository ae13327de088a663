"""Training orchestration (counterpart of ``stylemesh_tpu/optimize.py``).

Builds the scene cache, the style image and the pipeline, and runs the
epoch loop (train + validation) with per-epoch texture exports, on one
device or, under ``torchrun``, on every rank of a mesh
(``parallel/mesh.py``):

- pyramid levels empty for every view of the scene are skipped and levels
  whose gradient weight is an exact zero everywhere are detached, for the
  whole run (:func:`scene_skip_levels`, :func:`scene_grad_dead_levels`);
- per batch, a level empty or gradient-dead for all of the batch's views
  gets a specialized pipeline (up to 8 signatures; the dynamic level skip);
- the repeat sampler trains each batch for ``index_repeat`` consecutive
  steps, so a batch is moved to the device and ``prepare_batch``-ed once
  per chunk;
- a step's losses are read one step later, so the host never waits for the
  step it just launched.

The phases of the run go to ``<log_dir>/wallclock.json`` with the JAX
package's keys. The kernels are built at their first use; on a CUDA device
that build is timed under ``compile_first_step`` with the first step.

The multi-device modes, as in the JAX package: ``shard_atlas`` bands the
texture over the ranks (``parallel/atlas.py``), ``data_parallel`` splits
each batch's views (``parallel/train.py``), and several style images make a
multi-style sweep (``parallel/multistyle.py``, also on one rank). With one
rank ``shard_atlas`` and ``data_parallel`` are no-ops. Every rank builds
its own scene cache and draws the same chunks from the same seed; rank 0
alone writes the logs, checkpoints and exports, which hold the full
texture and have the single-device run's shapes and keys.

After training the CLI runs the post chain on rank 0
(``cli.py::post_steps``): :func:`render_styled_frames` renders every cached
view with each exported texture (one K1 launch per chunk of 8 views on the
card), and :func:`build_lpips` gives the reprojection eval its LPIPS
distance.
"""

import dataclasses
import json
import os
import resource
import time
from os.path import join
from typing import Optional

import numpy as np
import torch

from stylemesh_tpu_torch import kernels, resolve_device
from stylemesh_tpu_torch.convert import batch_from_numpy
from stylemesh_tpu_torch.data.grad_masks import grad_weight_masks
from stylemesh_tpu_torch.data.loading import SceneCache, gatys_pre_np
from stylemesh_tpu_torch.data.sampling import (
    batched,
    batched_repeat,
    epoch_indices,
    make_split,
)
from stylemesh_tpu_torch.data.scenes import (
    discover_matterport_regions,
    discover_scannet_scenes,
    select_scene,
)
from stylemesh_tpu_torch.models.pipeline import PipelineConfig, TexturePipeline
from stylemesh_tpu_torch.models.texture import sample_texture
from stylemesh_tpu_torch.models.vgg import (
    convert_torch_state_dict,
    init_vgg_params,
    load_vgg_params,
)
from stylemesh_tpu_torch.ops import grid_sample
from stylemesh_tpu_torch.ops.color import gatys_post
from stylemesh_tpu_torch.ops.resize import resize_bilinear, resize_nearest
from stylemesh_tpu_torch.parallel.atlas import AtlasShardedPipeline
from stylemesh_tpu_torch.parallel.mesh import (
    barrier,
    broadcast_object,
    make_mesh,
)
from stylemesh_tpu_torch.parallel.multistyle import MultiStylePipeline
from stylemesh_tpu_torch.parallel.train import ShardedTexturePipeline
from stylemesh_tpu_torch.utils.checkpoint import (
    restore_train_state,
    save_texture_image,
    save_texture_layers,
    save_texture_npz,
    save_train_state,
)
from stylemesh_tpu_torch.utils.logging import MetricsLogger, StepTimer
from stylemesh_tpu_torch.utils.profiling import StepProfiler

MAX_SPECIALIZATIONS = 8


def _write_wallclock(log_dir, phases):
    """Merge phase timings into <log_dir>/wallclock.json."""
    path = join(log_dir, "wallclock.json")
    existing = {}
    if os.path.exists(path):
        with open(path) as f:
            existing = json.load(f)
    existing.update(phases)
    with open(path, "w") as f:
        json.dump(existing, f, indent=2)


@dataclasses.dataclass
class RunConfig:
    """Run-level options beyond PipelineConfig (dataset, schedule, IO); the
    JAX package's fields."""

    root_path: str = ""
    dataset: str = "scannet"  # 'scannet' | 'matterport'
    matterport_region_index: int = 0
    scene: str = ""
    min_images: int = 1
    max_images: int = -1
    resize_size: int = 256
    pyramid_levels: int = 8
    min_pyramid_depth: float = 0.25
    min_pyramid_height: int = 32
    train_split: float = 0.8
    val_split: float = 0.2
    split_mode: str = "sequential"
    sampler_mode: str = "repeat"
    index_repeat: int = 1
    shuffle: bool = False
    max_epochs: int = 1
    views_per_batch: int = 1
    data_parallel: bool = False  # views over the ranks (no-op on one)
    shard_atlas: bool = False  # texture row bands over the ranks (no-op on one)
    # per-batch level specialization: levels empty for the whole batch
    # skipped, gradient-dead levels detached
    dynamic_level_skip: bool = True
    extra_style_paths: tuple = ()  # more styles: a multi-style sweep
    save_texture: bool = True
    log_images_nth: int = -1  # save pred/rgb/mask image grids every N steps
    checkpoint_every_steps: int = 0  # 0 = only per-epoch texture exports
    resume_from: str = ""  # checkpoint dir of save_train_state to restore
    log_dir: str = "runs"
    tb_logs: bool = False  # also write TensorBoard event files
    vgg_model_path: str = ""
    style_image_path: str = ""
    seed: int = 0
    run_post_steps: bool = True


def load_style_image(path, max_size=2048):
    """Style image -> numpy [1, H, W, 3] Gatys-preprocessed; the shorter side
    is brought down to ``max_size`` when the image is larger."""
    from PIL import Image

    Image.MAX_IMAGE_PIXELS = 933120000
    img = Image.open(path).convert("RGB")
    if img.size[0] > max_size or img.size[1] > max_size:
        w, h = img.size
        if w < h:
            img = img.resize((max_size, round(h * max_size / w)),
                             Image.Resampling.BILINEAR)
        else:
            img = img.resize((round(w * max_size / h), max_size),
                             Image.Resampling.BILINEAR)
    arr = np.asarray(img, dtype=np.float32) / 255.0
    return gatys_pre_np(arr)[None]


def load_vgg(path, device=None):
    """VGG weights from a converted .npz or a torch ``vgg_conv.pth``, else
    random params (weight-free smoke runs)."""
    if path and path.endswith(".npz") and os.path.exists(path):
        return load_vgg_params(path, device=device)
    if path and os.path.exists(path):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        return convert_torch_state_dict(sd, device=device)
    print("WARNING: no VGG weights found — using random init "
          "(style quality will be meaningless; timing is representative).")
    return init_vgg_params(rng=0, device=device)


def discover_scene(run: RunConfig):
    kw = dict(pyramid_levels=run.pyramid_levels,
              min_pyramid_height=run.min_pyramid_height,
              min_pyramid_depth=run.min_pyramid_depth)
    if run.dataset == "scannet":
        scenes = discover_scannet_scenes(join(run.root_path, "train/images"), **kw)
    elif run.dataset == "matterport":
        scenes = discover_matterport_regions(
            join(run.root_path, "v1/scans"),
            region_index=run.matterport_region_index, **kw)
    else:
        raise ValueError(f"Unsupported dataset: {run.dataset}")
    return select_scene(scenes, name=run.scene or None,
                        min_images=run.min_images, max_images=run.max_images,
                        seed=run.seed)


def view_level_tables(scene_cache, pipe_cfg: PipelineConfig):
    """Per-view pyramid-level liveness: two ``[num_views, num_levels]`` bool
    tables ``(loss_live, grad_live)``.

    ``loss_live[v, i]``: view v has a live loss pixel at level i (with depth
    scaling: (rounded | other depth level == i) & uv mask; without it only
    the last level carries loss). ``grad_live[v, i]``: the level's gradient
    weight may be nonzero somewhere in view v (``data/grad_masks.py``); None
    when no reweighting is active. Column-any gives the scene-wide decisions,
    row-any over a batch's views its specialization signature."""
    b = scene_cache._batch_all
    n = len(b.uv)
    mask = np.asarray(b.mask) > 0
    v = mask.shape[0]
    if pipe_cfg.use_depth_scaling:
        rounded = np.asarray(b.rounded_depth_level)
        other = np.asarray(b.other_depth_level)
        loss_live = np.stack(
            [(((rounded == i) | (other == i)) & mask).reshape(v, -1).any(axis=1)
             for i in range(n)], axis=1)
    else:
        loss_live = np.zeros((v, n), bool)
        if n:
            loss_live[:, -1] = True
    level_shapes = [tuple(u.shape[1:3]) for u in b.uv]
    masks = grad_weight_masks(b, level_shapes, pipe_cfg.use_angle_weight,
                              pipe_cfg.use_depth_scaling)
    grad_live = None if masks is None else np.stack(
        [m.reshape(v, -1).any(axis=1) for m in masks], axis=1)
    return loss_live, grad_live


def scene_skip_levels(scene_cache, pipe_cfg: PipelineConfig, tables=None):
    """Pyramid levels with no live loss pixel in any view of the scene."""
    loss_live, _ = tables or view_level_tables(scene_cache, pipe_cfg)
    return tuple(i for i in range(loss_live.shape[1])
                 if not loss_live[:, i].any())


def scene_grad_dead_levels(scene_cache, pipe_cfg: PipelineConfig,
                           tables=None):
    """Pyramid levels whose gradient weight is an exact zero at every pixel
    of every view: their loss value counts, their backward is dropped."""
    _, grad_live = tables or view_level_tables(scene_cache, pipe_cfg)
    if grad_live is None:
        return ()
    return tuple(i for i in range(grad_live.shape[1])
                 if not grad_live[:, i].any())


def _check_modes(run: RunConfig):
    """The JAX package's refusals of mode combinations."""
    if run.shard_atlas and run.data_parallel:
        raise ValueError("--shard_atlas and --data_parallel are exclusive "
                         "(the atlas axis uses the whole mesh)")
    if run.extra_style_paths and (run.shard_atlas or run.data_parallel):
        raise ValueError("multi-style sweeps use the whole mesh for the "
                         "style axis; drop --shard_atlas/--data_parallel")
    if run.extra_style_paths and run.resume_from:
        raise ValueError("--resume_from is not supported for multi-style "
                         "sweeps")


def _full_state(pipe, state):
    """The full train state on rank 0 (atlas bands gathered; every rank
    must call it)."""
    if isinstance(pipe, AtlasShardedPipeline):
        return pipe.gather_state(state)
    return state


def _export_textures(pipe, state, mesh):
    """(style index or None, full texture) pairs to export on rank 0, an
    empty list on the other ranks (every rank must call it)."""
    if isinstance(pipe, MultiStylePipeline):
        return list(enumerate(pipe.textures(state)))
    full = _full_state(pipe, state)
    return [(None, full.texture)] if mesh.is_root else []


def run_training(run: RunConfig, pipe_cfg: PipelineConfig,
                 scene_cache: Optional[SceneCache] = None,
                 vgg_params=None, style_image=None, device=None, mesh=None):
    """The full optimization loop on ``mesh`` (one rank on ``device`` when
    None). Returns (state, log_dir, scene_cache, textures): ``textures`` the
    (style index or None, full texture) pairs exported on rank 0, an empty
    list on the other ranks."""
    if mesh is None:
        mesh = make_mesh(device=device)
    device = mesh.device
    root = mesh.is_root
    say = print if root else (lambda *a, **k: None)
    n_dev = mesh.size
    shard_atlas = run.shard_atlas and n_dev > 1
    data_parallel = run.data_parallel and n_dev > 1
    multi_style = len(run.extra_style_paths) > 0
    _check_modes(run)
    log_dir = None
    if root:
        os.makedirs(run.log_dir, exist_ok=True)
        version = len([d for d in os.listdir(run.log_dir)
                       if d.startswith("version_")])
        log_dir = join(run.log_dir, f"version_{version}")
        os.makedirs(log_dir, exist_ok=True)
    log_dir = broadcast_object(log_dir, mesh)
    logger = MetricsLogger(log_dir if root else None, tb=run.tb_logs)

    clock = StepProfiler(device)
    if device.type == "cuda":
        with clock.phase("compile_first_step"):
            # built at first use, by rank 0 first: the others then load it
            if root:
                kernels.library()
            barrier(mesh)
            kernels.library()
    if scene_cache is None:
        spec = discover_scene(run)
        say(f"Using scene: {spec.name}")
        with clock.phase("scene_cache"):
            scene_cache = SceneCache(spec, resize_size=run.resize_size,
                                     verbose=root)
    tables = loss_live, grad_live = view_level_tables(scene_cache, pipe_cfg)
    n_levels = loss_live.shape[1]
    skip = tuple(sorted(set(scene_skip_levels(scene_cache, pipe_cfg, tables))
                        | set(pipe_cfg.skip_levels)))
    if skip:
        say(f"pyramid levels empty for every view — statically skipped: "
            f"{list(skip)}")
        pipe_cfg = dataclasses.replace(pipe_cfg, skip_levels=skip)
    dead = tuple(sorted(
        (set(scene_grad_dead_levels(scene_cache, pipe_cfg, tables))
         | set(pipe_cfg.stop_grad_levels)) - set(skip)))
    if dead:
        say(f"pyramid levels with provably-zero gradients — backward "
            f"deleted (value kept): {list(dead)}")
        pipe_cfg = dataclasses.replace(pipe_cfg, stop_grad_levels=dead)

    if vgg_params is None:
        vgg_params = load_vgg(run.vgg_model_path, device=device)
    if style_image is None:
        style_image = load_style_image(run.style_image_path)

    train_idx, val_idx = make_split(
        scene_cache.num_views, split=(run.train_split, run.val_split),
        split_mode=run.split_mode, shuffle=run.shuffle, seed=run.seed)

    steps_per_epoch = max(
        1, len(epoch_indices(train_idx, run.sampler_mode, run.index_repeat))
        // run.views_per_batch)
    pipe_cfg = dataclasses.replace(pipe_cfg, steps_per_epoch=steps_per_epoch)

    def make_pipe(cfg, style_targets=None):
        if shard_atlas:
            return AtlasShardedPipeline(cfg, vgg_params, style_image, mesh,
                                        style_targets=style_targets)
        if data_parallel:
            return ShardedTexturePipeline(cfg, vgg_params, style_image, mesh,
                                          style_targets=style_targets)
        return TexturePipeline(cfg, vgg_params, style_image,
                               style_targets=style_targets, device=device)

    with clock.phase("pipeline_build"):
        if multi_style:
            style_images = [style_image] + [
                load_style_image(p) for p in run.extra_style_paths]
            say(f"multi-style sweep: {len(style_images)} styles over "
                f"{n_dev} rank(s)")
            pipe = MultiStylePipeline(pipe_cfg, vgg_params, style_images, mesh)
        else:
            if shard_atlas:
                say(f"atlas-sharded training: texture row-banded over "
                    f"{n_dev} ranks")
            pipe = make_pipe(pipe_cfg)
        state = pipe.init()
    if run.resume_from:
        if shard_atlas:
            state = pipe.shard_state(restore_train_state(pipe.init_full(),
                                                         run.resume_from))
        else:
            state = restore_train_state(state, run.resume_from)
        say(f"resumed from {run.resume_from} at step {state.step}")

    if root:
        with open(join(log_dir, "run_config.json"), "w") as f:
            json.dump({
                "run": dataclasses.asdict(run),
                "pipeline": {k: str(v) for k, v in
                             dataclasses.asdict(pipe_cfg).items()},
                "indices": {"train": train_idx, "val": val_idx},
                "selected_scene": scene_cache.spec.name,
                "levels": [float(l) for l in scene_cache.levels],
            }, f, indent=2)

    timer = StepTimer()
    # per-batch level specialization changes the level set a step runs;
    # it is off where the JAX package turns it off
    specialize = run.dynamic_level_skip and not multi_style and not shard_atlas
    base_sig = (pipe_cfg.skip_levels, pipe_cfg.stop_grad_levels)
    spec_pipes = {}

    def pipe_for_chunk(chunk):
        """The pipeline specialized to the chunk's level signature: levels
        empty for all its views skipped, gradient-dead ones detached, on top
        of the configured sets."""
        if not specialize:
            return pipe
        views = [scene_cache._pos_of[i] for i in chunk]
        live = loss_live[views].any(axis=0)
        glive = (grad_live[views].any(axis=0) if grad_live is not None
                 else np.ones(n_levels, bool))
        sig_skip = tuple(i for i in range(n_levels)
                         if not live[i] or i in pipe_cfg.skip_levels)
        sig_sg = tuple(i for i in range(n_levels) if i not in sig_skip
                       and (not glive[i] or i in pipe_cfg.stop_grad_levels))
        sig = (sig_skip, sig_sg)
        if sig == base_sig:
            return pipe
        spec = spec_pipes.get(sig)
        if spec is None:
            if len(spec_pipes) >= MAX_SPECIALIZATIONS:
                return pipe
            say(f"batch level signature skip={list(sig[0])} "
                f"stop_grad={list(sig[1])}: specializing step")
            spec = make_pipe(dataclasses.replace(
                pipe_cfg, skip_levels=sig[0], stop_grad_levels=sig[1]),
                style_targets=pipe.style_targets)
            spec_pipes[sig] = spec
        return spec

    # the repeat sampler trains one chunk for index_repeat consecutive steps:
    # its host slice, device copy and batch constants are made once
    last_chunk, last_batch, last_aux = None, None, None

    def get_device_batch(chunk):
        nonlocal last_chunk, last_batch, last_aux
        key = tuple(chunk)
        if key != last_chunk:
            last_batch = batch_from_numpy(scene_cache.get_batch(chunk), device)
            last_aux = pipe_for_chunk(chunk).prepare_batch(last_batch)
            last_chunk = key
        return last_batch, last_aux

    host_step = state.step
    first_step_s = None
    # the sampling kernels' launches in the train steps, for the log
    train_launches = dict.fromkeys(grid_sample.launch_counts(), 0)
    t_train0 = time.perf_counter()
    for epoch in range(run.max_epochs):
        if run.sampler_mode == "repeat" and isinstance(run.index_repeat, int) \
                and run.index_repeat > 1:
            chunks = batched_repeat(train_idx, run.views_per_batch,
                                    run.index_repeat)
        else:
            stream = epoch_indices(train_idx, run.sampler_mode,
                                   run.index_repeat, seed=run.seed + epoch)
            chunks = batched(stream, run.views_per_batch)
        # losses are logged one step late: reading a step's losses waits
        # for that step, so the host would stop queueing work for the card
        pending = None  # (losses of the previous step, its step number)
        launches0 = grid_sample.launch_counts()
        for chunk in chunks:
            if first_step_s is None:
                t0 = time.perf_counter()
                with clock.phase("compile_first_step"):
                    batch, aux = get_device_batch(chunk)
                    losses = pipe_for_chunk(chunk).train_step(state, batch, aux)
                first_step_s = time.perf_counter() - t0
            else:
                batch, aux = get_device_batch(chunk)
                losses = pipe_for_chunk(chunk).train_step(state, batch, aux)
            host_step += 1
            step_no = host_step
            timer.tick()
            if pending is not None:
                logger.batch_losses("train", _loss_scalars(pending[0]),
                                    pending[1])
            pending = (losses, step_no)
            if (run.checkpoint_every_steps and not multi_style
                    and step_no % run.checkpoint_every_steps == 0):
                full = _full_state(pipe, state)
                if root:
                    save_train_state(full, join(log_dir, "ckpt"))
            if (run.log_images_nth > 0 and not multi_style
                    and step_no % run.log_images_nth == 0):
                full = _full_state(pipe, state)
                if root:
                    _log_image_grid(logger, full, batch, step_no)
        if pending is not None:
            logger.batch_losses("train", _loss_scalars(pending[0]),
                                pending[1])
        for k, n in grid_sample.launch_counts().items():
            train_launches[k] += n - launches0[k]
        with clock.phase("validation"):
            for chunk in batched(epoch_indices(val_idx, "sequential"),
                                 run.views_per_batch):
                batch = batch_from_numpy(scene_cache.get_batch(chunk), device)
                losses = pipe.eval_step(state, batch)
                logger.batch_losses("val", _loss_scalars(losses), host_step)
        tr = logger.epoch_means("train", epoch)
        va = logger.epoch_means("val", epoch)
        say(f"epoch {epoch}: train {tr} val {va} "
            f"({timer.steps_per_sec:.2f} steps/s, "
            f"{timer.steps_per_sec * run.views_per_batch:.2f} views/s)")

        if run.save_texture:
            with clock.phase("texture_export"):
                for s, tex in _export_textures(pipe, state, mesh):
                    tag = f"epoch_{epoch}" + ("" if s is None else f"_style{s}")
                    save_texture_layers(tex, log_dir, tag)
                    save_texture_image(tex, log_dir, tag + "_")
    # one line per rank: where it ran, what its train steps launched, its
    # memory (host: the process's peak resident set)
    rank_line = {"backend": mesh.backend, "device": str(device),
                 "train_steps": host_step, "train_launches": train_launches,
                 "host_max_rss_gb": resource.getrusage(
                     resource.RUSAGE_SELF).ru_maxrss / 1e6}
    if device.type == "cuda":
        rank_line["peak_device_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    if getattr(state, "gram_cache", None) is not None:
        rank_line["gram_cache_count"] = int(state.gram_cache.count)
    # one write, so that the ranks' lines do not interleave
    print(f"[rank {mesh.rank}/{n_dev}] {json.dumps(rank_line)}\n", end="",
          flush=True)
    with clock.phase("texture_export"):
        textures = _export_textures(pipe, state, mesh)
        for s, tex in textures:
            name = "texture.npz" if s is None else f"texture_style{s}.npz"
            save_texture_npz(tex, join(log_dir, name))
    logger.close()

    t_total = time.perf_counter() - t_train0
    wall = clock.summary()
    overhead = (first_step_s or 0.0) + sum(
        v["total_s"] for k, v in wall.items()
        if k in ("validation", "texture_export"))
    wall["train_steps"] = {"total_s": round(t_total - overhead, 3),
                           "steps": host_step}
    if specialize and spec_pipes:
        wall["level_signatures"] = {
            "specialized": len(spec_pipes),
            "signatures": [{"skip": list(s[0]), "stop_grad": list(s[1])}
                           for s in spec_pipes]}
    if root:
        _write_wallclock(log_dir, wall)
    say("wall-clock:", {k: v["total_s"] for k, v in wall.items()
                        if "total_s" in v})
    return state, log_dir, scene_cache, textures


def _loss_scalars(losses):
    """Loss dict -> float scalars. A multi-style sweep's losses carry a
    leading style axis: the style mean goes under the plain key, and each
    style's total under ``total_style<s>``, as in the JAX package."""
    out = {}
    for k, v in losses.items():
        if v.dim() == 0:
            out[k] = float(v)
            continue
        out[k] = float(v.mean())
        if k == "total":
            for s, x in enumerate(v.tolist()):
                out[f"total_style{s}"] = x
    return out


@torch.no_grad()
def _log_image_grid(logger, state, batch, step):
    """The reference's Images/<state> grid: pred | photo | mask | cos-angle |
    normalized depth, one row per view."""
    hw = tuple(batch.rgb.shape[1:3])
    # the pyramid level matching the content resolution
    uv = next((u for u in batch.uv if u.shape[1] == hw[0]), batch.uv[0])
    pred = resize_bilinear(gatys_post(sample_texture(state.texture, [uv])[0]), hw)
    rgb = gatys_post(batch.rgb)
    mask3 = batch.mask.float().expand(-1, -1, -1, 3)
    angle3 = batch.angle_guidance.float().expand(-1, -1, -1, 3)
    depth3 = torch.clamp(batch.depth.float() / 10.0, 0, 1).expand(-1, -1, -1, 3)
    rows = torch.cat([pred * mask3, rgb, mask3, angle3, depth3], dim=2)
    logger.image("Images/train", rows.reshape(-1, *rows.shape[2:]).cpu().numpy(),
                 step)


RENDER_CHUNK = 8  # views per render launch


@torch.no_grad()
def render_styled_frames(texture, scene_cache: SceneCache, out_dir,
                         level=-1):
    """Render every cached view by sampling the trained texture at its baked
    UV map of pyramid level ``level`` (default the finest), masked, as
    ``<out_dir>/<dataset idx>.png``; returns the paths. The post-train
    render: the reference runs a native mipmap renderer here. Renders on
    the texture's device, one :func:`sample_texture` call per chunk of
    ``RENDER_CHUNK`` views (one float32 K1 launch on the card)."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    device = texture.layers[0].device
    b = scene_cache._batch_all
    uv = b.uv[level]
    n = len(scene_cache.indices)
    paths = []
    for c0 in range(0, n, RENDER_CHUNK):
        sl = slice(c0, min(c0 + RENDER_CHUNK, n))
        grid = torch.as_tensor(np.asarray(uv[sl], np.float32)).to(device)
        mask = torch.as_tensor(np.asarray(b.mask[sl], np.float32)).to(device)
        # the mask is at content resolution: brought to the UV level's
        m = resize_nearest(mask, tuple(grid.shape[1:3]))
        imgs = (gatys_post(sample_texture(texture, [grid])[0]) * m).cpu().numpy()
        for o, idx in enumerate(scene_cache.indices[sl]):
            path = join(out_dir, f"{idx}.png")
            Image.fromarray((np.clip(imgs[o], 0, 1) * 255 + 0.5)
                            .astype(np.uint8)).save(path)
            paths.append(path)
    return paths


def build_lpips(vgg_model_path="", lpips_weights="", device=None):
    """The LPIPS distance of the eval chain, on ``device``.

    Calibrated lin weights are loaded from ``lpips_weights``, the
    ``STYLEMESH_LPIPS_WEIGHTS`` environment variable, or an
    ``lpips_lin.npz`` next to the VGG weights file; otherwise the
    uncalibrated distance runs and the result JSON carries
    ``lpips_calibrated: false`` (its numbers are then not comparable to the
    paper's)."""
    from stylemesh_tpu_torch.eval.lpips import LPIPSDistance

    device = resolve_device(device)
    candidates = [lpips_weights, os.environ.get("STYLEMESH_LPIPS_WEIGHTS", "")]
    if vgg_model_path:
        candidates.append(join(os.path.dirname(vgg_model_path), "lpips_lin.npz"))
    lin = None
    for c in candidates:
        if c and os.path.exists(c):
            lin = LPIPSDistance.load_lin_weights(c, device)
            break
    return LPIPSDistance(load_vgg(vgg_model_path, device=device),
                         lin_weights=lin)
