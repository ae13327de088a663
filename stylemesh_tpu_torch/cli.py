"""Command-line interface of the port (counterpart of
``stylemesh_tpu/cli.py``): the same flags, on one CUDA card by default.

    python -m stylemesh_tpu_torch.cli --preset scannet_full \\
        --root_path <data root> --scene <scene> --style_image_path <style.jpg> \\
        --bfloat16

``--platform cpu`` runs the kernels' plain versions on the CPU. Under
``torchrun`` every rank runs this module (``parallel/mesh.py::
init_from_env``): ``--shard_atlas`` bands the texture over the ranks,
``--data_parallel`` splits each batch's views, and several
``--style_image_path`` (or ``--style_dir``) make a multi-style sweep:

    torchrun --nproc_per_node 2 -m stylemesh_tpu_torch.cli --shard_atlas ...

After training, unless ``--no_post_steps``, rank 0 runs the post chain for
each exported texture (:func:`post_steps`): the styled frames, their video
and the reprojection eval, with the JAX CLI's files and printed lines.

Difference from the JAX CLI: ``--bfloat16`` also sets
``precision="default"``, so the VGG trunk runs on the hand-written conv
kernels. The JAX CLI keeps ``HIGHEST`` there, which for bf16 operands is
the same function but keeps its convs off its TPU kernels.
"""

import argparse
import json
import os

import torch

from stylemesh_tpu_torch.models.losses import (
    DEFAULT_CONTENT_LAYERS,
    DEFAULT_CONTENT_WEIGHTS,
    DEFAULT_STYLE_LAYERS,
    DEFAULT_STYLE_WEIGHTS,
)
from stylemesh_tpu_torch.models.pipeline import PipelineConfig
from stylemesh_tpu_torch.ops import grid_sample
from stylemesh_tpu_torch.optimize import (
    RunConfig,
    _write_wallclock,
    build_lpips,
    render_styled_frames,
    run_training,
)
from stylemesh_tpu_torch.parallel.mesh import init_from_env, shutdown
from stylemesh_tpu_torch.presets import PRESETS, apply_preset, explicit_cli_keys
from stylemesh_tpu_torch.utils.profiling import StepProfiler


def build_parser():
    p = argparse.ArgumentParser("stylemesh_tpu_torch.cli")
    # dataset / run flags
    p.add_argument("--root_path", default="")
    p.add_argument("--dataset", default="scannet", choices=["scannet", "matterport"])
    p.add_argument("--matterport_region_index", default=0, type=int)
    p.add_argument("--train_split", default=0.8, type=float)
    p.add_argument("--val_split", default=0.2, type=float)
    p.add_argument("--split_mode", default="sequential", choices=["folder", "sequential"])
    p.add_argument("--scene", default="")
    p.add_argument("--max_images", default=-1, type=int)
    p.add_argument("--min_images", default=1, type=int)
    p.add_argument("--resize_size", default=256, type=int)
    p.add_argument("--texture_size", default="512,512",
                   type=lambda s: [int(f) for f in s.split(",")])
    p.add_argument("--hierarchical", default=False, action="store_true")
    p.add_argument("--hierarchical_layers", default=4, type=int)
    p.add_argument("--random_texture_init", default=False, action="store_true")
    p.add_argument("--batch_size", default=1, type=int,
                   help="views per train step (reference: always 1)")
    p.add_argument("--learning_rate", default=1.0, type=float)
    p.add_argument("--loss_weight", action="append",
                   type=lambda kv: kv.split("="), dest="loss_weights")
    p.add_argument("--tex_reg_weight", action="append",
                   type=lambda kv: kv.split("="), dest="tex_reg_weights")
    p.add_argument("--decay_gamma", default=0.1, type=float)
    p.add_argument("--decay_step_size", default=30, type=int)
    p.add_argument("--num_workers", default=4, type=int,
                   help="accepted for reference-compat; the packed scene cache "
                        "makes loader workers unnecessary")
    p.add_argument("--log_images_nth", default=-1, type=int)
    p.add_argument("--save_texture", default=False, action="store_true")
    p.add_argument("--shuffle", default=False, action="store_true")
    p.add_argument("--sampler_mode", default="repeat",
                   choices=["random", "sequential", "repeat"])
    p.add_argument("--index_repeat", default=1, type=int)
    p.add_argument("--max_epochs", default=1, type=int)
    p.add_argument("--log_dir", default="runs")

    # style-transfer flags
    p.add_argument("--vgg_gatys_model_path", default="", type=str)
    p.add_argument("--style_image_path", action="append", default=None,
                   type=str,
                   help="repeatable: N paths ask for an N-style sweep")
    p.add_argument("--style_dir", default="", type=str,
                   help="one texture per image in this directory (a "
                        "multi-style sweep); merged with --style_image_path")
    p.add_argument("--style_layers", type=lambda s: s.split(","),
                   default=list(DEFAULT_STYLE_LAYERS))
    p.add_argument("--content_layers", type=lambda s: s.split(","),
                   default=list(DEFAULT_CONTENT_LAYERS))
    p.add_argument("--style_weights", type=lambda s: [float(f) for f in s.split(",")],
                   default=list(DEFAULT_STYLE_WEIGHTS))
    p.add_argument("--content_weights", type=lambda s: [float(f) for f in s.split(",")],
                   default=list(DEFAULT_CONTENT_WEIGHTS))
    p.add_argument("--no_angle_weight", default=False, action="store_true")
    p.add_argument("--no_depth_scaling", default=False, action="store_true")
    p.add_argument("--angle_threshold", default=60.0, type=float)
    p.add_argument("--pyramid_levels", default=8, type=int)
    p.add_argument("--min_pyramid_depth", default=0.25, type=float)
    p.add_argument("--min_pyramid_height", default=32, type=int)
    p.add_argument("--style_pyramid_mode", default="single", choices=["single", "multi"])
    p.add_argument("--gram_mode", default="current", choices=["current", "average"])
    p.add_argument("--renderer_mipmap", default=None, type=str,
                   help="accepted for reference-compat")

    # port flags (the JAX CLI's accelerator flags)
    p.add_argument("--preset", default=None, choices=sorted(PRESETS.keys()))
    p.add_argument("--platform", default=None, choices=["cpu", "gpu"],
                   help="'cpu' runs the kernels' plain versions on the CPU; "
                        "the default is the CUDA card")
    p.add_argument("--data_parallel", default=False, action="store_true",
                   help="split each batch's views over the torchrun ranks "
                        "(a no-op on one rank)")
    p.add_argument("--shard_atlas", default=False, action="store_true",
                   help="split the texture into row bands over the torchrun "
                        "ranks (a no-op on one rank)")
    p.add_argument("--no_dynamic_level_skip", default=False,
                   action="store_true",
                   help="disable per-batch level specialization (skipping "
                        "pyramid levels that are empty or gradient-dead for "
                        "the whole batch)")
    p.add_argument("--bfloat16", default=False, action="store_true",
                   help="bfloat16 VGG compute on the hand-written conv "
                        "kernels")
    p.add_argument("--kernel_compute", default="bf16", choices=["f32", "bf16"],
                   help="gather/splat kernel (K1/K2) numerics")
    p.add_argument("--remat_min_px", default=600_000, type=int,
                   help="recompute-in-backward only pyramid levels with >= "
                        "this many pixels; 0 remats every level")
    p.add_argument("--remat_vgg", default="auto",
                   choices=["auto", "on", "off"],
                   help="rematerialize VGG activations in the backward; "
                        "'auto' turns it on above batch_size 4 under "
                        "--bfloat16 and above 2 in float32")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--no_post_steps", default=False, action="store_true")
    p.add_argument("--tb_logs", default=False, action="store_true",
                   help="also write TensorBoard event files (scalars and "
                        "image grids; utils/tb_events.py)")
    return p


def configs_from_args(args):
    loss_weights = {l[0]: float(l[1]) for l in (args.loss_weights or [])}
    tex_reg_weights = None
    if args.tex_reg_weights:
        d = {int(w[0]): float(w[1]) for w in args.tex_reg_weights}
        tex_reg_weights = tuple(d[i] for i in range(len(d)))

    pipe = PipelineConfig(
        texture_width=args.texture_size[0],
        texture_height=args.texture_size[1],
        hierarchical_layers=args.hierarchical_layers if args.hierarchical else 1,
        random_texture_init=args.random_texture_init,
        style_layers=tuple(args.style_layers),
        content_layers=tuple(args.content_layers),
        style_weights=tuple(args.style_weights),
        content_weights=tuple(args.content_weights),
        use_angle_weight=not args.no_angle_weight,
        use_depth_scaling=not args.no_depth_scaling,
        angle_threshold=args.angle_threshold,
        style_pyramid_mode=args.style_pyramid_mode,
        gram_mode=args.gram_mode,
        content_weight=loss_weights.get("content", 0.0),
        style_weight=loss_weights.get("style", 0.0),
        tex_reg_weight=loss_weights.get("tex_reg", 0.0),
        tex_reg_weights=tex_reg_weights,
        learning_rate=args.learning_rate,
        decay_gamma=args.decay_gamma,
        decay_step_size=args.decay_step_size,
        compute_dtype=torch.bfloat16 if args.bfloat16 else None,
        precision="default" if args.bfloat16 else "highest",
        kernel_compute=args.kernel_compute,
        remat_min_px=args.remat_min_px,
        remat_vgg=((args.batch_size > 4 if args.bfloat16
                    else args.batch_size > 2)
                   if args.remat_vgg == "auto"
                   else args.remat_vgg == "on"),
    )
    style_paths = list(args.style_image_path or [])
    if args.style_dir:
        exts = (".jpg", ".jpeg", ".png", ".bmp")
        style_paths += sorted(
            os.path.join(args.style_dir, f)
            for f in os.listdir(args.style_dir)
            if f.lower().endswith(exts))
    if not style_paths:
        style_paths = [""]

    run = RunConfig(
        root_path=args.root_path,
        dataset=args.dataset,
        matterport_region_index=args.matterport_region_index,
        scene=args.scene,
        min_images=args.min_images,
        max_images=args.max_images,
        resize_size=args.resize_size,
        pyramid_levels=args.pyramid_levels,
        min_pyramid_depth=args.min_pyramid_depth,
        min_pyramid_height=args.min_pyramid_height,
        train_split=args.train_split,
        val_split=args.val_split,
        split_mode=args.split_mode,
        sampler_mode=args.sampler_mode,
        index_repeat=args.index_repeat,
        shuffle=args.shuffle,
        max_epochs=args.max_epochs,
        views_per_batch=args.batch_size,
        data_parallel=args.data_parallel,
        shard_atlas=args.shard_atlas,
        dynamic_level_skip=not args.no_dynamic_level_skip,
        extra_style_paths=tuple(style_paths[1:]),
        save_texture=args.save_texture,
        log_images_nth=args.log_images_nth,
        log_dir=args.log_dir,
        tb_logs=args.tb_logs,
        vgg_model_path=args.vgg_gatys_model_path,
        style_image_path=style_paths[0],
        seed=args.seed,
        run_post_steps=not args.no_post_steps,
    )
    return run, pipe


def post_steps(run: RunConfig, textures, cache, log_dir, device):
    """The post chain, once per exported texture (``_style<s>`` tags for a
    sweep): render every cached view into ``styled<tag>/``, assemble
    ``styled<tag>.mp4``, and run the reprojection eval with LPIPS into
    ``<stamp>_output<tag>.json``. Merges the ``post_render``,
    ``post_video`` and ``post_eval`` phases into ``wallclock.json`` and
    prints the sampling kernels' launches of the render and eval phases."""
    from stylemesh_tpu_torch.eval.reprojection import (
        eval_reprojection_consistency,
    )
    from stylemesh_tpu_torch.texturing.video import video_from_files

    clock = StepProfiler(device)
    launches = {}

    def counted(phase, fn, *args, **kwargs):
        before = grid_sample.launch_counts()
        with clock.phase(phase):
            out = fn(*args, **kwargs)
        counts = launches.setdefault(phase, {})
        for k, n in grid_sample.launch_counts().items():
            if n - before[k]:
                counts[k] = counts.get(k, 0) + n - before[k]
        return out

    # the reference always reports LPIPS beside the MSE; lpips_calibrated
    # in the JSON says whether converted lin weights were found
    lpips_fn = build_lpips(run.vgg_model_path, device=device)
    for s, tex in textures:
        tag = "" if s is None else f"_style{s}"
        styled_dir = os.path.join(log_dir, "styled" + tag)
        frames = counted("post_render", render_styled_frames, tex, cache,
                         styled_dir)
        with clock.phase("post_video"):
            video_from_files(frames, os.path.join(log_dir, f"styled{tag}.mp4"))
        results = counted("post_eval", eval_reprojection_consistency, cache,
                          styled_dir, out_dir=log_dir, seed=42,
                          lpips_fn=lpips_fn, suffix=tag, device=device)
        print(f"reprojection eval{tag}:", results)
    _write_wallclock(log_dir, clock.summary())
    print("post-chain wall-clock:",
          {k: v["total_s"] for k, v in clock.summary().items()})
    print("post-chain launches:", json.dumps(launches), flush=True)


def main(argv=None):
    """Parse ``argv``, train, run the post chain on rank 0 unless
    ``--no_post_steps``, and return ``(state, log_dir)``."""
    args = build_parser().parse_args(argv)
    if args.preset:
        args = apply_preset(args, args.preset,
                            explicit=explicit_cli_keys(build_parser, argv))
    run, pipe_cfg = configs_from_args(args)
    mesh = init_from_env("cpu" if args.platform == "cpu" else None)
    try:
        state, log_dir, cache, textures = run_training(run, pipe_cfg,
                                                       mesh=mesh)
        if run.run_post_steps and mesh.is_root:
            post_steps(run, textures, cache, log_dir, mesh.device)
    finally:
        shutdown(mesh)
    return state, log_dir


if __name__ == "__main__":
    main()
