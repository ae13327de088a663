"""The paper's preset configurations (counterpart of
``stylemesh_tpu/presets.py``, a copy).

One preset per reference launch script
(``scripts/train/optimize_texture_{scannet,matterport}_{dip,only2D,
with_angle,with_angle_and_depth}.sh``), expressed as CLI-arg overrides. The
two ``*_dip`` presets use ``gram_mode="average"`` (the loss's Gram cache).
"""

_COMMON_SCANNET = {
    "dataset": "scannet",
    "resize_size": 256,
    "texture_size": [4096, 4096],
    "min_images": 1,
    "max_images": 1000,
    "hierarchical": True,
    "learning_rate": 1.0,
    "train_split": 0.99,
    "val_split": 0.01,
    "sampler_mode": "repeat",
    "save_texture": True,
    "split_mode": "sequential",
    "min_pyramid_height": 256,
    "min_pyramid_depth": 0.25,
}

_COMMON_MATTERPORT = dict(_COMMON_SCANNET, dataset="matterport",
                          min_pyramid_depth=0.2)

PRESETS = {
    # "dip" baseline: 1 texture layer, 1 epoch, gram averaging
    "scannet_dip": dict(
        _COMMON_SCANNET,
        hierarchical_layers=1,
        loss_weights=[["content", "7e1"], ["style", "1e-3"], ["tex_reg", "0"]],
        style_weights=[1000.0, 1000.0, 10.0, 10.0, 1000.0],
        decay_step_size=15, max_epochs=1, index_repeat=1,
        style_pyramid_mode="single", gram_mode="average",
        angle_threshold=3000.0, pyramid_levels=1,
        no_depth_scaling=True, no_angle_weight=True,
    ),
    # plain 2D style transfer into the atlas
    "scannet_only2d": dict(
        _COMMON_SCANNET,
        hierarchical_layers=4,
        loss_weights=[["content", "7e1"], ["style", "1e-4"], ["tex_reg", "5e3"]],
        style_weights=[1000.0, 1000.0, 10.0, 10.0, 1000.0],
        decay_step_size=3, max_epochs=7, index_repeat=20,
        style_pyramid_mode="single", gram_mode="current",
        angle_threshold=3000.0, pyramid_levels=1,
        no_depth_scaling=True, no_angle_weight=True,
    ),
    # + angle-weighted gradients and angle-split style targets
    "scannet_with_angle": dict(
        _COMMON_SCANNET,
        hierarchical_layers=4,
        loss_weights=[["content", "7e1"], ["style", "1e-4"], ["tex_reg", "5e3"]],
        style_weights=[1000.0, 1000.0, 10.0, 10.0, 1000.0],
        decay_step_size=3, max_epochs=7, index_repeat=20,
        style_pyramid_mode="multi", gram_mode="current",
        angle_threshold=30.0, pyramid_levels=1,
        no_depth_scaling=True,
    ),
    # the full method (paper headline config)
    "scannet_full": dict(
        _COMMON_SCANNET,
        hierarchical_layers=4,
        loss_weights=[["content", "7e1"], ["style", "1e-4"], ["tex_reg", "5e3"]],
        style_weights=[1000.0, 1000.0, 10.0, 10.0, 1000.0],
        decay_step_size=3, max_epochs=7, index_repeat=20,
        style_pyramid_mode="multi", gram_mode="current",
        angle_threshold=30.0, pyramid_levels=4,
    ),
    "matterport_dip": dict(
        _COMMON_MATTERPORT,
        hierarchical_layers=1, min_pyramid_depth=0.25,
        loss_weights=[["content", "7e1"], ["style", "1e-4"], ["tex_reg", "0"]],
        style_weights=[1000.0, 1000.0, 10.0, 10.0, 1000.0],
        decay_step_size=50, max_epochs=1, index_repeat=1,
        style_pyramid_mode="single", gram_mode="average",
        angle_threshold=3000.0, pyramid_levels=1,
        no_depth_scaling=True, no_angle_weight=True,
    ),
    "matterport_only2d": dict(
        _COMMON_MATTERPORT,
        hierarchical_layers=4,
        loss_weights=[["content", "7e1"], ["style", "1e-4"], ["tex_reg", "5e3"]],
        style_weights=[1000.0, 1000.0, 10.0, 10.0, 1000.0],
        decay_step_size=3, max_epochs=7, index_repeat=100,
        style_pyramid_mode="single", gram_mode="current",
        angle_threshold=3000.0, pyramid_levels=1,
        no_depth_scaling=True, no_angle_weight=True,
    ),
    "matterport_with_angle": dict(
        _COMMON_MATTERPORT,
        hierarchical_layers=4,
        loss_weights=[["content", "7e1"], ["style", "1e-4"], ["tex_reg", "5e3"]],
        style_weights=[1000.0, 1000.0, 10.0, 10.0, 1000.0],
        decay_step_size=3, max_epochs=7, index_repeat=100,
        style_pyramid_mode="multi", gram_mode="current",
        angle_threshold=40.0, pyramid_levels=1,
        no_depth_scaling=True,
    ),
    "matterport_full": dict(
        _COMMON_MATTERPORT,
        hierarchical_layers=4,
        loss_weights=[["content", "7e1"], ["style", "1e-4"], ["tex_reg", "5e3"]],
        style_weights=[1000.0, 1000.0, 10.0, 10.0, 1000.0],
        decay_step_size=3, max_epochs=7, index_repeat=100,
        style_pyramid_mode="multi", gram_mode="current",
        angle_threshold=40.0, pyramid_levels=4,
    ),
}


def apply_preset(args, name, explicit=None):
    """Overlay a preset onto parsed args.

    Explicitly-passed CLI flags are kept (the reference's launch-script
    semantics: the script sets the baseline, extra flags win). ``explicit``
    is the set of dest names actually present on the command line — build it
    with :func:`explicit_cli_keys`. Without it every key is overwritten.
    """
    explicit = explicit or ()
    for k, v in PRESETS[name].items():
        if k in explicit:
            continue  # user passed this flag explicitly
        setattr(args, k, v)
    return args


def explicit_cli_keys(parser_factory, argv=None):
    """Dest names of the flags actually present in ``argv``: re-parse with
    every default suppressed, so only explicitly-passed args materialize."""
    import argparse
    import sys

    p = parser_factory()
    for action in p._actions:
        action.default = argparse.SUPPRESS
    ns, _ = p.parse_known_args(sys.argv[1:] if argv is None else argv)
    return set(vars(ns))
