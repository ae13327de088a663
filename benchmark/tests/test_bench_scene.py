"""The scene generator: the same seed gives the same scene, every seed the
same sizes, and the port's data layer reads what it writes."""

import numpy as np

from benchmark import harness, scene

SPEC = {"name": "scene0000_00", "views": 3, "photo_hw": [24, 32],
        "uv_heights": [16, 24], "uv_window": 0.25, "depth_range": [0.4, 7.0],
        "valid_fraction": 0.85, "style_hw": [20, 26]}


def test_same_seed_same_scene():
    a = scene.scene_arrays(SPEC, 2 ** 31 + 7)
    b = scene.scene_arrays(SPEC, 2 ** 31 + 7)
    for x, y in zip(a, b):
        for u, v in zip(x if isinstance(x, list) else [x],
                        y if isinstance(y, list) else [y]):
            np.testing.assert_array_equal(u, v)


def test_seeds_move_windows_not_sizes():
    a = scene.scene_arrays(SPEC, 1)
    b = scene.scene_arrays(SPEC, 2)
    for ua, ub in zip(a[4], b[4]):
        assert ua.shape == ub.shape
        assert not np.array_equal(ua, ub)
    # depth, angle and mask (so the work) do not depend on the seed
    for i in (1, 2, 3):
        np.testing.assert_array_equal(a[i], b[i])
    # each view's window covers uv_window of the atlas side
    uv = a[4][-1]
    span = uv[..., 0].max(axis=(1, 2)) - uv[..., 0].min(axis=(1, 2))
    np.testing.assert_allclose(span, SPEC["uv_window"], rtol=1e-6)


def test_written_scene_loads_through_the_port(tiny):
    root, bench_dir = tiny
    cell = harness.load_cell("scannet_full.b4r20", root, bench_dir)
    with harness.workdir() as wd:
        data_root, name, style = scene.write_scene(
            wd, cell.traffic["scene"], 5)
        run = harness.run_config(cell, data_root, name, style)
        from stylemesh_tpu_torch.data.loading import SceneCache
        from stylemesh_tpu_torch.optimize import discover_scene

        spec = discover_scene(run)
        cache = SceneCache(spec, resize_size=run.resize_size)
        assert cache.num_views == cell.traffic["scene"]["views"]
        assert len(spec.levels) == cell.config["run"]["pyramid_levels"]
        b = cache.get_batch([0, 1])
        assert b.rgb.shape[1] == run.resize_size
        assert float(np.asarray(b.mask).mean()) > 0.5
