"""Port parity: ``gram_mode='average'`` (``models/losses.py::GramCache`` and
the view-outer cache walk) against the JAX package, on one device and under
the view-parallel step on 2 gloo ranks (``tests/torch_parallel_worker.py``,
240 s per rank), with the checkpoint of the cache and the ``*_dip`` preset
through the CLI.

Inputs: those of ``tests/test_torch_parallel.py`` (float32, 64² x 2 atlas
from a random texture, He-scaled random VGG, 4 synthetic views, the
full-method loss) with ``gram_mode='average'``.

Tolerances:
- one device against JAX, three steps: every loss term 1e-4 relative
  (float32 against ``Precision.HIGHEST``, as ``tests/test_torch_pipeline.py``),
  the cache's Grams after each step 1e-5 relative, or 1e-5 of the layer's
  largest entry where an entry is small (each is a detached per-view Gram
  of the prediction's features, whose float32 sums over 256-512 channels
  differ in order and cancel in the small entries: measured 2.4e-6 of the
  largest entry), the count exactly;
- 2 ranks against the one-device walk: the cache after the step 1e-5
  relative / 1e-6 absolute and the count exactly, as
  ``tests/test_parallel.py`` holds the JAX package's sharded cache: the
  pushes are the per-view Grams and are folded in the sequential walk's
  order. The losses differ by the documented one-step staleness across
  ranks (a view mixes against its own rank's earlier pushes only): 0.3
  relative, as there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylemesh_tpu.models import pipeline as jpipeline
from stylemesh_tpu.models.texture import Texture as JTexture
from stylemesh_tpu_torch.convert import batch_from_numpy
from stylemesh_tpu_torch.models import pipeline as tpipeline
from tests import torch_parallel_worker as worker
from tests.test_torch_parallel import CFG, _inputs
from tests.test_torch_run import SCENE, _make_scene

STEPS = 3
AVG = dict(CFG, gram_mode="average")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return _inputs(tmp_path_factory.mktemp("gram_average"))


def _jax_run(inputs):
    cfg = jpipeline.PipelineConfig(precision=jax.lax.Precision.HIGHEST, **AVG)
    vgg = {k: {n: jnp.asarray(a) for n, a in p.items()}
           for k, p in inputs["vgg"].items()}
    pipe = jpipeline.TexturePipeline(cfg, vgg, jnp.asarray(inputs["style"]))
    batch = jax.tree.map(jnp.asarray,
                         jpipeline.ViewBatch(**inputs["batch"]._asdict()))
    texture = JTexture.from_arrays(inputs["layers"])
    state = pipe.init()._replace(texture=texture,
                                 opt_state=pipe.optimizer.init(texture))
    aux = pipe.prepare_batch(batch)
    history, caches = [], []
    for _ in range(STEPS):
        state, losses = pipe.train_step(state, batch, aux)
        history.append({k: float(v) for k, v in losses.items()})
        caches.append((int(state.gram_cache.count),
                       {k: np.asarray(g) for k, g in
                        state.gram_cache.grams.items()}))
    return history, caches


def _port_run(inputs, steps=STEPS):
    pipe = tpipeline.TexturePipeline(
        tpipeline.PipelineConfig(**AVG), inputs["port_vgg"],
        torch.from_numpy(inputs["style"]), device="cpu")
    state = worker._state(inputs["layers"])
    state.gram_cache = pipe.init().gram_cache
    batch = batch_from_numpy(inputs["batch"], "cpu")
    aux = pipe.prepare_batch(batch)
    history, caches = [], []
    for _ in range(steps):
        history.append({k: float(v) for k, v in
                        pipe.train_step(state, batch, aux).items()})
        caches.append((int(state.gram_cache.count),
                       {k: g.numpy().copy() for k, g in
                        state.gram_cache.grams.items()}))
    return history, caches, state


def _check_cache(got, want, atol):
    """Counts equal; Grams within 1e-5 relative or ``atol`` of the layer's
    largest entry."""
    (gcount, ggrams), (wcount, wgrams) = got, want
    assert gcount == wcount
    assert set(ggrams) == set(wgrams)
    for k, w in wgrams.items():
        np.testing.assert_allclose(ggrams[k], w, rtol=1e-5,
                                   atol=atol * np.abs(w).max(), err_msg=k)


def test_one_device_matches_jax(inputs):
    jhist, jcaches = _jax_run(inputs)
    thist, tcaches, state = _port_run(inputs)
    for step, (t, j) in enumerate(zip(thist, jhist)):
        for k in j:
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4,
                                       err_msg=f"step {step} {k}")
    for t, j in zip(tcaches, jcaches):
        _check_cache(t, j, 1e-5)
    # 4 pushes a step (one nonempty level per view); the ring holds 10
    assert [c[0] for c in tcaches] == [4, 8, 10]
    assert state.gram_cache.push_log is None


def test_view_parallel_cache_matches_sequential_walk(inputs, tmp_path):
    torch.save(inputs, tmp_path / "inputs.pt")
    ranks = worker.spawn(2, tmp_path, "gram_average")
    thist, tcaches, _ = _port_run(inputs, steps=2)
    parts = [r["dp_average"] for r in ranks]
    for p in parts:
        _check_cache((p["caches"][0]["count"], p["caches"][0]["grams"]),
                     tcaches[0], 1e-6)
        np.testing.assert_allclose(p["history"][0]["total"],
                                   thist[0]["total"], rtol=0.3)
        assert all(np.isfinite(v) for h in p["history"] for v in h.values())
        assert p["caches"][1]["count"] == tcaches[1][0]
    # both ranks hold the same cache
    for k, g in parts[0]["caches"][1]["grams"].items():
        np.testing.assert_array_equal(parts[1]["caches"][1]["grams"][k], g)


def test_checkpoint_keeps_the_cache(inputs, tmp_path):
    from stylemesh_tpu_torch.utils.checkpoint import (
        restore_train_state,
        save_train_state,
    )

    _, caches, state = _port_run(inputs, steps=1)
    save_train_state(state, str(tmp_path / "ckpt"))
    fresh = worker._state(inputs["layers"])
    fresh.gram_cache = tpipeline.TexturePipeline(
        tpipeline.PipelineConfig(**AVG), {}, None, device="cpu",
        style_targets=tpipeline.StyleTargets(grams={})).init().gram_cache
    restored = restore_train_state(fresh, str(tmp_path / "ckpt"))
    assert int(restored.gram_cache.count) == caches[0][0]
    for k, g in caches[0][1].items():
        np.testing.assert_array_equal(restored.gram_cache.grams[k].numpy(), g)
    with pytest.raises(ValueError, match="Gram cache"):
        restore_train_state(worker._state(inputs["layers"]),
                            str(tmp_path / "ckpt"))


def test_dip_preset_runs_through_the_cli(tmp_path):
    """``--preset scannet_dip`` (one layer, one level, gram averaging) trains
    from a scene on disk on the CPU."""
    from stylemesh_tpu_torch import cli

    style = _make_scene(tmp_path)
    state, log_dir = cli.main([
        "--preset", "scannet_dip", "--root_path", str(tmp_path),
        "--scene", SCENE, "--style_image_path", style,
        "--texture_size", "64,64", "--resize_size", "16",
        "--min_pyramid_height", "16", "--batch_size", "2",
        "--no_post_steps", "--platform", "cpu",
        "--log_dir", str(tmp_path / "runs")])
    assert state.step == 2  # 4 training views, batches of 2, 1 epoch
    assert int(state.gram_cache.count) == 4  # 2 views x 1 level per step
    assert np.load(f"{log_dir}/texture.npz").files == ["layer_0"]
