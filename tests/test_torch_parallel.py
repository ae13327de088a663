"""Port parity: the multi-device modes (``stylemesh_tpu_torch/parallel``) on
4 gloo ranks on the CPU, against the JAX package's single-device step and
the port's own.

One spawn of 4 ranks (``tests/torch_parallel_worker.py``) runs every case:
the atlas-sharded step over 4 ranks; then ranks 0-1 run it over 2 and the
run loop with ``shard_atlas``, while ranks 2-3 run the view-parallel step
and a 2-style sweep. Each rank has 240 s.

Inputs: float32, a 64² x 2 Laplacian atlas from a random texture, He-scaled
random VGG (``init_vgg_params(rng=7, he=True)``), 4 synthetic views, the
full-method loss (angle weighting, depth scaling, multi style pyramid,
regularizer).

Tolerances:
- losses against the JAX single-device step: 2e-4 relative (float32
  against ``Precision.HIGHEST``, as ``tests/test_parallel.py`` holds the
  JAX package's own sharded steps);
- gradients, magnitude-sensitive: every entry within 2e-3 of the layer's
  largest JAX gradient (a 1/D or D-times scale error shows at once; Adam's
  first, sign-like step would hide it);
- against the port's single-device step, whose arithmetic the modes repeat
  but for the order of the cross-rank sums: 1e-5 of the largest gradient
  and 1e-5 relative on the losses; the texture after one Adam step
  1e-4 absolute (an entry's step is ``lr * g / (|g| + eps)``);
- the multi-style sweep against single-style runs: 1e-6 relative on the
  losses, and the textures after two Adam steps 1e-4 absolute as above
  (the same arithmetic per style, but the sweep on one rank runs on the
  test process's threads, so its float32 sums are taken in another order).

The ranks and the single-device reference compute on one thread each
(``torch_parallel_worker.one_thread``): a first ``torch.sqrt`` split over
threads has given Adam a square root about 2^-12 off on one thread's share
of a layer (the worker's docstring). A texture entry off by more than its
bound is reported with its gradient and the gradient's gap to the
reference's.

The banded render sums each pixel's corners in another order than the
unbanded K1 (per band, then over the ranks), and the port's convolutions
sum in another order than XLA's: a float32 rounding apart. A texture whose
VGG activations hold a near-tie (a max-pool window or a relu within that
rounding) turns it into a different routing of the gradient in single
entries. Measured on these inputs (one process, plain versions): with the
texture drawn from seed 41 the gradient from the summed band partials
differs from the unbanded one by 2.4e-3 of the largest entry (D = 2 and 4
alike), from seed 4 by 1.8e-4; with seed 3 the port's single-device
gradient differs from JAX's by 3.1e-3; seeds 2, 5, 6 and 7 keep both below
1e-6. The texture here is seed 2's.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylemesh_tpu.data.synthetic import synthetic_view_batch
from stylemesh_tpu.models import pipeline as jpipeline
from stylemesh_tpu.models import vgg as jvgg
from stylemesh_tpu.models.texture import Texture as JTexture
from stylemesh_tpu_torch.convert import batch_from_numpy, vgg_params_from_jax
from stylemesh_tpu_torch.data.schema import ViewBatch
from stylemesh_tpu_torch.models import pipeline as tpipeline
from stylemesh_tpu_torch.optimize import RunConfig, run_training
from tests import torch_parallel_worker as worker
from tests.test_torch_run import SCENE, _make_scene

CFG = dict(steps_per_epoch=1, texture_width=64, texture_height=64,
           hierarchical_layers=2, use_angle_weight=True,
           use_depth_scaling=True, content_weight=7e1, style_weight=1e-4,
           tex_reg_weight=5e3, style_pyramid_mode="multi",
           angle_threshold=30.0, style_min_size=32, learning_rate=0.5,
           remat_vgg=False)
RUN_CFG = dict(texture_width=64, texture_height=64, hierarchical_layers=2,
               use_angle_weight=True, use_depth_scaling=True,
               content_weight=7e1, style_weight=1e-4, tex_reg_weight=5e3,
               style_pyramid_mode="multi", angle_threshold=30.0,
               learning_rate=1.0, decay_step_size=3, style_min_size=16,
               remat_vgg=False, kernel_compute="f32")


def _inputs(tmp):
    rng = np.random.default_rng(41)
    style = ((rng.random((1, 96, 128, 3), dtype=np.float32) - 0.45) * 255.0)
    style2 = ((rng.random((1, 80, 104, 3), dtype=np.float32) - 0.45) * 255.0)
    # a texture without near-ties (see the module docstring)
    layers = [np.random.default_rng(2).normal(0, 20, (64 >> i, 64 >> i, 3))
              .astype(np.float32) for i in range(2)]
    jbatch = synthetic_view_batch(num_views=4, content_hw=(32, 42),
                                  level_heights=(32, 48), seed=9,
                                  jnp_arrays=False)
    # the port's ViewBatch of numpy arrays: the ranks import no JAX
    batch = ViewBatch(*[getattr(jbatch, f) for f in ViewBatch._fields])
    vgg = {k: {n: np.asarray(a) for n, a in p.items()}
           for k, p in jvgg.init_vgg_params(rng=7, he=True).items()}
    style_path = _make_scene(tmp)
    run = dict(root_path=str(tmp), dataset="scannet", scene=SCENE,
               resize_size=16, pyramid_levels=4, min_pyramid_height=16,
               index_repeat=1, max_epochs=1, views_per_batch=2,
               style_image_path=style_path, run_post_steps=False,
               shard_atlas=True, save_texture=True, checkpoint_every_steps=1)
    return dict(cfg=CFG, vgg=vgg, style=style, styles=[style, style2],
                layers=layers, batch=batch, run=run, run_cfg=RUN_CFG,
                port_vgg=vgg_params_from_jax(vgg, device="cpu"))


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    inputs = _inputs(tmp)
    torch.save(inputs, tmp / "inputs.pt")
    ranks = worker.spawn(4, tmp, "parallel")
    return tmp, inputs, ranks


def _jax_reference(inputs):
    """The JAX single-device step: gradients of the loss at the starting
    texture, and one train step's losses."""
    cfg = jpipeline.PipelineConfig(precision=jax.lax.Precision.HIGHEST,
                                   **CFG)
    vgg = {k: {n: jnp.asarray(a) for n, a in p.items()}
           for k, p in inputs["vgg"].items()}
    pipe = jpipeline.TexturePipeline(cfg, vgg, jnp.asarray(inputs["style"]))
    batch = jax.tree.map(jnp.asarray, jpipeline.ViewBatch(**inputs["batch"]._asdict()))
    texture = JTexture.from_arrays(inputs["layers"])
    state = pipe.init()._replace(texture=texture,
                                 opt_state=pipe.optimizer.init(texture))
    aux = pipe.prepare_batch(batch)
    grads = jax.grad(lambda t: pipe.loss_fn(t, batch, None, aux)[0])(texture)
    _, losses = pipe.train_step(state, batch, aux)
    return ([np.asarray(g) for g in grads.layers],
            {k: float(v) for k, v in losses.items()})


@worker.one_thread()
def _port_single(inputs, style=None, steps=1):
    """The port's single-device step on the CPU, on one thread: gradients
    at the start, the losses of ``steps`` steps and the texture after
    them."""
    pipe = tpipeline.TexturePipeline(
        tpipeline.PipelineConfig(**CFG), inputs["port_vgg"],
        torch.from_numpy(inputs["style"] if style is None else style),
        device="cpu")
    state = worker._state(inputs["layers"])
    batch = batch_from_numpy(inputs["batch"], "cpu")
    aux = pipe.prepare_batch(batch)
    grads, _ = worker._grads(pipe, state, batch, aux)
    history = [{k: float(v) for k, v in pipe.train_step(state, batch, aux).items()}
               for _ in range(steps)]
    return grads, history, [l.detach().numpy() for l in state.texture.layers]


@pytest.fixture(scope="module")
def references(spawned):
    _, inputs, _ = spawned
    return _jax_reference(inputs), _port_single(inputs)


def _texture_gaps(got, want, g, g_ref, atol=1e-4):
    """The texture entries off by more than ``atol``: where they lie, their
    gradient ``|g|`` and its gap to the reference's gradient."""
    bad = np.abs(got - want) > atol
    if not bad.any():
        return ""
    rows = np.unique(np.argwhere(bad)[:, 0])
    return (f"{bad.sum()} of {bad.size} entries off, rows {rows.tolist()}; "
            f"|g| there {np.abs(g[bad]).min():.3g}..{np.abs(g[bad]).max():.3g}, "
            f"gap to the reference's gradient up to "
            f"{np.abs(g - g_ref)[bad].max():.3g}")


def _check_grads(got, want, tol):
    for i, (g, w) in enumerate(zip(got, want)):
        scale = max(np.abs(w).max(), 1e-6)
        np.testing.assert_allclose(g / scale, w / scale, rtol=0, atol=tol,
                                   err_msg=f"layer {i} gradient")


def _check_losses(got, want, rtol):
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)


@pytest.mark.parametrize("d", [2, 4])
def test_atlas_step_matches_single_device(spawned, references, d):
    _, _, ranks = spawned
    (jgrads, jlosses), (tgrads, thist, tlayers) = references
    parts = [r[f"atlas{d}"] for r in ranks[:d]]
    grads = [np.concatenate([p["grads"][l] for p in parts])
             for l in range(len(jgrads))]
    for p in parts:
        _check_losses(p["losses"], jlosses, 2e-4)
        _check_losses(p["losses"], thist[0], 1e-5)
    _check_grads(grads, jgrads, 2e-3)
    _check_grads(grads, tgrads, 1e-5)
    # the bands after the step, and their gather on rank 0, are the
    # single-device texture
    assert all(p["full"] is None for p in parts[1:])
    for l, want in enumerate(tlayers):
        band = np.concatenate([p["bands"][l] for p in parts])
        np.testing.assert_allclose(band, want, rtol=0, atol=1e-4,
                                   err_msg=_texture_gaps(band, want, grads[l],
                                                         tgrads[l]))
        np.testing.assert_array_equal(parts[0]["full"][l], band)


def test_view_parallel_step_matches_single_device(spawned, references):
    _, _, ranks = spawned
    (jgrads, jlosses), (tgrads, thist, tlayers) = references
    parts = [r["dp2"] for r in ranks[2:]]
    for p in parts:
        _check_losses(p["history"][0], jlosses, 2e-4)
        _check_losses(p["history"][0], thist[0], 1e-5)
        _check_grads(p["grads"], jgrads, 2e-3)
        _check_grads(p["grads"], tgrads, 1e-5)
        for got, want in zip(p["layers"], tlayers):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # the update is replicated: both ranks hold the same texture
    for a, b in zip(parts[0]["layers"], parts[1]["layers"]):
        np.testing.assert_array_equal(a, b)


def _check_sweep(history, textures, singles):
    for s, (_, hist, layers) in enumerate(singles):
        for step, losses in enumerate(hist):
            for k, v in losses.items():
                np.testing.assert_allclose(history[step][k][s], v, rtol=1e-6,
                                           err_msg=f"style {s} step {step} {k}")
        for got, want in zip(textures[s], layers):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_multistyle_sweep_matches_single_style_runs(spawned):
    """Two styles on one rank (this process) and over two ranks, against
    two independent single-style runs of two steps."""
    from stylemesh_tpu_torch.parallel.mesh import make_mesh
    from stylemesh_tpu_torch.parallel.multistyle import style_ranks

    _, inputs, ranks = spawned
    singles = [_port_single(inputs, style=s, steps=2) for s in inputs["styles"]]
    out = {}
    worker._multistyle(make_mesh(device="cpu"), inputs, "one", out)
    assert out["one"]["local_styles"] == [0, 1]
    _check_sweep(out["one"]["history"], out["one"]["textures"], singles)
    parts = [r["multistyle2"] for r in ranks[2:]]
    assert [p["local_styles"] for p in parts] == [[0], [1]]
    assert parts[1]["textures"] == []  # exports are gathered to rank 0
    for p in parts:
        _check_sweep(p["history"], parts[0]["textures"], singles)
    assert [style_ranks(s, 4) for s in (1, 2, 3, 4, 6)] == [1, 2, 3, 4, 3]


def _metrics(log_dir):
    with open(f"{log_dir}/metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def test_shard_atlas_run_loop_matches_one_rank(spawned):
    """``run_training`` with ``shard_atlas`` over 2 ranks against the same
    call on one rank (where it is the single-device run): the same files,
    keys and tags, a full-size texture, and the first step's losses within
    1e-5 relative (both start from the all-zero texture). The checkpoint
    rank 0 writes holds the full state, and a run resumed from it on 2
    ranks goes on from its step."""
    tmp, inputs, ranks = spawned
    run = RunConfig(log_dir=str(tmp / "run_one"), **inputs["run"])
    _, one_dir, _, _ = run_training(run, tpipeline.PipelineConfig(**RUN_CFG),
                                 device="cpu")
    two_dir = ranks[0]["run_atlas"]["log_dir"]
    assert ranks[1]["run_atlas"]["log_dir"] == two_dir
    files = sorted(p.name for p in (tmp / "run_one" / "version_0").iterdir())
    assert sorted(p.name for p in (tmp / "run_atlas" / "version_0").iterdir()) == files
    assert {"texture.npz", "epoch_0_texture.jpg", "metrics.jsonl",
            "run_config.json", "wallclock.json"} <= set(files)
    # the atlas-sharded run specializes no step to a batch's levels (as in
    # the JAX package), so it has no level_signatures
    with open(f"{one_dir}/wallclock.json") as f, open(f"{two_dir}/wallclock.json") as g:
        assert set(json.load(f)) - {"level_signatures"} == set(json.load(g))
    one, two = _metrics(one_dir), _metrics(two_dir)
    assert [(r["tag"], r["step"]) for r in two] == [(r["tag"], r["step"]) for r in one]
    assert all(np.isfinite(r["value"]) for r in two)
    for a, b in zip(one, two):
        if a["step"] == 1 and a["tag"].startswith("Batch/Loss/train"):
            np.testing.assert_allclose(b["value"], a["value"], rtol=1e-5,
                                       err_msg=a["tag"])
    t1, t2 = np.load(f"{one_dir}/texture.npz"), np.load(f"{two_dir}/texture.npz")
    assert t2.files == t1.files
    for k in t1.files:
        assert t2[k].shape == t1[k].shape
        assert np.isfinite(t2[k]).all()
    ckpt = torch.load(f"{two_dir}/ckpt/train_state.pt", weights_only=True)
    assert ckpt["step"] == 2
    for i, k in enumerate(t2.files):  # the last checkpoint is the last step
        np.testing.assert_array_equal(ckpt["layers"][i].numpy(), t2[k])
        assert ckpt["mu"][i].shape == ckpt["nu"][i].shape == t2[k].shape
    assert ranks[0]["run_atlas"]["resumed_step"] == 4
