"""Port parity, the slice as a whole: ``TexturePipeline`` with the bench's
full-method configuration (angle weighting and depth scaling on, multi style
pyramid, texture regularizer on, ``steps_per_epoch=1``) at a small size,
three train steps and an eval step from the same texture, batch and VGG
weights as the JAX ``TexturePipeline`` on the CPU.

Tolerances. float32 against JAX ``Precision.HIGHEST``: 1e-4 relative on
every loss term of every step. The texture after three Adam steps at lr 1.0:
Adam's first steps move a texel by about ``lr * g / (|g| + eps)``, so a texel
whose gradient is near the float32 noise of the other package can move by up
to ``lr`` differently in each step; 3.0 absolute after three steps, and 1e-2
normwise relative to the texture change. bf16: every loss term 5e-3 relative (the
activations are rounded to bf16 after differently ordered sums), and the
texture 2.5e-1 normwise relative to its change: Adam's first updates are
close to ``lr * sign(g)``, and within each package the bf16 gradient already
differs from the float32 one by 10-16% normwise (see test_torch_losses.py),
which flips the sign of the small entries. The coarsest layer, which the
regularizer does not weigh, moves only by the style and content gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stylemesh_tpu.data.synthetic import synthetic_view_batch
from stylemesh_tpu.models.losses import StyleTargets as JStyleTargets
from stylemesh_tpu.models import pipeline as jpipeline
from stylemesh_tpu.models import vgg as jvgg
from stylemesh_tpu.models.texture import Texture as JTexture
from stylemesh_tpu_torch.convert import batch_from_numpy, vgg_params_from_jax
from stylemesh_tpu_torch.models import pipeline as tpipeline
from stylemesh_tpu_torch.models.losses import StyleTargets as TStyleTargets

STEPS = 3
CFG = dict(
    steps_per_epoch=1, texture_width=64, texture_height=64,
    hierarchical_layers=2, use_angle_weight=True, use_depth_scaling=True,
    content_weight=7e1, style_weight=1e-4, tex_reg_weight=5e3,
    style_pyramid_mode="multi", angle_threshold=30.0, learning_rate=1.0,
    decay_step_size=3, style_min_size=16)


def _inputs():
    rng = np.random.default_rng(37)
    batch = synthetic_view_batch(num_views=2, content_hw=(32, 43),
                                 level_heights=(32, 48), seed=4,
                                 depth_range=(0.2, 0.45), jnp_arrays=False)
    style = (rng.random((1, 64, 85, 3), dtype=np.float32) - 0.45) * 255.0
    layers = [rng.normal(0, 20, size=(64 >> i, 64 >> i, 3)).astype(np.float32)
              for i in range(2)]
    return batch, style, layers


def _run_jax(bf16):
    batch, style, layers = _inputs()
    cfg = jpipeline.PipelineConfig(
        remat_vgg=False,
        compute_dtype=jnp.bfloat16 if bf16 else None,
        precision=jax.lax.Precision.DEFAULT if bf16 else jax.lax.Precision.HIGHEST,
        **CFG)
    vgg = jvgg.init_vgg_params(rng=1, he=True)
    pipe = jpipeline.TexturePipeline(cfg, vgg, jnp.asarray(style))
    jbatch = jax.tree.map(jnp.asarray, batch)
    texture = JTexture.from_arrays(layers)
    state = pipe.init()._replace(texture=texture,
                                 opt_state=pipe.optimizer.init(texture))
    aux = pipe.prepare_batch(jbatch)
    history = []
    for _ in range(STEPS):
        state, losses = pipe.train_step(state, jbatch, aux)
        history.append({k: float(v) for k, v in losses.items()})
    history.append({k: float(v) for k, v in
                    pipe.eval_step(state, jbatch, aux).items()})
    return history, [np.asarray(l) for l in state.texture.layers], layers


def _run_torch(bf16):
    batch, style, layers = _inputs()
    cfg = tpipeline.PipelineConfig(
        remat_vgg=False,
        compute_dtype=torch.bfloat16 if bf16 else None,
        precision="default" if bf16 else "highest", **CFG)
    vgg = vgg_params_from_jax(
        {k: {n: np.asarray(a) for n, a in p.items()}
         for k, p in jvgg.init_vgg_params(rng=1, he=True).items()},
        device="cpu")
    pipe = tpipeline.TexturePipeline(cfg, vgg, torch.from_numpy(style),
                                     device="cpu")
    tbatch = batch_from_numpy(batch, device="cpu")
    state = pipe.init()
    with torch.no_grad():
        for p, l in zip(state.texture.layers, layers):
            p.copy_(torch.from_numpy(l))
    aux = pipe.prepare_batch(tbatch)
    history = []
    for _ in range(STEPS):
        losses = pipe.train_step(state, tbatch, aux)
        history.append({k: v.item() for k, v in losses.items()})
    history.append({k: v.item() for k, v in
                    pipe.eval_step(state, tbatch, aux).items()})
    assert state.step == STEPS
    return history, [l.detach().numpy() for l in state.texture.layers]


@pytest.mark.parametrize("bf16", [False, True])
def test_train_steps_match_jax(bf16):
    jhist, jlayers, start = _run_jax(bf16)
    thist, tlayers = _run_torch(bf16)
    loss_rel = 5e-3 if bf16 else 1e-4
    for step, (t, j) in enumerate(zip(thist, jhist)):
        for k in ("content", "style", "tex_reg", "total"):
            np.testing.assert_allclose(t[k], j[k], rtol=loss_rel,
                                       err_msg=f"step {step} {k}")
    assert thist[-1]["total"] < thist[0]["total"]
    for t, j, s in zip(tlayers, jlayers, start):
        moved = np.linalg.norm(j - s)
        assert moved > 0
        assert np.linalg.norm(t - j) / moved < (2.5e-1 if bf16 else 1e-2)
        if not bf16:
            assert np.abs(t - j).max() < STEPS * CFG["learning_rate"]


@pytest.mark.parametrize("angle,depth", [(True, True), (True, False),
                                         (False, True)])
def test_prepare_batch_matches_jax(angle, depth):
    """Per-level gradient weights and loss masks: depth_pyramid_masks,
    depth_interpolation_weights, last_level_only_masks. Exact: 0/1 masks,
    erosions and nearest resizes, and one float32 product per weight."""
    batch, _, _ = _inputs()
    shapes = [tuple(u.shape[1:3]) for u in batch.uv]
    jbatch = jax.tree.map(jnp.asarray, batch)
    tbatch = batch_from_numpy(batch, device="cpu")
    want_masks = (jpipeline.depth_pyramid_masks(jbatch, shapes) if depth
                  else jpipeline.last_level_only_masks(jbatch, shapes))
    got_masks = (tpipeline.depth_pyramid_masks(tbatch, shapes) if depth
                 else tpipeline.last_level_only_masks(tbatch, shapes))
    for g, w in zip(got_masks, want_masks):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if depth:
        for g, w in zip(tpipeline.depth_interpolation_weights(tbatch, shapes),
                        jpipeline.depth_interpolation_weights(jbatch, shapes)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)

    cfg = dict(CFG, use_angle_weight=angle, use_depth_scaling=depth)
    vgg = jvgg.init_vgg_params(rng=1, he=True)
    style = np.zeros((1, 16, 16, 3), np.float32)
    jpipe = jpipeline.TexturePipeline(
        jpipeline.PipelineConfig(remat_vgg=False, **cfg), vgg,
        jnp.asarray(style), style_targets=JStyleTargets(grams={}))
    tpipe = tpipeline.TexturePipeline(
        tpipeline.PipelineConfig(remat_vgg=False, **cfg),
        vgg_params_from_jax({k: {n: np.asarray(a) for n, a in p.items()}
                             for k, p in vgg.items()}, device="cpu"),
        torch.from_numpy(style), style_targets=TStyleTargets(grams={}),
        device="cpu")
    jaux = jpipe._prepare_batch(jbatch)
    taux = tpipe.prepare_batch(tbatch)
    for g, w in zip(taux.grad_weights, jaux.grad_weights):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    for g, w in zip(taux.pyramid_masks, jaux.pyramid_masks):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for i in range(len(shapes)):
        for k, f in taux.loss_aux["factors"][i].items():
            np.testing.assert_allclose(f.numpy(),
                                       np.asarray(jaux.loss_aux["factors"][i][k]),
                                       rtol=1e-6)


def test_learning_rate_schedule_matches_optax():
    cfg = dict(CFG, decay_step_size=3, steps_per_epoch=2, decay_gamma=0.1)
    tpipe = tpipeline.TexturePipeline(
        tpipeline.PipelineConfig(**cfg), {}, None,
        style_targets=TStyleTargets(grams={}), device="cpu")
    schedule = optax.exponential_decay(init_value=1.0, transition_steps=6,
                                       decay_rate=0.1, staircase=True)
    for step in range(20):
        np.testing.assert_allclose(tpipe.learning_rate(step),
                                   float(schedule(step)), rtol=1e-6)


def _option_batch(option):
    """Three levels. "skip": level 0 empty in every view (every depth level
    >= 1). "stop_grad": level 0 gradient-dead (depth_level_weight 0 kills
    the rounded term, no pixel has other == 0) but scored."""
    batch = synthetic_view_batch(num_views=2, content_hw=(32, 43),
                                 level_heights=(32, 40, 48), seed=9,
                                 depth_range=(0.2, 0.45), jnp_arrays=False)
    if option == "skip":
        batch = batch._replace(
            rounded_depth_level=np.maximum(batch.rounded_depth_level, 1),
            other_depth_level=np.maximum(batch.other_depth_level, 1))
    elif option == "stop_grad":
        v, h, w = batch.mask.shape[:3]
        rounded = np.zeros((v, h, w, 1), np.float32)
        rounded[:, h // 2:] = 1
        batch = batch._replace(
            rounded_depth_level=rounded, other_depth_level=rounded + 1,
            depth_level_weight=np.zeros((v, h, w, 1), np.float32))
    return batch


OPTIONS = {"skip": dict(skip_levels=(0,)),
           "stop_grad": dict(stop_grad_levels=(0,)),
           "remat": dict(remat_vgg=True, remat_min_px=1500)}


def _run_option_torch(batch, style, layers, vgg, **opts):
    cfg = tpipeline.PipelineConfig(**{**CFG, "remat_vgg": False, **opts})
    pipe = tpipeline.TexturePipeline(cfg, vgg, torch.from_numpy(style),
                                     device="cpu")
    tbatch = batch_from_numpy(batch, device="cpu")
    state = pipe.init()
    with torch.no_grad():
        for p, l in zip(state.texture.layers, layers):
            p.copy_(torch.from_numpy(l))
    aux = pipe.prepare_batch(tbatch)
    history = [{k: v.item() for k, v in pipe.train_step(state, tbatch, aux).items()}
               for _ in range(2)]
    return history, [l.detach().numpy() for l in state.texture.layers]


@pytest.mark.parametrize("option", list(OPTIONS))
def test_level_options_match_full_and_jax(option):
    """``skip_levels`` (an empty level), ``stop_grad_levels`` (a
    gradient-dead level) and ``remat_vgg`` (the levels of at least 1500
    pixels recomputed in the backward) each leave the port's losses and
    texture as they are without the option (1e-6 relative, 1e-5 absolute on
    the texture), and match the JAX pipeline with the same option (float32:
    1e-4 relative per loss, texture within the normwise bound above)."""
    batch = _option_batch(option)
    _, style, layers = _inputs()
    jvgg_params = jvgg.init_vgg_params(rng=1, he=True)
    vgg = vgg_params_from_jax(
        {k: {n: np.asarray(a) for n, a in p.items()}
         for k, p in jvgg_params.items()}, device="cpu")
    full, full_layers = _run_option_torch(batch, style, layers, vgg)
    got, got_layers = _run_option_torch(batch, style, layers, vgg,
                                        **OPTIONS[option])
    for f, g in zip(full, got):
        assert f["style"] > 0
        for k in f:
            np.testing.assert_allclose(g[k], f[k], rtol=1e-6, err_msg=k)
    for a, b in zip(got_layers, full_layers):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)

    cfg = jpipeline.PipelineConfig(**{**CFG, "remat_vgg": False,
                                      **OPTIONS[option]})
    pipe = jpipeline.TexturePipeline(cfg, jvgg_params, jnp.asarray(style))
    jbatch = jax.tree.map(jnp.asarray, batch)
    texture = JTexture.from_arrays(layers)
    state = pipe.init()._replace(texture=texture,
                                 opt_state=pipe.optimizer.init(texture))
    aux = pipe.prepare_batch(jbatch)
    for step in range(2):
        state, losses = pipe.train_step(state, jbatch, aux)
        for k, v in losses.items():
            np.testing.assert_allclose(got[step][k], float(v), rtol=1e-4,
                                       err_msg=f"step {step} {k}")
    for t, j, s in zip(got_layers, state.texture.layers, layers):
        j = np.asarray(j)
        assert np.linalg.norm(t - j) / np.linalg.norm(j - s) < 1e-2


def test_gram_mode_average_is_not_ported():
    """``gram_mode='average'`` is ported now (tests/test_torch_gram_average.py
    holds it against the JAX package): the pipeline builds, its initial
    state carries an empty 10-deep Gram cache per style layer, and a gram
    mode that exists in neither package still raises."""
    cfg = tpipeline.PipelineConfig(gram_mode="average", **CFG)
    pipe = tpipeline.TexturePipeline(cfg, {}, None, device="cpu",
                                     style_targets=TStyleTargets(grams={}))
    cache = pipe.init().gram_cache
    assert int(cache.count) == 0
    assert {k: tuple(g.shape) for k, g in cache.grams.items()} == {
        "r11": (10, 64, 64), "r21": (10, 128, 128), "r31": (10, 256, 256),
        "r41": (10, 512, 512), "r51": (10, 512, 512)}
    assert tpipeline.TexturePipeline(
        tpipeline.PipelineConfig(**CFG), {}, None, device="cpu",
        style_targets=TStyleTargets(grams={})).init().gram_cache is None
    with pytest.raises(ValueError, match="gram_mode"):
        tpipeline.PipelineConfig(gram_mode="mean", **CFG).loss_config()
