"""The texture regularizer outside autograd in the train step, on the CPU.

The train step (``TexturePipeline.eager_step``, ``step_loss``) carries the
regularizer's value detached, and ``apply_update`` adds its gradient
``c_l * p`` to the rest of the loss's gradient. Held here against the step
as it was written before, autograd over ``loss_fn``'s total (regularizer
included) followed by the plain update with no coefficients:

- the full method (angle weighting, depth scaling, multi style pyramid,
  ``tex_reg_weight`` 5e3) at 2 and 4 layers: texture and both Adam moments
  within 1e-6 normwise relative, every loss term within 1e-6 relative (the
  fold rounds the product and the sum as autograd did, so in practice the
  bits are the same);
- the DIP preset's configuration (one layer, ``tex_reg_weight`` 0, the Gram
  cache): bit for bit, losses, texture, moments and cache;
- every live level detached: the loss reaches no layer, each layer's
  gradient is the regularizer's alone;
- the plain value equals ``texture_regularizer`` bit for bit, and
  ``step_loss``'s terms ``loss_fn``'s;
- the coefficients, and the ``tex_reg_folded`` counter: one an update on
  a card with the regularizer on, none with it off, none on the CPU.

The kernels themselves are held to the plain versions on a card in
``tests/test_torch_kernels_cuda.py``.
"""

import numpy as np
import pytest
import torch

from stylemesh_tpu_torch.convert import batch_from_numpy
from stylemesh_tpu_torch.data.synthetic import synthetic_view_batch
from stylemesh_tpu_torch.models.pipeline import PipelineConfig, TexturePipeline
from stylemesh_tpu_torch.models.texture import texture_regularizer
from stylemesh_tpu_torch.models.vgg import init_vgg_params
from stylemesh_tpu_torch.ops import adam_kernels
from stylemesh_tpu_torch.utils import profiling

FULL = dict(steps_per_epoch=1, texture_width=64, texture_height=64,
            use_angle_weight=True, use_depth_scaling=True,
            content_weight=7e1, style_weight=1e-4, tex_reg_weight=5e3,
            style_pyramid_mode="multi", angle_threshold=30.0,
            learning_rate=1.0, decay_step_size=3, style_min_size=16,
            remat_vgg=False)
# the scannet_dip preset's loss at a small size
DIP = dict(FULL, hierarchical_layers=1, style_weight=1e-3, tex_reg_weight=0.0,
           style_weights=(1000.0, 1000.0, 10.0, 10.0, 1000.0),
           style_pyramid_mode="single", gram_mode="average",
           angle_threshold=3000.0, use_angle_weight=False,
           use_depth_scaling=False, decay_step_size=15)


def _pipe(**cfg):
    rng = np.random.default_rng(3)
    style = torch.from_numpy(
        (rng.random((1, 64, 85, 3), dtype=np.float32) - 0.45) * 255.0)
    return TexturePipeline(PipelineConfig(**cfg),
                           init_vgg_params(rng=1, he=True, device="cpu"),
                           style, device="cpu")


def _batch(levels=(32, 48)):
    return batch_from_numpy(synthetic_view_batch(
        num_views=2, content_hw=(32, 43), level_heights=levels, seed=4,
        depth_range=(0.2, 0.45), numpy_arrays=True), "cpu")


def _state(pipe, seed=11):
    state = pipe.init()
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in state.texture.layers:
            p.copy_(torch.randn(p.shape, generator=gen) * 20.0)
    return state


def _old_step(pipe, state, batch, aux):
    """The step as autograd over ``loss_fn``: the regularizer's gradient
    joined to the rest by the backward, the update with no coefficients,
    the walked Gram cache copied into the state's."""
    layers = list(state.texture.layers)
    total, losses, cache = pipe.loss_fn(state.texture, batch, aux,
                                        state.gram_cache)
    grads = torch.autograd.grad(total, layers)
    pipe.write_adam_scalars(state.step)
    adam_kernels.adam_clamp_plain_(layers, grads, state.mu, state.nu,
                                   pipe._adam_scalars)
    if cache is not None:
        with torch.no_grad():
            for k, g in cache.grams.items():
                state.gram_cache.grams[k].copy_(g)
            state.gram_cache.count.copy_(cache.count)
    state.step += 1
    return {k: v.detach() for k, v in losses.items()}


def _tensors(state):
    cache = state.gram_cache
    return (list(state.texture.layers) + state.mu + state.nu
            + ([] if cache is None else list(cache.grams.values())
               + [cache.count]))


def _both(cfg, levels=(32, 48)):
    """One folded train step and one old step from the same state."""
    pipe = _pipe(**cfg)
    batch = _batch(levels)
    aux = pipe.prepare_batch(batch)
    new, old = _state(pipe), _state(pipe)
    got = pipe.train_step(new, batch, aux)
    want = _old_step(pipe, old, batch, aux)
    assert new.step == old.step == 1
    return got, want, new, old


def _rel(got, want):
    """Normwise relative gap; 0 where both are equal (a zero moment)."""
    if torch.equal(got, want):
        return 0.0
    return float((got.double() - want.double()).norm()
                 / want.double().norm())


@pytest.mark.parametrize("layers", [2, 4])
def test_folded_step_equals_the_autograd_step(layers):
    got, want, new, old = _both(dict(FULL, hierarchical_layers=layers))
    assert want["tex_reg"] > 0
    for k, w in want.items():
        assert abs(float(got[k]) - float(w)) <= 1e-6 * abs(float(w)), k
    moved = [_rel(n, o) for n, o in zip(new.texture.layers, _state(
        _pipe(**dict(FULL, hierarchical_layers=layers))).texture.layers)]
    assert min(moved) > 0
    for n, o in zip(_tensors(new), _tensors(old)):
        assert _rel(n, o) <= 1e-6


def test_dip_step_is_bit_for_bit_the_autograd_step():
    got, want, new, old = _both(DIP, levels=(32,))
    assert float(want["tex_reg"]) == 0.0
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert int(new.gram_cache.count) == 2
    for n, o in zip(_tensors(new), _tensors(old)):
        assert torch.equal(n, o)


def test_every_level_detached_leaves_the_regularizer_alone():
    """Both levels gradient-dead: the render reaches no layer, and each
    layer moves by the regularizer's gradient alone (the last layer,
    whose weight is 0, not at all)."""
    cfg = dict(FULL, hierarchical_layers=2, stop_grad_levels=(0, 1))
    got, want, new, old = _both(cfg)
    for k, w in want.items():
        assert abs(float(got[k]) - float(w)) <= 1e-6 * abs(float(w)), k
    for n, o in zip(_tensors(new), _tensors(old)):
        assert _rel(n, o) <= 1e-6
    start = _state(_pipe(**cfg)).texture.layers
    assert not torch.equal(new.texture.layers[0], start[0])
    assert torch.equal(new.texture.layers[1], start[1])


@pytest.mark.parametrize("layers", [1, 4])
def test_plain_value_is_the_regularizer(layers):
    pipe = _pipe(**dict(FULL, hierarchical_layers=layers))
    state = _state(pipe)
    weights = pipe.config.resolved_tex_reg_weights()
    want = texture_regularizer(state.texture, weights)
    got = adam_kernels.tex_reg_value(list(state.texture.layers), weights)
    assert not got.requires_grad and want.requires_grad
    assert torch.equal(got, want.detach())
    batch = _batch()
    aux = pipe.prepare_batch(batch)
    total, losses, _ = pipe.step_loss(state.texture, batch, aux)
    ref_total, ref_losses, _ = pipe.loss_fn(state.texture, batch, aux)
    for k in ref_losses:
        assert torch.equal(losses[k].detach(), ref_losses[k].detach()), k
    assert adam_kernels.tex_reg_value.launches == 0


def test_value_refuses_bad_inputs():
    layers = [torch.zeros(8, 8, 3), torch.zeros(4, 4, 3)]
    with pytest.raises(ValueError, match="weights"):
        adam_kernels.tex_reg_value(layers, [1.0])
    with pytest.raises(TypeError, match="float32"):
        adam_kernels.tex_reg_value([layers[0].double()], [1.0])
    with pytest.raises(ValueError, match="contiguous"):
        adam_kernels.tex_reg_value([layers[0].transpose(0, 1)], [1.0])


def test_coefficients():
    cfg = PipelineConfig(texture_width=4096, texture_height=4096,
                         hierarchical_layers=4, tex_reg_weight=5e3)
    want = [5e3 * w * 2.0 / ((4096 >> l) ** 2 * 3)
            for l, w in enumerate((8.0, 4.0, 2.0, 0.0))]
    assert cfg.tex_reg_coefficients() == pytest.approx(want, rel=1e-15)
    assert cfg.tex_reg_coefficients()[3] == 0.0
    off = PipelineConfig(hierarchical_layers=3, tex_reg_weight=0.0)
    assert off.tex_reg_coefficients() == (0.0, 0.0, 0.0)


@pytest.mark.parametrize("weight", [5e3, 0.0])
def test_fold_counted_once_an_update_on_a_card(weight):
    """``prepare_update``, which runs before every executed update (eager,
    or ahead of a graph replay), counts ``tex_reg_folded`` once where the
    update adds the regularizer's gradient on a card; never on the CPU,
    whose steps count nothing (as ``eager_steps``)."""
    pipe = _pipe(**dict(FULL, hierarchical_layers=2, tex_reg_weight=weight))
    state = _state(pipe)
    batch = _batch()
    aux = pipe.prepare_batch(batch)
    with profiling.recording() as rec:
        for _ in range(2):
            pipe.train_step(state, batch, aux)
    assert rec.counters == {}
    pipe.device = torch.device("cuda")  # the counter's branch, no card used
    with profiling.recording() as rec:
        for step in range(3):
            pipe.prepare_update(step)
    assert rec.counters.get("tex_reg_folded", 0) == (3 if weight else 0)
    assert float(pipe._adam_scalars[1]) == pytest.approx(1 - 0.9 ** 3)
