"""Port parity: texture sampling (the plain versions of kernels K1/K2) and
the texture module against the JAX package on the CPU.

Tolerance: float32, 1e-5 relative and 1e-3 absolute. Both packages compute
the same bilinear arithmetic, but XLA may fold ``0.5 * (W - 1)`` into one
constant, so the pixel coordinate can differ by one float32 ulp (~4e-6 at
W = 48); that moves a bilinear weight by as much, times texel differences of
up to ~100 here. The scatter-add also sums in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylemesh_tpu.models import texture as jtexture
from stylemesh_tpu.ops.grid_sample import grid_sample as jax_grid_sample
from stylemesh_tpu.ops.grid_sample import grid_sample_nearest as jax_grid_sample_nearest
from stylemesh_tpu.ops.splat_pallas import gather_with_residual, splat_with_residual
from stylemesh_tpu.ops.splat_plan import plan_arrays_for_views
from stylemesh_tpu_torch.convert import texture_from_jax
from stylemesh_tpu_torch.models import texture as ttexture
from stylemesh_tpu_torch.ops import grid_sample as tgs

RNG = np.random.default_rng(17)
F32 = dict(rtol=1e-5, atol=1e-3)


def _grid(v, h, w, lo=-1.2, hi=1.2):
    """Random grid reaching past [-1, 1] (the border clamp) with a block of
    exact (-1, -1) background pixels."""
    g = RNG.uniform(lo, hi, size=(v, h, w, 2)).astype(np.float32)
    g[:, :2, :3] = -1.0
    return g


def _layers(size=(32, 48), n=3):
    return [RNG.normal(0, 40, size=(size[0] >> i, size[1] >> i, 3))
            .astype(np.float32) for i in range(n)]


@pytest.mark.parametrize("n_layers", [1, 3])
def test_sample_value_and_gradient(n_layers):
    layers = _layers(n=n_layers)
    grid = _grid(2, 9, 11)
    ct = RNG.normal(size=(2, 9, 11, 3)).astype(np.float32)

    jtex = jtexture.Texture(layers=tuple(jnp.asarray(l) for l in layers))
    jout, jvjp = jax.vjp(lambda t: jtexture.sample_texture(t, jnp.asarray(grid)),
                         jtex)
    (jgrad,) = jvjp(jnp.asarray(ct))

    ttex = texture_from_jax(layers, device="cpu")
    tout = ttexture.sample_texture(ttex, torch.from_numpy(grid))
    tgrads = torch.autograd.grad(tout, list(ttex.layers), torch.from_numpy(ct))

    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), **F32)
    for tg, jg in zip(tgrads, jgrad.layers):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **F32)
    # the (-1,-1) background samples texel (0,0) of every layer, weight 1
    np.testing.assert_allclose(tout[0, 0, 0].detach().numpy(),
                               sum(l[0, 0] for l in layers), **F32)


def test_single_layer_grid_sample_matches_jax():
    tex = _layers(n=1)[0]
    grid = _grid(1, 6, 5)
    got = tgs.grid_sample(torch.from_numpy(tex), torch.from_numpy(grid))
    want = jax_grid_sample(jnp.asarray(tex), jnp.asarray(grid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_grid_sample_nearest():
    tex = _layers(n=1)[0]
    # the eval grid convention 2x/W - 1 puts coordinates exactly on .5
    ys, xs = np.meshgrid(np.arange(7), np.arange(9), indexing="ij")
    grid = np.stack([2 * xs / 16 - 1, 2 * ys / 12 - 1], -1).astype(np.float32)
    grid = np.concatenate([grid[None], _grid(1, 7, 9)], axis=0)
    got = tgs.grid_sample_nearest(torch.from_numpy(tex), torch.from_numpy(grid))
    want = jax_grid_sample_nearest(jnp.asarray(tex), jnp.asarray(grid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_texture_helpers():
    layers = _layers(size=(16, 16), n=2)
    ttex = texture_from_jax(layers, device="cpu")
    jtex = jtexture.Texture.from_arrays(layers)
    weights = (2.0, 0.5)
    np.testing.assert_allclose(
        ttexture.texture_regularizer(ttex, weights).item(),
        float(jtexture.texture_regularizer(jtex, weights)), rtol=1e-6)
    np.testing.assert_allclose(ttexture.texture_image(ttex).detach().numpy(),
                               np.asarray(jtexture.texture_image(jtex)), **F32)
    big = [l * 10 for l in layers]
    ttex = ttexture.clamp_texture(texture_from_jax(big, device="cpu"))
    jtex = jtexture.clamp_texture(jtexture.Texture.from_arrays(big))
    for a, b in zip(ttex.layers, jtex.layers):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    created = ttexture.Texture.create(32, 16, num_layers=3, device="cpu")
    assert [tuple(l.shape) for l in created.layers] == [(16, 32, 3), (8, 16, 3),
                                                        (4, 8, 3)]


def test_against_planned_pallas_kernels():
    """The port's sampling against the TPU kernels themselves
    (gather_with_residual / splat_with_residual in interpret mode) with a
    plan for a 128x256 atlas."""
    v, h, w = 2, 24, 70
    ys, xs = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    uv = np.stack([np.stack([(0.15 + 0.18 * xs + 0.02 * i) * 2 - 1,
                             (0.15 + 0.18 * ys) * 2 - 1], -1)
                   for i in range(v)]).astype(np.float32)
    uv[:, :2, :2] = -1.0
    tex = RNG.normal(0, 1, (128, 256, 3)).astype(np.float32)
    ct = RNG.normal(size=(v, h, w, 3)).astype(np.float32)
    plan = plan_arrays_for_views(uv, 128, 256)
    jfwd = gather_with_residual(jnp.asarray(tex).transpose(2, 0, 1),
                                jnp.asarray(uv), plan, interpret=True)
    jbwd = splat_with_residual(jnp.asarray(ct), jnp.asarray(uv), plan, 128, 256,
                               interpret=True)

    layer = torch.from_numpy(tex).requires_grad_()
    out = tgs.sample_layers([layer], torch.from_numpy(uv))
    (grad,) = torch.autograd.grad(out, [layer], torch.from_numpy(ct))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jfwd), **F32)
    np.testing.assert_allclose(grad.numpy(),
                               np.asarray(jbwd).transpose(1, 2, 0), **F32)
