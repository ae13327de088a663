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
    tout = ttexture.sample_texture(ttex, [torch.from_numpy(grid)])[0]
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
    (out,) = tgs.sample_levels([layer], [torch.from_numpy(uv)])
    (grad,) = torch.autograd.grad(out, [layer], torch.from_numpy(ct))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jfwd), **F32)
    np.testing.assert_allclose(grad.numpy(),
                               np.asarray(jbwd).transpose(1, 2, 0), **F32)


def test_bf16_mode_against_planned_pallas_kernels():
    """K1/K2's bf16 mode (their plain versions here) against the TPU
    kernels' ``compute="bf16"`` (gather_with_residual / splat_with_residual
    in interpret mode) with the 128x256 plan above. The JAX package rounds
    only the pixels inside its plan windows and keeps its residual corners
    float32; the port rounds every pixel but the (-1, -1) background.
    Tolerance 1e-2 of the largest value: a bf16 rounding of a texel, weight
    or ``row_w * g`` is at most 2^-9 relative, so a sample or gradient entry
    moves by a few such units; the float32 tent positions (window-local in
    JAX, texel-local here) can also round one weight to the neighbouring
    bf16 value. On this input every pixel lies in a plan window and the
    two agree to 7e-8 (forward) and 1.4e-7 (gradient) of the largest value.
    The background pixels stay exact float32."""
    v, h, w = 2, 24, 70
    ys, xs = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    uv = np.stack([np.stack([(0.15 + 0.18 * xs + 0.02 * i) * 2 - 1,
                             (0.15 + 0.18 * ys) * 2 - 1], -1)
                   for i in range(v)]).astype(np.float32)
    uv[:, :2, :2] = -1.0
    tex = RNG.normal(0, 1, (128, 256, 3)).astype(np.float32)
    ct = RNG.normal(size=(v, h, w, 3)).astype(np.float32)
    plan = plan_arrays_for_views(uv, 128, 256)
    jfwd = np.asarray(gather_with_residual(
        jnp.asarray(tex).transpose(2, 0, 1), jnp.asarray(uv), plan,
        compute="bf16", interpret=True))
    jbwd = np.asarray(splat_with_residual(
        jnp.asarray(ct), jnp.asarray(uv), plan, 128, 256, compute="bf16",
        interpret=True)).transpose(1, 2, 0)

    layer = torch.from_numpy(tex).requires_grad_()
    (out,) = tgs.sample_levels([layer], [torch.from_numpy(uv)], compute="bf16")
    (grad,) = torch.autograd.grad(out, [layer], torch.from_numpy(ct))
    out, grad = out.detach().numpy(), grad.numpy()
    np.testing.assert_allclose(out, jfwd, rtol=0,
                               atol=1e-2 * np.abs(jfwd).max())
    np.testing.assert_allclose(grad, jbwd, rtol=0,
                               atol=1e-2 * np.abs(jbwd).max())
    # the mode does round: it differs from the exact function
    (exact,) = tgs.gather_levels_plain([torch.from_numpy(tex)],
                                       [torch.from_numpy(uv)])
    exact = exact.numpy()
    assert np.abs(out - exact).max() > 1e-4
    # background pixels stay float32: texel (0, 0) exactly, and texel
    # (0, 0)'s gradient holds their cotangent sum exactly as in JAX
    np.testing.assert_array_equal(out[:, :2, :2], np.broadcast_to(
        tex[0, 0], (v, 2, 2, 3)))
    np.testing.assert_allclose(grad[0, 0], jbwd[0, 0], rtol=1e-6)


def test_bf16_mode_plain_versions():
    """The bf16 plain versions on several layers and a grid past the border:
    the bf16 rounding of texels and weights written out independently
    (numpy), the background exact, and both modes reached through
    ``sample_texture(compute=)`` and its autograd pair."""
    layers = _layers(n=3)
    grid = _grid(2, 9, 11)
    ct = RNG.normal(size=(2, 9, 11, 3)).astype(np.float32)
    tl = [torch.from_numpy(l) for l in layers]
    tg = torch.from_numpy(grid)

    def bf(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            torch.bfloat16).float().numpy()

    want = np.zeros((2, 9, 11, 3), np.float32)
    for layer in layers:
        hh, ww = layer.shape[:2]
        px = np.clip((grid[..., 0] + 1.0) * 0.5 * (ww - 1), 0, ww - 1)
        py = np.clip((grid[..., 1] + 1.0) * 0.5 * (hh - 1), 0, hh - 1)
        x0, y0 = np.floor(px).astype(int), np.floor(py).astype(int)
        x1, y1 = np.minimum(x0 + 1, ww - 1), np.minimum(y0 + 1, hh - 1)
        fx, fy = (px - x0).astype(np.float32), (py - y0).astype(np.float32)
        ux, uy = np.float32(1) - fx, np.float32(1) - fy
        wx0, wx1 = bf(ux)[..., None], bf(np.float32(1) - ux)[..., None]
        wy0, wy1 = bf(uy)[..., None], bf(np.float32(1) - uy)[..., None]
        t = bf(layer)
        top = t[y0, x0] * wx0 + t[y0, x1] * wx1
        bot = t[y1, x0] * wx0 + t[y1, x1] * wx1
        want += top * wy0 + bot * wy1
    bg = (grid[..., 0] == -1) & (grid[..., 1] == -1)
    want[bg] = sum(l[0, 0] for l in layers)
    got = tgs.gather_levels(tl, [tg], compute="bf16")[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)

    ttex = texture_from_jax(layers, device="cpu")
    for compute in ("f32", "bf16"):
        out = ttexture.sample_texture(ttex, [tg], compute=compute)[0]
        grads = torch.autograd.grad(out, list(ttex.layers), torch.from_numpy(ct))
        plain = tgs.splat_levels_plain(
            [torch.from_numpy(ct)], [tg], [l.shape[:2] for l in layers],
            compute)
        for a, b in zip(grads, plain):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    with pytest.raises(ValueError, match="compute"):
        tgs.gather_levels(tl, [tg], compute="f16")


def test_texture_from_arrays_copies():
    """The optimizer updates layers in place; a texture built from numpy
    arrays must not write through to them."""
    layers = _layers(n=2)
    before = [l.copy() for l in layers]
    ttex = texture_from_jax(layers, device="cpu")
    with torch.no_grad():
        for p in ttex.layers:
            p.add_(1.0)
    for l, b in zip(layers, before):
        np.testing.assert_array_equal(l, b)


def _level_grids(v=2, sizes=((9, 11), (5, 7), (12, 6))):
    """A step's UV pyramid in small: levels of different sizes."""
    return [_grid(v, h, w) for h, w in sizes]


def _cotangents(grids):
    return [RNG.normal(size=g.shape[:-1] + (3,)).astype(np.float32)
            for g in grids]


@pytest.mark.parametrize("n_layers", [1, 3])
def test_sample_levels_value_and_gradient(n_layers):
    """One sampling call over three levels of different sizes (the
    multi-level K1/K2 pair, their plain versions here) against the JAX
    package's ``sample_texture`` per level, the levels' losses summed under
    ``jax.grad`` (float32, F32)."""
    layers = _layers(n=n_layers)
    grids = _level_grids()
    cts = _cotangents(grids)

    jtex = jtexture.Texture(layers=tuple(jnp.asarray(l) for l in layers))

    def loss(t):
        return sum(jnp.sum(jtexture.sample_texture(t, jnp.asarray(g)) * c)
                   for g, c in zip(grids, cts))

    jgrad = jax.grad(loss)(jtex)
    jouts = [jtexture.sample_texture(jtex, jnp.asarray(g)) for g in grids]

    ttex = texture_from_jax(layers, device="cpu")
    touts = ttexture.sample_texture(ttex, [torch.from_numpy(g) for g in grids])
    tgrads = torch.autograd.grad(touts, list(ttex.layers),
                                 [torch.from_numpy(c) for c in cts])
    assert len(touts) == len(grids)
    for t, j in zip(touts, jouts):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **F32)
    for tg, jg in zip(tgrads, jgrad.layers):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **F32)


def test_sample_levels_bf16_against_per_level_plain():
    """The bf16 mode over a level table: each render the per-level bf16
    plain gather, the gradients the per-level bf16 plain splats summed in
    level order (float32 sums of the same products: 1e-6 relative)."""
    layers = [torch.from_numpy(l) for l in _layers(n=3)]
    grids = [torch.from_numpy(g) for g in _level_grids()]
    cts = [torch.from_numpy(c) for c in _cotangents(grids)]
    leaves = [l.clone().requires_grad_() for l in layers]
    outs = tgs.sample_levels(leaves, grids, compute="bf16")
    grads = torch.autograd.grad(outs, leaves, cts)
    for out, grid in zip(outs, grids):
        np.testing.assert_allclose(
            out.detach().numpy(),
            tgs.gather_levels_plain(layers, [grid], "bf16")[0].numpy(),
            rtol=1e-6)
    shapes = [tuple(l.shape[:2]) for l in layers]
    want = [sum(parts) for parts in zip(*[
        tgs.splat_levels_plain([c], [g], shapes, "bf16")
        for c, g in zip(cts, grids)])]
    for got, w in zip(grads, want):
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-6 * np.abs(w.numpy()).max())
    # the mode rounds: the exact function differs
    exact = tgs.gather_levels_plain(layers, grids)
    assert max(np.abs(o.detach().numpy() - e.numpy()).max()
               for o, e in zip(outs, exact)) > 1e-4


def test_sample_levels_detached_level_and_one_level():
    """A level whose render is detached gets no cotangent and stays out of
    the splat; one level's value and gradient are the plain K1 and K2 of
    its grid; more levels than the kernels' table holds raise on any
    device."""
    layers = [torch.from_numpy(l) for l in _layers(n=2)]
    grids = [torch.from_numpy(g) for g in _level_grids()]
    cts = [torch.from_numpy(c) for c in _cotangents(grids)]
    shapes = [tuple(l.shape[:2]) for l in layers]
    leaves = [l.clone().requires_grad_() for l in layers]
    before = tgs.launch_counts()
    outs = tgs.sample_levels(leaves, grids)
    loss = ((outs[0] * cts[0]).sum() + (outs[1].detach() * cts[1]).sum()
            + (outs[2] * cts[2]).sum())
    grads = torch.autograd.grad(loss, leaves)
    want = tgs.splat_levels_plain([cts[0], cts[2]], [grids[0], grids[2]],
                                  shapes)
    for got, w in zip(grads, want):
        assert torch.equal(got, w)
    assert tgs.launch_counts() == before  # the CPU launches nothing

    one = tgs.sample_levels(leaves, grids[:1])
    assert len(one) == 1
    assert torch.equal(one[0], tgs.gather_levels_plain(layers, grids[:1])[0])
    g1 = torch.autograd.grad(one[0], leaves, cts[0])
    g2 = tgs.splat_levels_plain(cts[:1], grids[:1], shapes)
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)
    assert tgs.sample_levels(leaves, []) == []
    with pytest.raises(ValueError, match="levels"):
        tgs.gather_levels(layers, grids * 3)
