"""Port parity: the banded K1/K2 (``ops/grid_sample.py::gather_levels`` /
``splat_levels`` with a band, their plain versions here on the CPU) against
the JAX package's banded TPU kernels.

- Per band: JAX ``gather_with_residual`` / ``splat_with_residual`` on
  ``plan_arrays_banded`` plans with ``row0`` and
  ``include_background=False`` (Pallas in interpret mode), plus the
  background term the JAX wrapper adds once for band 0, against the port's
  band. float32: 1e-5 of the largest value (both compute the same corners
  and weights; they sum in another order). bf16 mode: 1e-2 of the largest
  value. The JAX package rounds only the corners inside its planned
  windows; the corners its banded planner moves to the float32 residual
  lists (footprints that cross a band edge) stay unrounded there and are
  rounded here, so an entry moves by a few bf16 roundings of a texel or a
  weight (2^-9 relative each): 2.5e-3 to 3.6e-3 of the largest value on
  this input.
- Summed over the bands, the partials equal the unbanded K1/K2's plain
  versions (1e-6 of the largest value: one more float32 sum), for several
  layers, D not a power of 2 and bands of one row.
- The psum of the partials against JAX ``grid_sample_banded_cf`` under
  ``shard_map`` over 2 virtual CPU devices, value and gradient, float32:
  1e-5 of the largest value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from stylemesh_tpu.ops.grid_sample import grid_sample_banded_cf
from stylemesh_tpu.ops.splat_pallas import gather_with_residual, splat_with_residual
from stylemesh_tpu.ops.splat_plan import plan_arrays_banded
from stylemesh_tpu.parallel.mesh import make_mesh
from stylemesh_tpu_torch.ops import grid_sample as tgs

H, W = 64, 128  # the smallest atlas the TPU kernels' (8, 128) tiling takes


def _inputs(v=2, h=20, w=36, seed=3):
    """UVs spanning most of the atlas (so footprints straddle every band
    edge), a block of (-1, -1) background pixels, a texture and a
    cotangent."""
    rng = np.random.default_rng(seed)
    ys, xs = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                         indexing="ij")
    uv = np.stack([np.stack([(0.1 + 0.7 * xs + 0.03 * i) * 2 - 1,
                             (0.05 + 0.9 * ys) * 2 - 1], -1)
                   for i in range(v)]).astype(np.float32)
    uv[:, :2, :3] = -1.0
    tex = rng.normal(0, 1, (H, W, 3)).astype(np.float32)
    ct = rng.normal(size=(v, h, w, 3)).astype(np.float32)
    return uv, tex, ct


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("compute,tol", [("f32", 1e-5), ("bf16", 1e-2)])
def test_bands_match_jax_per_band(compute, tol):
    uv, tex, ct = _inputs()
    d = 4
    band_h = H // d
    plan = plan_arrays_banded(uv, H, W, d)
    bg = ((uv[..., 0] == -1) & (uv[..., 1] == -1))[..., None]
    for b in range(d):
        row0 = b * band_h
        pb = jax.tree.map(lambda a: a[b], plan)
        band = tex[row0:row0 + band_h]
        jfwd = np.asarray(gather_with_residual(
            jnp.asarray(band).transpose(2, 0, 1), jnp.asarray(uv), pb,
            compute=compute, interpret=True, include_background=False,
            row0=row0))
        jbwd = np.asarray(splat_with_residual(
            jnp.asarray(ct), jnp.asarray(uv), pb, band_h, W, compute=compute,
            interpret=True, include_background=False,
            row0=row0)).transpose(1, 2, 0)
        if b == 0:  # the background term, owned by the band of row 0
            jfwd = np.where(bg, band[0, 0], jfwd)
            jbwd = jbwd.copy()
            jbwd[0, 0] += (ct * bg).sum(axis=(0, 1, 2))
        (got,) = tgs.gather_levels([torch.from_numpy(band)],
                                   [torch.from_numpy(uv)], compute,
                                   band=([row0], [H]))
        got = got.numpy()
        (grad,) = tgs.splat_levels([torch.from_numpy(ct)],
                                   [torch.from_numpy(uv)], [(band_h, W)],
                                   compute, band=([row0], [H]))
        assert _rel(got, jfwd) <= tol, (b, _rel(got, jfwd))
        assert _rel(grad.numpy(), jbwd) <= tol, (b, _rel(grad.numpy(), jbwd))
        if b != 0:  # no background in the other bands
            assert not got[bg[..., 0]].any()


@pytest.mark.parametrize("compute", ["f32", "bf16"])
@pytest.mark.parametrize("size,d", [((48, 40), 3), ((64, 36), 4),
                                    ((32, 20), 8)])
def test_band_partials_sum_to_the_unbanded_kernels(compute, size, d):
    """Three layers, a grid past the border, background pixels; D = 3 (not
    a power of 2), 4, and 8 (bands of one row in the smallest layer)."""
    rng = np.random.default_rng(sum(size) + d)
    layers = [torch.from_numpy(rng.normal(0, 40, (size[0] >> l, size[1] >> l, 3))
                               .astype(np.float32)) for l in range(3)]
    heights = [l.shape[0] for l in layers]
    grid = rng.uniform(-1.2, 1.2, (2, 9, 11, 2)).astype(np.float32)
    grid[:, :2, :3] = -1.0
    grid = torch.from_numpy(grid)
    ct = torch.from_numpy(rng.normal(size=(2, 9, 11, 3)).astype(np.float32))
    (full,) = tgs.gather_levels_plain(layers, [grid], compute)
    full_grads = tgs.splat_levels_plain([ct], [grid],
                                        [l.shape[:2] for l in layers], compute)
    total, grads = 0, [[] for _ in layers]
    for b in range(d):
        row0s = [b * h // d for h in heights]
        bands = [l[r:r + h // d] for l, r, h in zip(layers, row0s, heights)]
        total = total + tgs.gather_levels(bands, [grid], compute,
                                          band=(row0s, heights))[0]
        for acc, g in zip(grads, tgs.splat_levels(
                [ct], [grid], [tuple(x.shape[:2]) for x in bands], compute,
                band=(row0s, heights))):
            acc.append(g)
    assert _rel(total.numpy(), full.numpy()) <= 1e-6
    for parts, want in zip(grads, full_grads):
        assert _rel(torch.cat(parts).numpy(), want.numpy()) <= 1e-6


def test_psum_matches_jax_shard_map():
    """Two bands, the port's partials summed, against the JAX package's
    atlas-sharded sample (its psum over a 2-device mesh) and, for the
    gradient, its banded backward taken inside the ``shard_map`` of a
    replicated loss ``sum(out * ct)``, as the atlas-sharded step takes
    it."""
    uv, tex, ct = _inputs(seed=5)
    d = 2
    mesh = make_mesh(jax.devices()[:d], axis_name="atlas")
    plan = plan_arrays_banded(uv, H, W, d)

    def local(tex_band_cf, grid, plan_band, ct):
        plan_band = jax.tree.map(lambda a: jnp.squeeze(a, 0), plan_band)

        def sample(t):
            return grid_sample_banded_cf(t, grid, plan_band, "atlas")

        grad = jax.grad(lambda t: jnp.sum(sample(t) * ct))(tex_band_cf)
        return sample(tex_band_cf), grad

    sharded = jax.shard_map(
        local, mesh=mesh, check_vma=False,
        in_specs=(P(None, "atlas"), P(), P("atlas"), P()),
        out_specs=(P(), P(None, "atlas")))
    jout, jgrad = sharded(jnp.asarray(tex).transpose(2, 0, 1),
                          jnp.asarray(uv), plan, jnp.asarray(ct))
    jout, jgrad = np.asarray(jout), np.asarray(jgrad).transpose(1, 2, 0)

    band_h = H // d
    out, grads = 0, []
    for b in range(d):
        band = torch.from_numpy(tex[b * band_h:(b + 1) * band_h]).requires_grad_()
        (y,) = tgs.sample_levels([band], [torch.from_numpy(uv)],
                                 band=([b * band_h], [H]))
        (g,) = torch.autograd.grad(y, [band], torch.from_numpy(ct))
        out, grads = out + y.detach(), grads + [g]
    assert _rel(out.numpy(), jout) <= 1e-5
    assert _rel(torch.cat(grads).numpy(), jgrad) <= 1e-5


def test_banded_autograd_pair_and_checks():
    """``sample_levels``'s backward with a band is the banded splat; the
    CPU path counts no launch; a band outside its layer raises."""
    uv, tex, ct = _inputs(v=1, seed=7)
    before = tgs.launch_counts()
    band = torch.from_numpy(tex[16:48]).requires_grad_()
    for compute in ("f32", "bf16"):
        (y,) = tgs.sample_levels([band], [torch.from_numpy(uv)], compute,
                                 band=([16], [H]))
        (g,) = torch.autograd.grad(y, [band], torch.from_numpy(ct))
        (want,) = tgs.splat_levels_plain(
            [torch.from_numpy(ct)], [torch.from_numpy(uv)], [(32, W)],
            compute, band=([16], [H]))
        assert torch.equal(g, want)
    assert tgs.launch_counts() == before
    with pytest.raises(ValueError, match="outside"):
        tgs._check_bands([(32, W)], [40], [H])


@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_banded_levels_sum_to_the_unbanded_call(compute):
    """The banded multi-level pair (``sample_levels`` with a band) for the 4
    bands of D = 4, three levels of different sizes, one of them detached:
    the bands' partial renders summed are ``sample_levels``'s renders and
    the bands' gradients stacked its gradients (1e-6 of the largest value:
    one more float32 sum)."""
    rng = np.random.default_rng(11)
    layers = [torch.from_numpy(rng.normal(0, 40, (48 >> l, 40 >> l, 3))
                               .astype(np.float32)) for l in range(3)]
    heights = [l.shape[0] for l in layers]
    grids, cts = [], []
    for h, w in ((9, 11), (5, 7), (12, 6)):
        g = rng.uniform(-1.2, 1.2, (2, h, w, 2)).astype(np.float32)
        g[:, :2, :3] = -1.0
        grids.append(torch.from_numpy(g))
        cts.append(torch.from_numpy(rng.normal(size=(2, h, w, 3))
                                    .astype(np.float32)))

    def loss(outs):
        return ((outs[0] * cts[0]).sum() + (outs[1].detach() * cts[1]).sum()
                + (outs[2] * cts[2]).sum())

    leaves = [l.clone().requires_grad_() for l in layers]
    full = tgs.sample_levels(leaves, grids, compute)
    full_grads = torch.autograd.grad(loss(full), leaves)
    d = 4
    total, parts = None, [[] for _ in layers]
    for b in range(d):
        row0s = [b * h // d for h in heights]
        bands = [l[r:r + h // d].clone().requires_grad_()
                 for l, r, h in zip(layers, row0s, heights)]
        outs = tgs.sample_levels(bands, grids, compute, band=(row0s, heights))
        grads = torch.autograd.grad(loss(outs), bands)
        outs = [o.detach() for o in outs]
        total = outs if total is None else [t + o for t, o in zip(total, outs)]
        for acc, g in zip(parts, grads):
            acc.append(g)
    for t, f in zip(total, full):
        assert _rel(t.numpy(), f.detach().numpy()) <= 1e-6
    for p, want in zip(parts, full_grads):
        assert _rel(torch.cat(p).numpy(), want.numpy()) <= 1e-6
