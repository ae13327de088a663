"""Port parity: ``geometry/project.py`` (``unproject``, ``reproject``)
against the JAX package on the same seeded numpy inputs, and the K1 route
of the warps.

The scene: a wall with a nearer box in front of it, holes of zero depth,
and cameras that pan and turn enough that pixels project out of bounds and
behind the box (occluded). Tolerances: ``unproject`` 1e-5 relative;
``reproject``'s valid masks equal, warped colours (in [0, 1]) within 1e-4
absolute: XLA may fold ``0.5 * (W - 1)`` in its sampler into one constant,
so a sample coordinate can differ by one float32 ulp (ROADMAP §3). K1's
per-view form's plain version (``gather_each_plain``) equals the per-view
``grid_sample`` exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylemesh_tpu.geometry.project import reproject as jax_reproject
from stylemesh_tpu.geometry.project import unproject as jax_unproject
from stylemesh_tpu_torch.geometry import project
from stylemesh_tpu_torch.ops import grid_sample as gs

H, W = 23, 31  # H * W odd: a view's slice of a batch is not 16-byte aligned


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def scene(n=4, seed=0):
    """Poses, intrinsics, depths, colours and masks of ``n`` views."""
    rng = np.random.default_rng(seed)
    poses = []
    for i in range(n):
        p = np.eye(4)
        p[:3, :3] = _rot_y(0.12 * i - 0.1)
        p[:3, 3] = [0.25 * i, 0.02 * i, -0.1 * i]
        poses.append(p)
    k = np.eye(4)
    k[0, 0], k[1, 1], k[0, 2], k[1, 2] = 28.0, 27.0, W / 2 - 0.3, H / 2 + 0.2
    depth = np.full((n, H, W, 1), 3.0) + rng.normal(0, 0.05, (n, H, W, 1))
    depth[:, 6:15, 9:18] = 1.4  # the box
    depth[:, 18:20, 2:6] = 0.0  # holes
    color = rng.random((n, H, W, 3))
    mask = (depth > 0).astype(np.float32)
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return (f32(np.stack(poses)), f32(np.broadcast_to(k, (n, 4, 4))),
            f32(depth), f32(color), mask)


def test_unproject_matches_jax():
    poses, intr, depth, _, _ = scene()
    got = project.unproject(torch.from_numpy(poses), torch.from_numpy(intr),
                            torch.from_numpy(depth))
    want = jax_unproject(jnp.asarray(poses), jnp.asarray(intr),
                         jnp.asarray(depth))
    assert got.shape == (4, H, W, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def _pairs(poses, intr, depth, color, mask, src, tar):
    return [x[src] for x in (poses,)] + [x[tar] for x in (poses,)] + [
        intr[src], depth[src], depth[tar], color[tar], mask[tar]]


# 9 views: more than one K1 launch of the per-view form (MAX_LEVELS = 8)
@pytest.mark.parametrize("src,tar", [([0, 1, 2, 3], [1, 0, 3, 1]),
                                     ([3, 2], [0, 3]),
                                     ([0, 1, 2, 3, 0, 1, 2, 3, 1],
                                      [1, 0, 3, 1, 2, 3, 0, 2, 3])])
def test_reproject_matches_jax(src, tar):
    args = _pairs(*scene(), src, tar)
    warped, valid = project.reproject(*[torch.from_numpy(a) for a in args])
    jwarped, jvalid = jax_reproject(*[jnp.asarray(a) for a in args])
    jvalid = np.asarray(jvalid)
    assert valid.dtype == torch.bool and valid.shape == (len(src), H, W, 1)
    np.testing.assert_array_equal(valid.numpy(), jvalid)
    # the scene exercises every rejection: some pixels valid, some not
    assert 0.2 < jvalid.mean() < 0.9
    np.testing.assert_allclose(warped.numpy(), np.asarray(jwarped), rtol=0,
                               atol=1e-4)
    assert (warped.numpy()[~valid.numpy()[..., 0]] == 0).all()
    assert not valid[:, 18:20, 2:6].any()  # zero depth in the source


def test_reproject_nan_projection_is_invalid():
    """A source pixel whose projection is 0 / 0 (its camera x and y are 0
    and ``1e-8 + z`` is 0) is invalid with colour 0 in the port, where the
    JAX package's colour there is NaN; every other pixel matches the JAX
    package as in :func:`test_reproject_matches_jax`."""
    poses, intr, depth, color, mask = scene()
    poses[:2] = np.eye(4, dtype=np.float32)  # src view 0, target view 1
    intr[0, 0, 2], intr[0, 1, 2] = 15.0, 11.0  # the pixel (11, 15) is on axis
    depth[0, 11, 15] = -1e-8
    # a NaN coordinate samples pixel 0 (K1's clamp): there the target's
    # depth agrees and its mask is 1, so that only the bounds check can
    # reject the pixel
    depth[1, 0, 0], mask[1, 0, 0] = 0.0, 1.0
    args = _pairs(poses, intr, depth, color, mask, [0, 2], [1, 3])
    warped, valid = project.reproject(*[torch.from_numpy(a) for a in args])
    jwarped, jvalid = (np.asarray(x) for x in
                       jax_reproject(*[jnp.asarray(a) for a in args]))
    assert np.isnan(jwarped[0, 11, 15]).all()  # the JAX package lets NaN through
    assert not valid[0, 11, 15, 0]
    assert (warped[0, 11, 15] == 0).all()
    assert torch.isfinite(warped).all()
    rest = np.ones(valid.shape[:3], bool)
    rest[0, 11, 15] = False
    np.testing.assert_array_equal(valid.numpy()[rest], jvalid[rest])
    assert 0.2 < jvalid[rest].mean() < 0.9
    np.testing.assert_allclose(warped.numpy()[rest], jwarped[rest], rtol=0,
                               atol=1e-4)


def test_warps_take_k1_layers(monkeypatch):
    """The warps make one call of K1's per-view form per image kind
    (colours, masks): images ``[V, H, W, 3]`` and grids ``[V, H, W, 2]``,
    contiguous and 16-byte aligned, as K1 takes them on the card (the
    one-channel mask is warped as three equal channels), and the mask warp
    equals a one-channel warp. Each view's rows of an odd float count (H W
    is odd here) are padded to start 8-byte aligned."""
    calls = []
    real = project.gather_each

    def spy(images, grids):
        calls.append((tuple(images.shape), tuple(grids.shape),
                      images.data_ptr() % 16, grids.data_ptr() % 16,
                      images.is_contiguous(), grids.is_contiguous()))
        return real(images, grids)

    monkeypatch.setattr(project, "gather_each", spy)
    args = [torch.from_numpy(a) for a in _pairs(*scene(), [1, 2, 3], [0, 1, 2])]
    warped, valid = project.reproject(*args)
    assert calls == [((3, H, W, 3), (3, H, W, 2), 0, 0, True, True)] * 2
    grid = torch.from_numpy(np.random.default_rng(3).uniform(
        -1.2, 1.2, (1, H, W, 2)).astype(np.float32))
    m = args[-1][:1]
    three = real(m.expand(-1, -1, -1, 3).contiguous(), grid)[0]
    assert torch.equal(three[..., :1], gs.grid_sample(m[0], grid[0]))
    assert torch.equal(three[..., 0], three[..., 2])
    rows = gs._pair_aligned_rows(torch.zeros((3, H, W, 3)))
    assert rows.shape == (3, H * W * 3) and rows.stride(0) == H * W * 3 + 1
    even = torch.zeros((3, H, W + 1, 3))
    assert gs._pair_aligned_rows(even).data_ptr() == even.data_ptr()


def _each_inputs(n, seed, hw=(5, 9), grid_hw=(7, 11)):
    """``n`` images ``[n, H, W, 3]`` and grids ``[n, *grid_hw, 2]``, 30% of
    the grid entries ±inf, NaN, huge or exactly on the border."""
    rng = np.random.default_rng(seed)
    specials = np.array([np.inf, -np.inf, np.nan, 1e30, -1e30, 1.0, -1.0])
    images = rng.normal(0, 50, (n, *hw, 3))
    grids = rng.uniform(-1.5, 1.5, (n, *grid_hw, 2))
    pick = rng.random(grids.shape) < 0.3
    grids[pick] = specials[rng.integers(0, len(specials), pick.sum())]
    return (torch.from_numpy(images.astype(np.float32)),
            torch.from_numpy(grids.astype(np.float32)))


@pytest.mark.parametrize("n", [1, 5, 8])
def test_gather_each_plain_equals_per_view_grid_sample(n):
    """K1's per-view form on the CPU (its plain version) is the warps'
    former per-view ``grid_sample`` bit for bit, and launches nothing."""
    images, grids = _each_inputs(n, n, hw=(5 + n, 9), grid_hw=(7, 11 + n))
    before = gs.launch_counts()
    got = gs.gather_each(images, grids)
    assert gs.launch_counts() == before
    assert got.shape == grids.shape[:-1] + (3,)
    assert torch.equal(gs.gather_each_plain(images, grids), got)
    for out, x, g in zip(got, images, grids, strict=True):
        want = gs.grid_sample(x, g)
        assert torch.isfinite(want).all()
        assert torch.equal(out, want)


def test_gather_each_refuses_bad_tables():
    images, grids = _each_inputs(9, 0)
    with pytest.raises(ValueError, match="views"):
        gs.gather_each(images, grids)
    with pytest.raises(ValueError, match="grids"):
        gs.gather_each(images[:2], grids[:3])
    with pytest.raises(ValueError, match="images"):
        gs.gather_each(images[:2, ..., :1], grids[:2])


def test_nonfinite_grids_sample_like_the_kernel():
    """The plain gather's coordinates at non-finite and huge grids: ±inf and
    huge values clamp to the border, NaN becomes pixel 0 (K1's ``fmaxf``),
    and ``nearest_indices`` does the same; no index leaves the layer."""
    rng = np.random.default_rng(4)
    layer = torch.from_numpy(rng.random((5, 7, 3)).astype(np.float32))
    g = torch.tensor([[np.inf, -np.inf], [-np.inf, np.inf], [1e30, -1e30],
                      [np.nan, 0.25], [np.nan, np.nan], [1.0, -1.0]],
                     dtype=torch.float32)
    out = gs.gather_layers_plain([layer], g)
    want = torch.stack([layer[0, 6], layer[4, 0], layer[0, 6],
                        layer[2, 0] * 0.5 + layer[3, 0] * 0.5,
                        layer[0, 0], layer[0, 6]])
    torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)
    idx = gs.nearest_indices(g, 5, 7)
    assert idx.tolist() == [6, 28, 6, 2 * 7 + 0, 0, 6]
