"""The hand-written kernels against their plain versions on a CUDA card, at
edge shapes the main path does not reach (one mask, ragged pixel counts,
one to eight texture layers, all-zero cotangents).

Needs a Hopper card (the kernels are built for sm_90a); skips elsewhere.
On the card, without JAX installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q

Tolerances, relative to the plain output's largest value: sampling 1e-5
(float32, fused multiply-adds; 1e-6 in the bf16 mode, whose products of
bf16 values are exact and whose other operations are unfused), splat 1e-5
(float32 atomics order; 1e-4 over the level tables, whose 4x4 layer
sums ~500 contributions per texel in warp groups and atomics), Gram sums 1e-4 (float32 sums in another order;
exactly symmetric and equal from run to run on the card),
Gram gradient two bf16 ulps; the trunk's convs K5-K9 1e-2 (about two bf16
ulps: float32 sums in another order, then one rounding). Between the
kernels themselves, bit for bit (one wgmma core, one mainloop, K5's N
tile): K9 is K5 without bias and relu (one entry); K6 is maxpool2 of K5's
relu output, K7's pre-pool map is K5's relu output and its pooled map
K6's; K8 is K5 with the flipped kernel on ``pool_route`` of K5's relu
output. conv1_1's stem kernels against their plain versions (the im2col
product on the card; the input gradient's on the kernel's own y, so that
both apply one relu mask): one bf16 ulp of each element, or of 2^-9 of the
largest value where an element is smaller (float32 sums in another order
move a value near zero by more than its own bf16 spacing); bit for bit
where every sum is exact. The one-pass update (Adam, the clamp) against
its plain version's chain of PyTorch kernels on the card: p, m and v
within 1e-6 relative plus 1e-6 absolute (the same float32 operations in the
same order; only where PyTorch's kernels fuse a multiply-add may a rounding
differ); with the texture regularizer's gradient folded in (per-layer
coefficients, some 0), bit for bit. The regularizer's value (two launches:
per-block partials in double, one finishing block) against a float64 sum:
1e-6 relative, and the same bits from call to call.
"""

import pytest
import torch

from stylemesh_tpu_torch import kernels
from stylemesh_tpu_torch.models.losses import StyleTargets
from stylemesh_tpu_torch.models.pipeline import PipelineConfig, TexturePipeline
from stylemesh_tpu_torch.ops import adam_kernels
from stylemesh_tpu_torch.ops import conv_im2col, conv_kernels, gram_kernels
from stylemesh_tpu_torch.ops import head_kernels
from stylemesh_tpu_torch.ops import grid_sample as gs
from stylemesh_tpu_torch.ops.adam_kernels import ADAM_B1, ADAM_B2
from stylemesh_tpu_torch.ops.color import GATYS_MAX, GATYS_MIN

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels are built for sm_90a")
    return torch.device("cuda")


def _close(got, want, rel):
    got = got if isinstance(got, (list, tuple)) else [got]
    want = want if isinstance(want, (list, tuple)) else [want]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if w.numel() == 0:
            continue
        scale = w.float().abs().max().item()
        err = (g.float() - w.float()).abs().max().item()
        assert err <= rel * scale, (err, scale)


@pytest.mark.parametrize("n_layers,size", [(1, (5, 7)), (3, (64, 96)),
                                           (8, (512, 512))])
def test_gather_and_splat(cuda, n_layers, size):
    gen = torch.Generator(device=cuda).manual_seed(n_layers)
    grid = torch.rand((2, 13, 17, 2), generator=gen, device=cuda) * 2.4 - 1.2
    grid[:, :3, :3] = -1.0  # background pixels
    layers = [torch.randn((max(size[0] >> l, 1), max(size[1] >> l, 1), 3),
                          generator=gen, device=cuda) * 50
              for l in range(n_layers)]
    _close(gs.gather_levels(layers, [grid]),
           gs.gather_levels_plain(layers, [grid]), 1e-5)
    g = torch.randn((2, 13, 17, 3), generator=gen, device=cuda)
    g[:, 5:] = 0.0  # skipped pixels
    shapes = [tuple(l.shape[:2]) for l in layers]
    _close(gs.splat_levels([g], [grid], shapes),
           gs.splat_levels_plain([g], [grid], shapes), 1e-5)
    zero = gs.splat_levels([torch.zeros_like(g)], [grid], shapes)
    assert all(z.abs().max().item() == 0.0 for z in zero)


@pytest.mark.parametrize("n_layers,size", [(1, (5, 7)), (4, (257, 129)),
                                           (8, (512, 512))])
def test_gather_and_splat_bf16_mode(cuda, n_layers, size):
    """K1/K2's bf16 mode: the same roundings as the plain versions (gather
    within 1e-6, splat 1e-5 for the atomics' order), background pixels at
    (-1, -1) exact float32, and an odd pixel count."""
    gen = torch.Generator(device=cuda).manual_seed(10 + n_layers)
    grid = torch.rand((3, 19, 23, 2), generator=gen, device=cuda) * 2.4 - 1.2
    grid[:, :3, :4] = -1.0  # background pixels
    layers = [torch.randn((max(size[0] >> l, 1), max(size[1] >> l, 1), 3),
                          generator=gen, device=cuda) * 50
              for l in range(n_layers)]
    (got,) = gs.gather_levels(layers, [grid], "bf16")
    (want,) = gs.gather_levels_plain(layers, [grid], "bf16")
    _close(got, want, 1e-6)
    (exact,) = gs.gather_levels_plain(layers, [grid])
    assert torch.equal(got[:, :3, :4], exact[:, :3, :4])
    assert (got - exact).abs().max().item() > 0.0  # the mode rounds
    g = torch.randn((3, 19, 23, 3), generator=gen, device=cuda)
    g[:, 7:] = 0.0  # skipped pixels
    shapes = [tuple(l.shape[:2]) for l in layers]
    _close(gs.splat_levels([g], [grid], shapes, "bf16"),
           gs.splat_levels_plain([g], [grid], shapes, "bf16"), 1e-5)
    # only background pixels: their gradient lands on texel (0, 0) unrounded
    g_bg = torch.zeros_like(g)
    g_bg[:, :3, :4] = g[:, :3, :4]
    for d in gs.splat_levels([g_bg], [grid], shapes, "bf16"):
        torch.testing.assert_close(d[0, 0], g_bg.sum(dim=(0, 1, 2)),
                                   rtol=1e-6, atol=1e-5)
        assert d.abs().sum().item() == pytest.approx(
            d[0, 0].abs().sum().item())


@pytest.mark.parametrize("compute", ["f32", "bf16"])
@pytest.mark.parametrize("size,d,n_layers", [((48, 37), 3, 3),
                                             ((64, 129), 4, 4),
                                             ((16, 5), 16, 1),
                                             ((40, 23), 5, 2)])
def test_banded_gather_and_splat(cuda, compute, size, d, n_layers):
    """The banded K1/K2 at odd widths, D not a power of 2 and bands of one
    row: each band against its plain version (gather 1e-5, splat 1e-5 for
    the atomics' order); the bands' partials summed against the unbanded
    kernel, the bands' gradients stacked against the unbanded splat (1e-5);
    a grid of background pixels only reads and writes texel (0, 0) in
    band 0 alone."""
    gen = torch.Generator(device=cuda).manual_seed(sum(size) + d + n_layers)
    grid = torch.rand((2, 11, 19, 2), generator=gen, device=cuda) * 2.4 - 1.2
    grid[:, :2, :3] = -1.0
    layers = [torch.randn((size[0] >> l, size[1] >> l, 3), generator=gen,
                          device=cuda) * 50 for l in range(n_layers)]
    heights = [l.shape[0] for l in layers]
    g = torch.randn((2, 11, 19, 3), generator=gen, device=cuda)
    g[:, 6:] = 0.0
    bg_grid = torch.full_like(grid, -1.0)
    total, parts = 0, [[] for _ in layers]
    for b in range(d):
        row0s = [b * h // d for h in heights]
        bands = [l[r:r + h // d].clone()  # own, aligned allocations
                 for l, r, h in zip(layers, row0s, heights)]
        shapes = [tuple(x.shape[:2]) for x in bands]
        band = (row0s, heights)
        (got,) = gs.gather_levels(bands, [grid], compute, band)
        _close(got, gs.gather_levels_plain(bands, [grid], compute, band)[0],
               1e-5)
        total = total + got
        grads = gs.splat_levels([g], [grid], shapes, compute, band)
        _close(grads, gs.splat_levels_plain([g], [grid], shapes, compute,
                                            band), 1e-5)
        for acc, x in zip(parts, grads):
            acc.append(x)
        (out_bg,) = gs.gather_levels(bands, [bg_grid], compute, band)
        grads_bg = gs.splat_levels([g], [bg_grid], shapes, compute, band)
        if b == 0:
            assert torch.equal(out_bg[0, 0, 0], sum(x[0, 0] for x in bands))
            for x in grads_bg:
                assert x.abs().sum().item() == pytest.approx(
                    x[0, 0].abs().sum().item())
        else:
            assert out_bg.abs().max().item() == 0.0
            assert all(x.abs().max().item() == 0.0 for x in grads_bg)
    _close(total, gs.gather_levels(layers, [grid], compute)[0], 1e-5)
    full = gs.splat_levels([g], [grid], [tuple(l.shape[:2]) for l in layers],
                           compute)
    _close([torch.cat(p) for p in parts], full, 1e-5)


def test_sampling_autograd_matches_cpu(cuda):
    gen = torch.Generator().manual_seed(0)
    layers = [torch.randn((32 >> l, 48 >> l, 3), generator=gen) for l in range(3)]
    grid = torch.rand((2, 9, 11, 2), generator=gen) * 2 - 1
    ct = torch.randn((2, 9, 11, 3), generator=gen)
    results = []
    for device in ("cpu", cuda):
        ls = [l.to(device).requires_grad_() for l in layers]
        (out,) = gs.sample_levels(ls, [grid.to(device)])
        grads = torch.autograd.grad(out, ls, ct.to(device))
        results.append([out.cpu()] + [x.cpu() for x in grads])
    _close(results[1], results[0], 1e-5)


@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_gather_at_nonfinite_grids(cuda, compute):
    """K1 at warp grids far outside [-1, 1]: huge, +-inf, NaN (pixel 0, as
    the plain version's ``nan_to_num`` makes it) and exactly on the
    border, against its plain version."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    layer = torch.randn((23, 31, 3), generator=gen, device=cuda) * 50
    grid = torch.rand((2, 23, 31, 2), generator=gen, device=cuda) * 3 - 1.5
    special = torch.tensor([float("inf"), -float("inf"), float("nan"), 1e30,
                            -1e30, 1.0, -1.0, 1.0 + 1e-7], device=cuda)
    idx = torch.randint(0, special.numel(), grid.shape, generator=gen,
                        device=cuda)
    pick = torch.rand(grid.shape, generator=gen, device=cuda) < 0.3
    grid = torch.where(pick, special[idx], grid).contiguous()
    (out,) = gs.gather_levels([layer], [grid], compute)
    assert torch.isfinite(out).all()
    _close(out, gs.gather_levels_plain([layer.cpu()], [grid.cpu()],
                                       compute)[0].to(cuda), 1e-5)


def test_reproject_on_card_matches_cpu(cuda):
    """``geometry/project.py::reproject`` on the card (K1's per-view form
    for the colour and the three-channel mask warps, one launch each for
    the 4 views, views whose slices are not 16-byte aligned; no launch of
    the shared-layer form) against the same call on the CPU: the
    valid masks agree but for pixels at a threshold (float32 sums in
    another order), the warped colours to 1e-5."""
    from stylemesh_tpu_torch.geometry.project import reproject

    gen = torch.Generator().manual_seed(0)
    n, h, w = 4, 23, 31
    poses = torch.eye(4).repeat(n, 1, 1)
    for i in range(n):
        a = torch.tensor(0.12 * i - 0.1)
        poses[i, 0, 0], poses[i, 0, 2] = torch.cos(a), torch.sin(a)
        poses[i, 2, 0], poses[i, 2, 2] = -torch.sin(a), torch.cos(a)
        poses[i, :3, 3] = torch.tensor([0.25 * i, 0.02 * i, -0.1 * i])
    intr = torch.eye(4).repeat(n, 1, 1)
    intr[:, 0, 0], intr[:, 1, 1] = 28.0, 27.0
    intr[:, 0, 2], intr[:, 1, 2] = w / 2, h / 2
    depth = 3.0 + 0.05 * torch.randn((n, h, w, 1), generator=gen)
    depth[:, 6:15, 9:18] = 1.4
    depth[:, 18:20, 2:6] = 0.0
    color = torch.rand((n, h, w, 3), generator=gen)
    src, tar = [0, 1, 2, 3], [1, 0, 3, 1]
    args = [poses[src], poses[tar], intr[src], depth[src], depth[tar],
            color[tar], (depth[tar] > 0).float()]
    before = gs.launch_counts()
    warped, valid = reproject(*[a.to(cuda) for a in args])
    after = gs.launch_counts()
    assert after.pop("gather_each") - before.pop("gather_each") == 2
    assert after == before
    want_warped, want_valid = reproject(*args)
    assert 0.1 < want_valid.float().mean() < 0.9
    assert (valid.cpu() != want_valid).float().mean().item() < 1e-2
    both = (valid.cpu() & want_valid).expand(-1, -1, -1, 3)
    _close(warped.cpu()[both], want_warped[both], 1e-5)


def _level_inputs(cuda, seed):
    """Three levels: 2 views of 32x32 (every lane of a warp shares a texel
    of the 4x4 layer), one of zero pixels, and 19x23 (an odd pixel count);
    background pixels, both texel parities, cotangents zero on some rows;
    layers of odd widths and a 4x4 layer."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    grids, cots = [], []
    for v, h, w in ((2, 32, 32), (3, 0, 17), (1, 19, 23)):
        grid = torch.rand((v, h, w, 2), generator=gen, device=cuda) * 2.4 - 1.2
        grid[:, :2, :3] = -1.0
        g = torch.randn((v, h, w, 3), generator=gen, device=cuda)
        g[:, h // 2:h // 2 + 3] = 0.0
        grids.append(grid)
        cots.append(g)
    layers = [torch.randn(s + (3,), generator=gen, device=cuda) * 50
              for s in ((61, 97), (30, 48), (4, 4))]
    return layers, grids, cots


@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_levels_against_plain(cuda, compute):
    """K1/K2 over a level table (one launch each) against the plain
    versions per level and summed over the levels: gather 1e-5, splat 1e-4
    (the 4x4 layer takes ~500 contributions per texel, summed in warp
    groups and atomics in another order than ``index_add_``); all-zero
    cotangents leave the gradients zero."""
    layers, grids, cots = _level_inputs(cuda, 7)
    shapes = [tuple(l.shape[:2]) for l in layers]
    before = gs.launch_counts()
    outs = gs.gather_levels(layers, grids, compute)
    grads = gs.splat_levels(cots, grids, shapes, compute)
    key = "" if compute == "f32" else "_bf16"
    after = gs.launch_counts()
    assert after["gather" + key] == before["gather" + key] + 1
    assert after["splat" + key] == before["splat" + key] + 1
    for out, want in zip(outs, gs.gather_levels_plain(layers, grids, compute)):
        _close(out, want, 1e-5)
    _close(grads, gs.splat_levels_plain(cots, grids, shapes, compute), 1e-4)
    zero = gs.splat_levels([torch.zeros_like(g) for g in cots], grids, shapes,
                           compute)
    assert all(z.abs().max().item() == 0.0 for z in zero)


@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_banded_levels_against_plain(cuda, compute):
    """The banded K1/K2 over a level table, for the 2 bands of D = 2 (the
    4x4 layer's bands hold 2 rows): each band against its plain version
    (gather 1e-5, splat 1e-4), the partials summed against the unbanded
    K1 and the bands' gradients stacked against the unbanded K2."""
    layers, grids, cots = _level_inputs(cuda, 8)
    layers[0] = layers[0][:60].clone()
    heights = [l.shape[0] for l in layers]
    d = 2
    total, parts = None, [[] for _ in layers]
    for b in range(d):
        row0s = [b * h // d for h in heights]
        bands = [l[r:r + h // d].clone()
                 for l, r, h in zip(layers, row0s, heights)]
        shapes = [tuple(x.shape[:2]) for x in bands]
        band = (row0s, heights)
        outs = gs.gather_levels(bands, grids, compute, band)
        for out, want in zip(outs, gs.gather_levels_plain(
                bands, grids, compute, band)):
            _close(out, want, 1e-5)
        total = outs if total is None else [a + o for a, o in zip(total, outs)]
        grads = gs.splat_levels(cots, grids, shapes, compute, band)
        _close(grads, gs.splat_levels_plain(cots, grids, shapes, compute,
                                            band), 1e-4)
        for acc, x in zip(parts, grads):
            acc.append(x)
    for t, want in zip(total, gs.gather_levels(layers, grids, compute)):
        _close(t, want, 1e-5)
    _close([torch.cat(p) for p in parts],
           gs.splat_levels(cots, grids, [tuple(l.shape[:2]) for l in layers],
                           compute), 1e-4)


def test_sample_levels_one_launch_each_way(cuda):
    """The autograd pair over the levels: one K1 launch forward, one K2
    launch backward, a detached level left out, and the gradients those of
    the other levels' plain splats."""
    layers, grids, cots = _level_inputs(cuda, 9)
    leaves = [l.requires_grad_() for l in layers]
    before = gs.launch_counts()
    outs = gs.sample_levels(leaves, grids)
    loss = (outs[0] * cots[0]).sum() + (outs[2] * cots[2]).sum() \
        + outs[1].detach().sum()
    grads = torch.autograd.grad(loss, leaves)
    after = gs.launch_counts()
    assert after["gather"] == before["gather"] + 1
    assert after["splat"] == before["splat"] + 1
    _close(list(grads), gs.splat_levels_plain(
        [cots[0], cots[2]], [grids[0], grids[2]],
        [tuple(l.shape[:2]) for l in layers]), 1e-4)


def _guarded(cuda, shape, guard=4096, fill=12345.0):
    """A float32 buffer holding ``fill`` in ``guard`` elements before and
    after a zeroed view of ``shape`` (16-byte aligned); (buffer, view)."""
    n = 1
    for d in shape:
        n *= d
    buf = torch.full((n + 2 * guard,), fill, device=cuda)
    view = buf[guard:guard + n].view(shape)
    view.zero_()
    return buf, view


def _fills_intact(buf, view, guard=4096, fill=12345.0):
    torch.cuda.synchronize()
    assert (buf[:guard] == fill).all()
    assert (buf[guard + view.numel():] == fill).all()


@pytest.mark.parametrize("banded", [False, True])
def test_levels_write_only_their_outputs(cuda, banded):
    """Guards around every K1 output and every K2 gradient (or band) of a
    level table at ragged shapes stay untouched: the C entries called with
    tensors that lie inside larger buffers."""
    layers, grids, cots = _level_inputs(cuda, 10)
    heights = [l.shape[0] for l in layers]
    row0s = [h // 2 for h in heights] if banded else None
    if banded:
        layers = [l[r:].clone() for l, r in zip(layers, row0s)]
    band = (row0s, heights) if banded else None
    out_bufs = [_guarded(cuda, g.shape[:-1] + (3,)) for g in grids]
    grad_bufs = [_guarded(cuda, tuple(l.shape)) for l in layers]
    dev = grids[0].device
    kernels.launch("stylemesh_gather", dev,
                   *gs._level_table(grids, [v for _, v in out_bufs]),
                   len(grids), *gs._layer_table(layers),
                   *gs._band_table(band), len(layers), 0)
    grads = [v for _, v in grad_bufs]
    kernels.launch("stylemesh_splat", dev,
                   *gs._level_table(grids, cots), len(grids),
                   *gs._layer_table(grads),
                   *gs._band_table(band), len(grads), 0)
    for buf, view in out_bufs + grad_bufs:
        _fills_intact(buf, view)
    want = gs.splat_levels_plain(cots, grids,
                                 [tuple(l.shape[:2]) for l in layers],
                                 band=band)
    outs_want = gs.gather_levels_plain(layers, grids, band=band)
    _close(grads, want, 1e-4)
    for (_, view), w in zip(out_bufs, outs_want):
        _close(view, w, 1e-5)


def _warp_grids(gen, cuda, shape):
    """Grids of ``shape`` with 30% of the entries ±inf, NaN, huge or exactly
    on the border, as the eval's warps give them."""
    specials = torch.tensor([float("inf"), -float("inf"), float("nan"), 1e30,
                             -1e30, 1.0, -1.0], device=cuda)
    grid = torch.rand(shape, generator=gen, device=cuda) * 3.0 - 1.5
    pick = torch.rand(shape, generator=gen, device=cuda) < 0.3
    idx = torch.randint(0, len(specials), shape, generator=gen, device=cuda)
    return torch.where(pick, specials[idx], grid).contiguous()


def test_gather_each_writes_only_its_outputs(cuda):
    """The per-view form's C entry over 8 views of ragged image sizes (both
    texel parities) and ragged pixel counts (view 2 of zero pixels), its
    outputs inside larger buffers: the guards stay untouched, and each
    output is its view's plain sample (1e-5)."""
    gen = torch.Generator(device=cuda).manual_seed(30)
    images = [torch.randn((5 + 7 * k, 9 + 5 * k, 3), generator=gen,
                          device=cuda) * 50 for k in range(8)]
    grids = [_warp_grids(gen, cuda, (1, 0 if k == 2 else 11 + 3 * k, 13 + k,
                                     2)) for k in range(8)]
    bufs = [_guarded(cuda, g.shape[:-1] + (3,)) for g in grids]
    kernels.launch("stylemesh_gather_each", images[0].device,
                   *gs._level_table(grids, [v for _, v in bufs]), 8,
                   *gs._layer_table(images))
    for (buf, view), x, g in zip(bufs, images, grids, strict=True):
        _fills_intact(buf, view)
        _close(view, gs.gather_each_plain(x[None], g[None])[0], 1e-5)


# (views, image H x W, grid H x W): odd and even float counts per view
@pytest.mark.parametrize("n,hw,grid_hw", [(1, (5, 7), (3, 5)),
                                          (2, (16, 24), (9, 13)),
                                          (3, (23, 31), (23, 31)),
                                          (4, (40, 30), (12, 10)),
                                          (5, (7, 9), (33, 17)),
                                          (6, (64, 96), (20, 30)),
                                          (7, (31, 17), (5, 5)),
                                          (8, (256, 341), (256, 341))])
def test_gather_each_against_shared_form(cuda, n, hw, grid_hw):
    """K1's per-view form over n views in one launch: within 1e-5 of its
    plain version and equal bit for bit to the shared-layer form launched
    once per view on that view's image (the warps' former route)."""
    gen = torch.Generator(device=cuda).manual_seed(n)
    images = torch.randn((n, *hw, 3), generator=gen, device=cuda) * 50
    grids = _warp_grids(gen, cuda, (n, *grid_hw, 2))
    before = gs.launch_counts()
    out = gs.gather_each(images, grids)
    after = gs.launch_counts()
    assert after.pop("gather_each") == before.pop("gather_each") + 1
    assert after == before
    assert out.shape == grids.shape[:-1] + (3,) and out.is_contiguous()
    assert torch.isfinite(out).all()
    _close(out, gs.gather_each_plain(images, grids), 1e-5)
    for k in range(n):
        shared = gs.gather_levels([images[k].clone()], [grids[k].clone()])[0]
        assert torch.equal(out[k], shared)


def test_shared_form_sums_per_layer_samples_in_order(cuda):
    """The shared-layer form over 1..8 layers at one grid is bit for bit the
    float32 sum in layer order of the per-view form's samples of each
    layer at that grid: both forms run one sampling arithmetic, and the
    shared form's sum is unchanged."""
    gen = torch.Generator(device=cuda).manual_seed(40)
    layers = torch.randn((8, 37, 53, 3), generator=gen, device=cuda) * 50
    grid = _warp_grids(gen, cuda, (2, 14, 19, 2))
    for n in range(1, 9):
        shared = gs.gather_levels([l.clone() for l in layers[:n]], [grid])[0]
        per = gs.gather_each(layers[:n], grid.flatten(0, 2)[None].expand(
            n, -1, -1).contiguous())
        want = per[0]
        for p in per[1:]:
            want = want + p
        assert torch.equal(shared, want.view(grid.shape[:-1] + (3,)))


def test_gather_each_refuses_bad_inputs(cuda):
    gen = torch.Generator(device=cuda).manual_seed(50)
    images = torch.randn((9, 6, 8, 3), generator=gen, device=cuda)
    grids = _warp_grids(gen, cuda, (9, 4, 4, 2))
    with pytest.raises(ValueError, match="views"):
        gs.gather_each(images, grids)
    with pytest.raises(ValueError, match="grids"):
        gs.gather_each(images[:2], grids[:3])
    with pytest.raises(TypeError):
        gs.gather_each(images[:1].double(), grids[:1])
    with pytest.raises(ValueError, match="images"):
        gs.gather_each(images[:1, ..., :1].contiguous(), grids[:1])
    with pytest.raises(ValueError, match="contiguous"):
        gs.gather_each(images[:2].transpose(1, 2), grids[:2])


# C = 192 and 320 take 64-wide column groups, as C = 64 does
@pytest.mark.parametrize("c,k,p", [(64, 1, 1000), (128, 2, 4097),
                                   (256, 2, 33), (64, 2, 100003),
                                   (512, 1, 336), (512, 2, 336),
                                   (512, 1, 3185), (512, 2, 3185),
                                   (512, 1, 12740), (512, 2, 12740),
                                   (192, 1, 3000), (192, 2, 1000),
                                   (320, 2, 777)])
def test_masked_gram_sums_and_grad(cuda, c, k, p):
    gen = torch.Generator(device=cuda).manual_seed(c + k + p)
    f = torch.randn((3, p, c), generator=gen, device=cuda).to(torch.bfloat16)
    m = (torch.rand((3, k, p), generator=gen, device=cuda) < 0.5).to(torch.bfloat16)
    m[1] = 0.0  # empty masks: zero Grams, zero gradient rows
    m[0, :, 64:320] = 0.0  # every mask zero over whole pixel tiles
    m[2, 0, :256] = 0.0    # one mask zero where the other is not
    sums = gram_kernels.masked_gram_sums(f, m)
    _close(sums, gram_kernels.masked_gram_sums_plain(f, m), 1e-4)
    assert not sums[1].any()
    assert torch.equal(sums, sums.transpose(-1, -2))  # exactly symmetric
    assert torch.equal(sums, gram_kernels.masked_gram_sums(f, m))  # deterministic
    dg = torch.randn((3, k, c, c), generator=gen, device=cuda)
    s = dg + dg.transpose(-1, -2)
    df = gram_kernels.masked_gram_sums_grad(f, m, s)
    _close(df, gram_kernels.masked_gram_sums_grad_plain(f, m, s), 2 ** -7)
    assert not df[1].any()
    assert not df[0, 64:320].any()


def test_wrappers_refuse_bad_inputs(cuda):
    grid = torch.zeros((1, 4, 4, 2), device=cuda)
    with pytest.raises(TypeError):
        gs.gather_levels([torch.zeros((8, 8, 3), device=cuda,
                                      dtype=torch.float64)], [grid])
    with pytest.raises(ValueError):
        gs.gather_levels([torch.zeros((8, 8, 3), device=cuda)] * 9, [grid])
    with pytest.raises(ValueError, match="levels"):
        gs.gather_levels([torch.zeros((8, 8, 3), device=cuda)], [grid] * 9)
    f = torch.zeros((1, 16, 48), dtype=torch.bfloat16, device=cuda)
    m = torch.zeros((1, 1, 16), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="multiple of 64"):
        gram_kernels.masked_gram_sums(f, m)


TRUNK_PAIRS = [(64, 64), (64, 128), (128, 64), (128, 128), (128, 256),
               (256, 128), (256, 256), (256, 512), (512, 256), (512, 512)]
EDGE_SHAPES = [(1, 1, 1), (1, 2, 3), (3, 1, 17), (2, 3, 2), (1, 17, 33),
               (2, 20, 37)]


def _conv_inputs(cuda, v, h, w, cin, cout, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed + cin + cout + h + w)
    x = torch.randn((v, h, w, cin), generator=gen, device=cuda).to(torch.bfloat16)
    weight = torch.randn((cout, cin, 3, 3), generator=gen, device=cuda)
    weight = weight * (2.0 / (9 * cin)) ** 0.5
    b = torch.randn((cout,), generator=gen, device=cuda) * 0.05
    return (x, conv_kernels.w9_from_oihw(weight),
            conv_kernels.flipped_w9_from_oihw(weight), b)


@pytest.mark.parametrize("cin,cout", TRUNK_PAIRS)
def test_conv3x3_trunk_pairs(cuda, cin, cout):
    x, w9, _, b = _conv_inputs(cuda, 2, 23, 29, cin, cout)
    for relu in (True, False):
        _close(conv_kernels.conv3x3(x, w9, b, relu),
               conv_kernels.conv3x3_plain(x, w9, b, relu), 1e-2)
    _close(conv_kernels.conv3x3(x, w9), conv_kernels.conv3x3_plain(x, w9), 1e-2)


@pytest.mark.parametrize("shape", EDGE_SHAPES)
def test_conv3x3_edge_shapes(cuda, shape):
    x, w9, _, b = _conv_inputs(cuda, *shape, 128, 64)
    _close(conv_kernels.conv3x3(x, w9, b, True),
           conv_kernels.conv3x3_plain(x, w9, b, True), 1e-2)


# the edge shapes, odd H and W at V = 3, and the largest bench level
POOL_SHAPES = EDGE_SHAPES + [(3, 33, 57), (1, 784, 1045)]


def _close_but(got, want, rel, share):
    """As _close, but up to ``share`` of the elements may lie beyond the
    tolerance (a pool tie broken the other way by a sum rounded apart)."""
    scale = want.float().abs().max().item()
    beyond = ((got.float() - want.float()).abs() > rel * scale).float()
    assert beyond.mean().item() <= share


@pytest.mark.parametrize("c", [64, 128])
@pytest.mark.parametrize("shape", POOL_SHAPES)
def test_conv_relu_pool_is_pool_of_k5(cuda, c, shape):
    """K6 equals maxpool2 of K5's relu output, K7's pre-pool map equals
    K5's relu output and its pooled map K6's, bit for bit (one core, K5's
    N tile, only the pixel box differs); both within 1e-2 of the plain
    version."""
    x, w9, _, b = _conv_inputs(cuda, *shape, c, c)
    y = conv_kernels.conv3x3(x, w9, b, True)
    pooled = head_kernels.conv_relu_pool(x, w9, b)
    dual, pre = head_kernels.conv_relu_pool(x, w9, b, with_pre=True)
    assert torch.equal(pooled, head_kernels.maxpool2(y))
    assert torch.equal(pre, y)
    assert torch.equal(dual, pooled)
    _close(pooled, head_kernels.conv_relu_pool_plain(x, w9, b), 1e-2)


@pytest.mark.parametrize("shape", POOL_SHAPES + [(4, 33, 57)])
def test_conv_relu_pool_bwd(cuda, shape):
    """K8 equals the backward composed from K5's relu output (the same
    routing) and K5 with the flipped kernel, bit for bit: it recomputes
    the relu output and runs the transposed conv in K5's sum order. Against
    its plain version within 1e-2, where up to 2e-3 of the elements may
    differ more (a tie in a pool window broken the other way by a sum
    rounded apart)."""
    x, w9, w9t, b = _conv_inputs(cuda, *shape, 64, 64)
    v, h, w = shape
    gen = torch.Generator(device=cuda).manual_seed(h * w)
    g = torch.randn((v, h // 2, w // 2, 64), generator=gen,
                    device=cuda).to(torch.bfloat16)
    got = head_kernels.conv_relu_pool_bwd(x, w9, w9t, b, g)
    y = conv_kernels.conv3x3(x, w9, b, True)
    composed = conv_kernels.conv3x3(head_kernels.pool_route(y, g), w9t)
    assert torch.equal(got, composed)
    if h >= 2 and w >= 2:
        _close_but(got, head_kernels.conv_relu_pool_bwd_plain(x, w9, w9t, b, g),
                   1e-2, 2e-3)


@pytest.mark.parametrize("shape", [(2, 30, 70), (3, 25, 33)])
def test_conv_relu_pool_bwd_ties(cuda, shape):
    """Many pool windows with equal maxima: x in {0, 1}, the weights in
    {0, 1/2}, the bias a multiple of 1/2 and g in {-1, 1, 2}, so every sum
    is exact in float32 in any order. K8 must route each window to its
    first maximum in raster order as the plain version does: equal bit for
    bit, with ties in over a tenth of the live windows."""
    v, h, w = shape
    gen = torch.Generator(device=cuda).manual_seed(h + w)
    x = (torch.rand((v, h, w, 64), generator=gen, device=cuda) < 0.3)
    x = x.to(torch.bfloat16)
    weight = (torch.rand((64, 64, 3, 3), generator=gen, device=cuda) < 0.1)
    weight = weight.float() / 2
    b = torch.randint(-12, 2, (64,), generator=gen, device=cuda).float() / 2
    w9 = conv_kernels.w9_from_oihw(weight)
    w9t = conv_kernels.flipped_w9_from_oihw(weight)
    g = torch.tensor([-1.0, 1.0, 2.0], device=cuda)[torch.randint(
        0, 3, (v, h // 2, w // 2, 64), generator=gen, device=cuda)]
    g = g.to(torch.bfloat16)
    y = conv_kernels.conv3x3(x, w9, b, True)
    assert torch.equal(y, conv_kernels.conv3x3_plain(x, w9, b, True))
    q = y[:, :h // 2 * 2, :w // 2 * 2].float().reshape(
        v, h // 2, 2, w // 2, 2, 64)
    top = q.amax(dim=(2, 4), keepdim=True)
    live = top > 0
    ties = ((q == top) & live).sum(dim=(2, 4)) >= 2
    assert ties.sum().item() > 0.1 * live.sum().item()
    got = head_kernels.conv_relu_pool_bwd(x, w9, w9t, b, g)
    assert torch.equal(got, head_kernels.conv_relu_pool_bwd_plain(
        x, w9, w9t, b, g))


def _canary(cuda, shape, guard=4096):
    """A NaN-filled bf16 buffer with ``guard`` elements before and after a
    view of ``shape``; returns (buffer, view)."""
    n = 1
    for d in shape:
        n *= d
    buf = torch.full((n + 2 * guard,), float("nan"), dtype=torch.bfloat16,
                     device=cuda)
    return buf, buf[guard:guard + n].view(shape)


def _guards_intact(buf, view, guard=4096):
    torch.cuda.synchronize()
    assert torch.isnan(buf[:guard]).all()
    assert torch.isnan(buf[guard + view.numel():]).all()
    assert torch.isfinite(view).all()


@pytest.mark.parametrize("shape", [(1, 3, 31), (2, 9, 65), (1, 17, 261),
                                   (3, 2, 130)])
@pytest.mark.parametrize("c", [64, 128])
def test_conv_relu_pool_writes_only_its_output(cuda, shape, c):
    """A canary around K6's pooled map and K7's two outputs: every element
    written (finite, equal to the wrapper's), nothing outside, so no window
    past the floor of H / 2 or W / 2 and no ragged tile stores out of
    bounds."""
    v, h, w = shape
    x, w9, _, b = _conv_inputs(cuda, v, h, w, c, c, seed=3)
    want_pooled, want_pre = head_kernels.conv_relu_pool(x, w9, b, with_pre=True)
    pbuf, pooled = _canary(cuda, (v, h // 2, w // 2, c))
    head_kernels.launch_conv_relu_pool(x, w9, b, None, pooled)
    _guards_intact(pbuf, pooled)
    assert torch.equal(pooled, want_pooled)
    pbuf, pooled = _canary(cuda, (v, h // 2, w // 2, c))
    ybuf, pre = _canary(cuda, (v, h, w, c))
    head_kernels.launch_conv_relu_pool(x, w9, b, pre, pooled)
    _guards_intact(pbuf, pooled)
    _guards_intact(ybuf, pre)
    assert torch.equal(pooled, want_pooled) and torch.equal(pre, want_pre)


@pytest.mark.parametrize("shape", [(1, 1, 31), (2, 9, 65), (1, 25, 33),
                                   (3, 2, 130), (1, 49, 97)])
def test_conv_relu_pool_bwd_writes_only_its_output(cuda, shape):
    """A canary around K8's dx: every element written, nothing outside (the
    dx tile's stores are clipped at the map's edge)."""
    v, h, w = shape
    x, w9, w9t, b = _conv_inputs(cuda, v, h, w, 64, 64, seed=4)
    g = torch.randn((v, h // 2, w // 2, 64), device=cuda).to(torch.bfloat16)
    buf, dx = _canary(cuda, (v, h, w, 64))
    head_kernels.launch_conv_relu_pool_bwd(x, w9, w9t, b, g, dx)
    _guards_intact(buf, dx)
    assert torch.equal(dx, head_kernels.conv_relu_pool_bwd(x, w9, w9t, b, g))


def test_block_tails_refuse_bad_tiles(cuda):
    """The block-tail entries take K5's tile for Cout with a box 8, 16 or 32
    pixels wide (K6/K7) and K8's own dx tile; they refuse any other."""
    x, w9, w9t, b = _conv_inputs(cuda, 1, 8, 8, 64, 128)
    y = torch.empty((1, 8, 8, 128), dtype=torch.bfloat16, device=cuda)
    p = torch.empty((1, 4, 4, 128), dtype=torch.bfloat16, device=cuda)
    for box_h, box_w, bn in ((4, 64, 128), (8, 16, 128), (16, 16, 96),
                             (8, 32, 256), (64, 4, 128)):
        with pytest.raises(RuntimeError, match="failed"):
            kernels.launch("stylemesh_conv_relu_pool", x.device, x.data_ptr(),
                           w9.data_ptr(), b.data_ptr(), y.data_ptr(),
                           p.data_ptr(), 1, 8, 8, 64, 128, 1, box_h, box_w, bn)
    x, w9, w9t, b = _conv_inputs(cuda, 1, 8, 8, 64, 64)
    g = torch.zeros((1, 4, 4, 64), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(RuntimeError, match="failed"):
        head_kernels.launch_conv_relu_pool_bwd(x, w9, w9t, b, g,
                                               torch.empty_like(x), (16, 32))


def test_conv_wrappers_refuse_bad_inputs(cuda):
    x, w9, w9t, b = _conv_inputs(cuda, 1, 8, 8, 128, 128)
    with pytest.raises(ValueError, match="multiple"):
        conv_kernels.conv3x3(x[..., :48].contiguous(), w9[:9 * 48].contiguous())
    with pytest.raises(ValueError):
        conv_kernels.conv3x3(x, w9[:9 * 64].contiguous())
    with pytest.raises(TypeError):
        conv_kernels.conv3x3(x.float(), w9)
    g = torch.zeros((1, 4, 4, 128), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="64"):
        head_kernels.conv_relu_pool_bwd(x, w9, w9t, b, g)
    x, w9, _, b = _conv_inputs(cuda, 1, 8, 8, 64, 256)
    with pytest.raises(ValueError, match="Cout"):
        head_kernels.conv_relu_pool(x, w9, b)


@pytest.mark.parametrize("cin,cout", [(64, 64), (64, 128), (128, 256),
                                      (256, 512), (512, 512), (128, 64)])
@pytest.mark.parametrize("shape", EDGE_SHAPES)
def test_conv3x3_mxu(cuda, cin, cout, shape):
    """K9 (K5's entry without bias and relu, its own launch count) at sizes
    1-3 and odd widths: bit for bit K5 with ``bias=None, relu=False``, within
    1e-2 of its plain version; ``_ConvFrozen``'s input gradient is K9 with
    the flipped kernel and the weights get none."""
    x, w9, w9t, _ = _conv_inputs(cuda, *shape, cin, cout)
    k5_before = conv_kernels.conv3x3.launches
    before = conv_kernels.conv3x3_mxu.launches
    y = conv_kernels.conv3x3_mxu(x, w9)
    assert conv_kernels.conv3x3_mxu.launches == before + 1
    assert torch.equal(y, conv_kernels.conv3x3(x, w9))
    assert conv_kernels.conv3x3.launches == k5_before + 1
    _close(y, conv_kernels.conv3x3_mxu_plain(x, w9), 1e-2)
    xt = x.clone().requires_grad_()
    out = conv_kernels._ConvFrozen.apply(xt, w9, w9t)
    g = torch.randn(out.shape, device=cuda).to(torch.bfloat16)
    (dx,) = torch.autograd.grad(out, [xt], g)
    assert torch.equal(out, y)
    assert torch.equal(dx, conv_kernels.conv3x3_mxu(g, w9t))
    _close(dx, conv_kernels.conv3x3_mxu_plain(g, w9t), 1e-2)


# widths on either side of the pixel boxes' edges (8 to 128 columns) and of
# the widest bench map (261); one row; several images
TILING_SHAPES = [(1, 5, 31), (2, 3, 33), (1, 9, 65), (1, 4, 130), (2, 1, 129),
                 (1, 1, 261), (1, 7, 261), (3, 2, 8), (1, 17, 7)]


@pytest.mark.parametrize("shape", TILING_SHAPES)
@pytest.mark.parametrize("cin,cout", [(64, 128), (256, 64), (128, 256),
                                      (512, 512)])
def test_conv3x3_tiling(cuda, shape, cin, cout):
    """K5 across the box and N-tile choices: forward with bias and relu,
    and as an input gradient (no bias, relu off) down to Cout = 64 and up
    to 512, within 1e-2 of the plain version."""
    x, w9, _, b = _conv_inputs(cuda, *shape, cin, cout, seed=1)
    _close(conv_kernels.conv3x3(x, w9, b, True),
           conv_kernels.conv3x3_plain(x, w9, b, True), 1e-2)
    _close(conv_kernels.conv3x3(x, w9), conv_kernels.conv3x3_plain(x, w9), 1e-2)


@pytest.mark.parametrize("shape", [(1, 1, 31), (2, 9, 65), (1, 17, 261),
                                   (3, 2, 130)])
@pytest.mark.parametrize("cout", [64, 512])
def test_conv3x3_writes_only_its_output(cuda, shape, cout):
    """A canary: the output lies inside a NaN-filled buffer with a guard
    before and after it; the kernel writes every output element (all
    finite, equal to K5's) and nothing outside, so a ragged tile stores no
    pixel out of bounds."""
    v, h, w = shape
    x, w9, _, b = _conv_inputs(cuda, v, h, w, 128, cout, seed=2)
    guard = 4096
    n = v * h * w * cout
    buf = torch.full((n + 2 * guard,), float("nan"), dtype=torch.bfloat16,
                     device=cuda)
    y = buf[guard:guard + n].view(v, h, w, cout)
    box_h, box_w = conv_kernels.pixel_box(h, w, conv_kernels.tile_pixels(cout))
    kernels.launch("stylemesh_conv3x3", x.device, x.data_ptr(), w9.data_ptr(),
                   b.data_ptr(), y.data_ptr(), v, h, w, 128, cout, 1, box_h,
                   box_w, conv_kernels.block_n(cout))
    torch.cuda.synchronize()
    assert torch.isnan(buf[:guard]).all() and torch.isnan(buf[guard + n:]).all()
    assert torch.isfinite(y).all()
    assert torch.equal(y, conv_kernels.conv3x3(x, w9, b, True))


def test_conv3x3_refuses_bad_tiles(cuda):
    """The C entry takes tiles of 128 pixels x 256 channels or 256 pixels x
    64 or 128 channels, with a box width a multiple of 8 and an N tile that
    divides Cout; it refuses any other."""
    x, w9, _, b = _conv_inputs(cuda, 1, 8, 8, 64, 128)
    y = torch.empty((1, 8, 8, 128), dtype=torch.bfloat16, device=cuda)
    for box_h, box_w, bn in ((4, 16, 128), (8, 16, 128), (16, 16, 96),
                             (8, 16, 256), (64, 4, 128)):
        with pytest.raises(RuntimeError, match="failed"):
            kernels.launch("stylemesh_conv3x3", x.device, x.data_ptr(),
                           w9.data_ptr(), b.data_ptr(), y.data_ptr(), 1, 8, 8,
                           64, 128, 1, box_h, box_w, bn)


# ragged maps (one pixel, odd H and W, widths off the pixel boxes) and,
# with V = 4, maps of more tiles than SMs, so that a persistent block runs
# the epilogue operands of one tile beside the next tile's K steps
MASKED_SHAPES = [(1, 1, 1), (2, 3, 2), (1, 17, 33), (2, 20, 37), (3, 9, 65),
                 (4, 64, 85), (4, 98, 130)]


def _relu_output(cuda, shape, seed):
    """A bf16 relu output: about half +0, the rest positive."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return torch.relu(torch.randn(shape, generator=gen, device=cuda)).to(
        torch.bfloat16)


@pytest.mark.parametrize("shape", MASKED_SHAPES)
@pytest.mark.parametrize("cin,cout", [(64, 64), (128, 64), (256, 128),
                                      (512, 256), (512, 512)])
def test_conv3x3_masked_is_the_chain(cuda, cin, cout, shape):
    """K5's input gradient that finishes its input's cotangent (N tiles of
    64, 128 and 256 channels) equals the passes it replaces bit for bit:
    K5, then the bf16 sum with the tap's cotangent t, then
    ``torch.where(m > 0, ., 0)``; without t, K5 then the mask. Counted as
    a K5 launch."""
    # g [.., cin] and a kernel [9 cin, cout], as the input gradient of a
    # conv of cout -> cin channels takes them
    g, w9t, _, _ = _conv_inputs(cuda, *shape, cin, cout, seed=5)
    m = _relu_output(cuda, shape + (cout,), seed=cin + cout)
    gen = torch.Generator(device=cuda).manual_seed(cin * cout)
    t = torch.randn(shape + (cout,), generator=gen, device=cuda).to(torch.bfloat16)
    k5 = conv_kernels.conv3x3(g, w9t)
    zero = torch.zeros((), dtype=torch.bfloat16, device=cuda)
    before = conv_kernels.conv3x3.launches
    assert torch.equal(conv_kernels.conv3x3_masked(g, w9t, m),
                       torch.where(m > 0, k5, zero))
    assert torch.equal(conv_kernels.conv3x3_masked(g, w9t, m, t),
                       torch.where(m > 0, k5 + t, zero))
    assert conv_kernels.conv3x3.launches == before + 2


@pytest.mark.parametrize("shape", [(1, 3, 31), (2, 9, 65), (1, 17, 261)])
@pytest.mark.parametrize("cout", [64, 512])
def test_conv3x3_masked_writes_only_its_output(cuda, shape, cout):
    """A canary around the finishing input gradient's output: every
    element written, nothing outside (the stores are clipped at the map's
    edge; m and t are read in the same boxes)."""
    v, h, w = shape
    g, w9t, _, _ = _conv_inputs(cuda, v, h, w, 128, cout, seed=6)
    m = _relu_output(cuda, (v, h, w, cout), seed=7)
    t = torch.randn((v, h, w, cout), device=cuda).to(torch.bfloat16)
    buf, y = _canary(cuda, (v, h, w, cout))
    box_h, box_w = conv_kernels.pixel_box(h, w, conv_kernels.tile_pixels(cout))
    kernels.launch("stylemesh_conv3x3_masked", g.device, g.data_ptr(),
                   w9t.data_ptr(), m.data_ptr(), t.data_ptr(), y.data_ptr(),
                   v, h, w, 128, cout, box_h, box_w, conv_kernels.block_n(cout))
    _guards_intact(buf, y)
    assert torch.equal(y, conv_kernels.conv3x3_masked(g, w9t, m, t))


@pytest.mark.parametrize("shape", POOL_SHAPES + [(4, 33, 57)])
def test_conv_relu_pool_bwd_adds_tap(cuda, shape):
    """K8 with the tap's cotangent t equals K8, then the bf16 sum with t,
    bit for bit."""
    x, w9, w9t, b = _conv_inputs(cuda, *shape, 64, 64, seed=8)
    v, h, w = shape
    gen = torch.Generator(device=cuda).manual_seed(v + h + w)
    g = torch.randn((v, h // 2, w // 2, 64), generator=gen,
                    device=cuda).to(torch.bfloat16)
    t = torch.randn(x.shape, generator=gen, device=cuda).to(torch.bfloat16)
    got = head_kernels.conv_relu_pool_bwd(x, w9, w9t, b, g, t)
    assert torch.equal(got, head_kernels.conv_relu_pool_bwd(x, w9, w9t, b, g) + t)
    buf, dx = _canary(cuda, x.shape)
    head_kernels.launch_conv_relu_pool_bwd(x, w9, w9t, b, g, dx, tap=t)
    _guards_intact(buf, dx)
    assert torch.equal(dx, got)


@pytest.mark.parametrize("keys", [["r11", "r21", "r31", "r41", "r51", "r42"],
                                  ["r12", "r22", "r31", "r42"]])
def test_trunk_input_gradient_as_per_layer(cuda, keys, monkeypatch):
    """The bf16 trunk on the card, whose input gradients finish their
    input's cotangent, against the same trunk with that turned off (every
    conv masks its own cotangent, autograd sums a tap's with the next
    conv's): activations and input gradient equal bit for bit."""
    from stylemesh_tpu_torch.models import vgg

    params = vgg.init_vgg_params(rng=3, he=True, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(11)
    x = ((torch.rand((4, 64, 85, 3), generator=gen, device=cuda) - 0.45)
         * 255.0).to(torch.bfloat16)

    def run():
        xin = x.clone().requires_grad_()
        out = vgg.vgg_features(params, xin, keys, compute_dtype=torch.bfloat16,
                               precision="default")
        cts = [torch.randn(out[k].shape, generator=torch.Generator(
            device=cuda).manual_seed(i), device=cuda).to(torch.bfloat16)
               for i, k in enumerate(keys)]
        (grad,) = torch.autograd.grad([out[k] for k in keys], [xin], cts)
        return out, grad

    out, grad = run()
    monkeypatch.setattr(vgg, "_finishes", lambda routes, j: False)
    want_out, want_grad = run()
    for k in keys:
        assert torch.equal(out[k], want_out[k]), k
    assert grad.abs().max().item() > 0
    assert torch.equal(grad, want_grad)


# conv1_1's stem: H and W of 1, 2, 7 and 33, widths off the kernels' 64-
# and 32-column tiles, V of 1 and 4, and the bench step's four levels
STEM_SHAPES = [(1, 1, 1), (4, 2, 2), (1, 7, 7), (4, 33, 33), (1, 1, 33),
               (4, 33, 1), (1, 2, 65), (4, 9, 97), (1, 17, 130)]
STEM_BENCH_SHAPES = [(4, 256, 341), (4, 432, 576), (4, 608, 810),
                     (4, 784, 1045)]


def _bf16_ulp(v):
    """The spacing of bf16 numbers at ``|v|`` (float32; 2^(e - 7) for |v|
    in [2^e, 2^(e + 1)))."""
    e = torch.floor(torch.log2(v.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def _within_one_ulp(got, want):
    """Each element within one bf16 ulp of the plain version's, the ulp of
    the larger of the two or of 2^-9 of the largest plain value."""
    assert got.shape == want.shape and got.dtype == want.dtype
    g, w = got.float(), want.float()
    floor = _bf16_ulp(w.abs().max()) * 2.0 ** -9
    ulp = torch.maximum(_bf16_ulp(torch.maximum(g.abs(), w.abs())), floor)
    worst = ((g - w).abs() / ulp).max().item()
    assert worst <= 1.0, worst


def _stem_inputs(cuda, v, h, w, seed=0):
    """x at the Gatys pixel scale, conv1_1's He-scaled w9 and bias."""
    gen = torch.Generator(device=cuda).manual_seed(seed + v + h + w)
    x = (torch.randn((v, h, w, 3), generator=gen, device=cuda) * 50)
    weight = torch.randn((64, 3, 3, 3), generator=gen, device=cuda)
    b = torch.randn((64,), generator=gen, device=cuda) * 0.05
    g = torch.randn((v, h, w, 64), generator=gen, device=cuda)
    return (x.to(torch.bfloat16), conv_kernels.w9_from_oihw(
        weight * (2.0 / 27) ** 0.5), b, g.to(torch.bfloat16))


def _stem_plain(x, w9, b, g, y, relu=True):
    """The plain versions' y, and input gradient on the given ``y``."""
    return (conv_im2col.stem_forward_plain(x, w9, b, relu),
            conv_im2col.stem_backward_plain(g, y, w9, relu))


def _stem_kernels(x, w9, b, g, relu=True):
    """conv3x3_im2col's y and input gradient: one launch each way, the
    gradient that of the input-gradient kernel on y."""
    fwd, bwd = (conv_im2col.stem_forward.launches,
                conv_im2col.stem_backward.launches)
    xl = x.clone().requires_grad_()
    y = conv_im2col.conv3x3_im2col(xl, w9, b, relu)
    (dx,) = torch.autograd.grad(y, [xl], g)
    assert conv_im2col.stem_forward.launches == fwd + 1
    assert conv_im2col.stem_backward.launches == bwd + 1
    y = y.detach()
    assert torch.equal(dx, conv_im2col.stem_backward(g, y, w9, relu))
    return y, dx


@pytest.mark.parametrize("shape", STEM_SHAPES + STEM_BENCH_SHAPES)
def test_stem_against_plain(cuda, shape):
    """The forward (bias, relu) and the masked input gradient within one
    bf16 ulp of the plain version."""
    x, w9, b, g = _stem_inputs(cuda, *shape)
    y, dx = _stem_kernels(x, w9, b, g)
    want_y, want_dx = _stem_plain(x, w9, b, g, y)
    _within_one_ulp(y, want_y)
    _within_one_ulp(dx, want_dx)


@pytest.mark.parametrize("shape", STEM_SHAPES[::2])
def test_stem_without_bias_or_relu(cuda, shape):
    """No bias and relu off: the forward is the bare conv, the input
    gradient takes every cotangent unmasked."""
    x, w9, _, g = _stem_inputs(cuda, *shape, seed=1)
    y, dx = _stem_kernels(x, w9, None, g, relu=False)
    want_y, want_dx = _stem_plain(x, w9, None, g, y, relu=False)
    assert (y < 0).any()
    _within_one_ulp(y, want_y)
    _within_one_ulp(dx, want_dx)


@pytest.mark.parametrize("shape", [(1, 7, 7), (4, 33, 97)])
def test_stem_all_masked(cuda, shape):
    """A pre-activation negative everywhere: y is all zero, the mask takes
    every cotangent away, dx is zero; both equal to the plain version."""
    x, w9, b, g = _stem_inputs(cuda, *shape, seed=2)
    b = torch.full_like(b, -1e4)
    y, dx = _stem_kernels(x, w9, b, g)
    want_y, want_dx = _stem_plain(x, w9, b, g, y)
    assert not y.any() and not dx.any()
    assert torch.equal(y, want_y) and torch.equal(dx, want_dx)


@pytest.mark.parametrize("shape", [(1, 7, 7), (4, 33, 97), (2, 40, 130)])
def test_stem_exact_sums(cuda, shape):
    """x in {0, 1}, the weights in {0, 1/2}, the bias a multiple of 1/2 and
    g in {-1, 1, 2}: every sum is exact in float32 in any order, many
    pre-activations are exactly zero (relu's edge, masked), so the kernels
    equal the plain version bit for bit."""
    v, h, w = shape
    gen = torch.Generator(device=cuda).manual_seed(h * w)
    x = (torch.rand((v, h, w, 3), generator=gen, device=cuda) < 0.4)
    weight = (torch.rand((64, 3, 3, 3), generator=gen, device=cuda) < 0.3)
    b = torch.randint(-6, 2, (64,), generator=gen, device=cuda).float() / 2
    g = torch.tensor([-1.0, 1.0, 2.0], device=cuda)[torch.randint(
        0, 3, (v, h, w, 64), generator=gen, device=cuda)]
    x, g = x.to(torch.bfloat16), g.to(torch.bfloat16)
    w9 = conv_kernels.w9_from_oihw(weight.float() / 2)
    y, dx = _stem_kernels(x, w9, b, g)
    want_y, want_dx = _stem_plain(x, w9, b, g, y)
    pre = conv_im2col.stem_forward_plain(x, w9, b, False)
    assert (pre == 0).float().mean().item() > 0.02
    assert torch.equal(y, want_y) and torch.equal(dx, want_dx)


@pytest.mark.parametrize("shape", [(1, 1, 1), (1, 7, 65), (4, 9, 33)])
def test_stem_writes_only_its_outputs(cuda, shape):
    """NaN canaries around y and dx: every element written, nothing
    outside (ragged tiles store no pixel past the map)."""
    x, w9, b, g = _stem_inputs(cuda, *shape, seed=3)
    ybuf, y = _canary(cuda, shape + (64,))
    kernels.launch("stylemesh_stem_fwd", x.device, x.data_ptr(),
                   w9.data_ptr(), b.data_ptr(), y.data_ptr(), *shape, 1)
    _guards_intact(ybuf, y)
    assert torch.equal(y, conv_im2col.stem_forward(x, w9, b))
    dbuf, dx = _canary(cuda, shape + (3,))
    kernels.launch("stylemesh_stem_bwd", x.device, g.data_ptr(), y.data_ptr(),
                   w9.data_ptr(), dx.data_ptr(), *shape, 1)
    _guards_intact(dbuf, dx)
    assert torch.equal(dx, conv_im2col.stem_backward(g, y, w9))


def test_stem_graph_replay_equals_eager(cuda):
    """Both kernels captured in a CUDA graph and replayed give the eager
    launches' outputs bit for bit (no host synchronize, no allocation
    outside PyTorch's allocator)."""
    x, w9, b, g = _stem_inputs(cuda, 4, 256, 341, seed=4)
    want_y = conv_im2col.stem_forward(x, w9, b)
    want_dx = conv_im2col.stem_backward(g, want_y, w9)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        conv_im2col.stem_backward(g, conv_im2col.stem_forward(x, w9, b), w9)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = conv_im2col.stem_forward(x, w9, b)
        dx = conv_im2col.stem_backward(g, y, w9)
    y.zero_()
    dx.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, want_y) and torch.equal(dx, want_dx)


def test_stem_refuses_bad_inputs_on_the_card(cuda):
    """Inputs the kernels do not take raise before a launch: a strided x,
    one misaligned, tensors on two devices (here: a CPU bias)."""
    x, w9, b, g = _stem_inputs(cuda, 1, 8, 8)
    with pytest.raises(ValueError, match="contiguous"):
        conv_im2col.stem_forward(x.transpose(1, 2), w9, b)
    flat = torch.zeros(8 * 8 * 3 + 1, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        conv_im2col.stem_forward(flat[1:].view(1, 8, 8, 3), w9, b)
    with pytest.raises(ValueError, match="CUDA"):
        conv_im2col.stem_forward(x, w9, b.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        conv_im2col.stem_backward(g.transpose(1, 2), g, w9)



# ---------------------------------------------------------------- update

# the bench atlas: 4096^2 ... 512^2, 3 channels
ATLAS_SHAPES = [(4096 >> l, 4096 >> l, 3) for l in range(4)]
# element counts that are and are not multiples of four; eight layers
ADAM_EDGE_SHAPES = [[(1, 1, 1)], [(5, 7, 3)],
                    [(65 >> l, 33 >> l, 3) for l in range(6)] + [(1, 3, 1),
                                                                 (2, 2, 1)]]


def _adam_state(cuda, shapes, seed):
    """Layers over the Gatys range and 10 beyond each bound, zero moments
    (as ``TexturePipeline.init`` makes them)."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    layers = [torch.rand(s, generator=gen, device=cuda)
              * (GATYS_MAX - GATYS_MIN + 20) + (GATYS_MIN - 10) for s in shapes]
    return (layers, [torch.zeros_like(l) for l in layers],
            [torch.zeros_like(l) for l in layers])


def _adam_grads(shapes, gen, cuda):
    """Gradients over six decades, a third of them exactly zero (texels no
    view touched)."""
    out = []
    for s in shapes:
        g = torch.randn(s, generator=gen, device=cuda) * 10.0 ** (
            torch.rand(s, generator=gen, device=cuda) * 6 - 3)
        out.append(g * (torch.rand(s, generator=gen, device=cuda) > 1 / 3))
    return out


def _adam_scalars(step, cuda, lr=1.0):
    return torch.tensor([lr, 1.0 - ADAM_B1 ** (step + 1),
                         1.0 - ADAM_B2 ** (step + 1)], device=cuda)


def _adam_close(got, want):
    """p, m and v within 1e-6 relative plus 1e-6 absolute, element by
    element."""
    for gs_, ws_ in zip(got, want):
        for g, w in zip(gs_, ws_):
            err = ((g - w).abs() - 1e-6 * w.abs()).max().item()
            assert torch.allclose(g, w, rtol=1e-6, atol=1e-6), err


@pytest.mark.parametrize("shapes", [ATLAS_SHAPES] + ADAM_EDGE_SHAPES)
def test_adam_clamp_against_plain(cuda, shapes):
    """The kernel against its plain version run on the card, after one
    update and after 20 (the rate dropping tenfold at the 11th), the
    layers reaching both clamp bounds."""
    layers, mus, nus = _adam_state(cuda, shapes, seed=len(shapes))
    ref = [[t.clone() for t in ts] for ts in (layers, mus, nus)]
    gen = torch.Generator(device=cuda).manual_seed(1)
    before = adam_kernels.adam_clamp_.launches
    for step in range(20):
        grads = _adam_grads(shapes, gen, cuda)
        scalars = _adam_scalars(step, cuda, lr=1.0 if step < 10 else 0.1)
        adam_kernels.adam_clamp_(layers, grads, mus, nus, scalars)
        adam_kernels.adam_clamp_plain_(ref[0], grads, ref[1], ref[2], scalars)
        if step in (0, 19):
            _adam_close((layers, mus, nus), ref)
    assert adam_kernels.adam_clamp_.launches == before + 20
    flat = torch.cat([l.flatten() for l in layers])
    if flat.numel() > 100:
        assert flat.min().item() == ref[0][0].new_tensor(GATYS_MIN).item()
        assert flat.max().item() == ref[0][0].new_tensor(GATYS_MAX).item()


def test_adam_clamp_writes_only_its_layers(cuda):
    """p, m and v inside guard regions of 64 floats: the scalar tail of an
    odd element count writes nothing past its layer."""
    guard, shapes = 64, [(5, 7, 3), (3, 3, 1)]
    bufs, views = [], []
    for _ in range(3):
        for s in shapes:
            n = s[0] * s[1] * s[2]
            buf = torch.full((n + 2 * guard,), 12345.0, device=cuda)
            bufs.append(buf)
            views.append(buf[guard:guard + n].view(s))
    layers, mus, nus = views[0:2], views[2:4], views[4:6]
    init, _, _ = _adam_state(cuda, shapes, seed=0)
    for dst, src in zip(layers + mus + nus, init + [torch.zeros_like(l)
                                                    for l in init] * 2):
        dst.copy_(src)
    ref = [[t.clone() for t in ts] for ts in (layers, mus, nus)]
    grads = _adam_grads(shapes, torch.Generator(device=cuda).manual_seed(2),
                        cuda)
    scalars = _adam_scalars(0, cuda)
    adam_kernels.adam_clamp_(layers, grads, mus, nus, scalars)
    adam_kernels.adam_clamp_plain_(ref[0], grads, ref[1], ref[2], scalars)
    torch.cuda.synchronize()
    for buf, view in zip(bufs, views):
        assert (buf[:guard] == 12345.0).all()
        assert (buf[guard + view.numel():] == 12345.0).all()
    _adam_close((layers, mus, nus), ref)


def test_adam_clamp_graph_replay_reads_the_scalars(cuda):
    """The update captured in a CUDA graph and replayed after
    ``write_adam_scalars`` at steps 0, 39 and 40 (a StepLR decay of 40
    steps: the rate drops tenfold at 40), new gradients copied into the
    captured buffers each time: each replay matches the plain update run
    eagerly with that step's scalars. Captured with zero scalars, so a
    frozen rate or bias correction would not match. The capture counts one
    launch; a replay runs no Python and counts none."""
    cfg = PipelineConfig(steps_per_epoch=1, texture_width=96,
                         texture_height=64, hierarchical_layers=3,
                         learning_rate=1.0, decay_gamma=0.1,
                         decay_step_size=40)
    pipe = TexturePipeline(cfg, {}, None, device=cuda,
                           style_targets=StyleTargets(grams={}))
    shapes = [(64 >> l, 96 >> l, 3) for l in range(3)]
    layers, mus, nus = _adam_state(cuda, shapes, seed=3)
    gen = torch.Generator(device=cuda).manual_seed(3)
    grads = _adam_grads(shapes, gen, cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up, on copies
        adam_kernels.adam_clamp_([l.clone() for l in layers], grads,
                                 [m.clone() for m in mus],
                                 [v.clone() for v in nus], _adam_scalars(0, cuda))
    torch.cuda.current_stream().wait_stream(side)
    assert not pipe._adam_scalars.any()
    before = adam_kernels.adam_clamp_.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        adam_kernels.adam_clamp_(layers, grads, mus, nus, pipe._adam_scalars)
    assert adam_kernels.adam_clamp_.launches == before + 1
    ref = [[t.clone() for t in ts] for ts in (layers, mus, nus)]
    rates = []
    for step in (0, 39, 40):
        for g, new in zip(grads, _adam_grads(shapes, gen, cuda)):
            g.copy_(new)
        pipe.write_adam_scalars(step)
        graph.replay()
        adam_kernels.adam_clamp_plain_(ref[0], grads, ref[1], ref[2],
                                       pipe._adam_scalars)
        torch.cuda.synchronize()
        rates.append(pipe._adam_scalars[0].item())
        _adam_close((layers, mus, nus), ref)
    assert rates == [1.0, 1.0, pytest.approx(0.1)]
    assert adam_kernels.adam_clamp_.launches == before + 1


def _reg_coefs(shapes):
    """The regularizer's coefficients at tex_reg_weight 5e3: layer weights
    2^(L-1-l), the last 0 (where there are two or more), over each layer's
    own size."""
    n = len(shapes)
    weights = [2.0 ** (n - 1 - l) for l in range(n)]
    if n > 1:
        weights[-1] = 0.0
    return [5e3 * w * 2.0 / (s[0] * s[1] * s[2])
            for w, s in zip(weights, shapes)], weights


@pytest.mark.parametrize("off", [False, True])
@pytest.mark.parametrize("shapes", [ATLAS_SHAPES] + ADAM_EDGE_SHAPES)
def test_adam_clamp_folds_the_regularizer_bit_for_bit(cuda, shapes, off):
    """The kernel with the regularizer's coefficients (or all of them 0)
    against its plain version run on the card, over three updates: p, m
    and v bit for bit; the gradients are left as they were. At the bench
    atlas, a layer with a scalar tail, one layer and eight."""
    layers, mus, nus = _adam_state(cuda, shapes, seed=7 + len(shapes))
    coefs = [0.0] * len(shapes) if off else _reg_coefs(shapes)[0]
    ref = [[t.clone() for t in ts] for ts in (layers, mus, nus)]
    gen = torch.Generator(device=cuda).manual_seed(4)
    for step in range(3):
        grads = _adam_grads(shapes, gen, cuda)
        kept = [g.clone() for g in grads]
        scalars = _adam_scalars(step, cuda)
        adam_kernels.adam_clamp_(layers, grads, mus, nus, scalars, coefs)
        adam_kernels.adam_clamp_plain_(ref[0], grads, ref[1], ref[2],
                                       scalars, coefs)
        assert all(torch.equal(g, k) for g, k in zip(grads, kept))
    torch.cuda.synchronize()
    for got, want in zip((layers, mus, nus), ref):
        for g, w in zip(got, want):
            assert torch.equal(g, w), (g - w).abs().max().item()


@pytest.mark.parametrize("shapes", [ATLAS_SHAPES] + ADAM_EDGE_SHAPES)
def test_tex_reg_value_against_float64(cuda, shapes):
    """The regularizer's value against a float64 sum, 1e-6 relative; two
    calls give the same bits and count two launches each."""
    layers, _, _ = _adam_state(cuda, shapes, seed=9)
    weights = _reg_coefs(shapes)[1]
    before = adam_kernels.tex_reg_value.launches
    first = adam_kernels.tex_reg_value(layers, weights)
    second = adam_kernels.tex_reg_value(layers, weights)
    want = sum(w * (l.double() ** 2).mean() for w, l in zip(weights, layers))
    assert adam_kernels.tex_reg_value.launches == before + 2
    assert first.dtype == torch.float32 and first.shape == ()
    assert torch.equal(first, second)
    assert abs(first.item() - want.item()) <= 1e-6 * abs(want.item())


def test_tex_reg_value_refuses_bad_inputs_on_the_card(cuda):
    """A misaligned layer and nine layers raise before a launch."""
    flat = torch.zeros(8 * 8 * 3 + 1, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        adam_kernels.tex_reg_value([flat[1:].view(8, 8, 3)], [1.0])
    layer = torch.zeros(8, 8, 3, device=cuda)
    with pytest.raises(ValueError, match="at most 8"):
        adam_kernels.tex_reg_value([layer] * 9, [1.0] * 9)


def test_adam_clamp_refuses_bad_inputs_on_the_card(cuda):
    """A misaligned layer, scalars on the CPU and nine layers raise before
    a launch."""
    shapes = [(8, 8, 3)]
    layers, mus, nus = _adam_state(cuda, shapes, seed=0)
    grads = [torch.zeros_like(l) for l in layers]
    scalars = _adam_scalars(0, cuda)
    flat = torch.zeros(8 * 8 * 3 + 1, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        adam_kernels.adam_clamp_([flat[1:].view(8, 8, 3)], grads, mus, nus,
                                 scalars)
    with pytest.raises(ValueError, match="CUDA"):
        adam_kernels.adam_clamp_(layers, grads, mus, nus, scalars.cpu())
    with pytest.raises(ValueError, match="at most 8"):
        adam_kernels.adam_clamp_(layers * 9, grads * 9, mus * 9, nus * 9,
                                 scalars)
    assert not mus[0].any()
