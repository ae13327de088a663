"""Bilinear texture sampling (counterpart of ``stylemesh_tpu/ops/grid_sample.py``).

The reference renders by sampling a texture atlas at baked per-pixel UVs with
``torch.grid_sample(mode='bilinear', padding_mode='border',
align_corners=True)``. The forward is a 4-corner gather, the backward a
4-corner scatter-add of pixel gradients into the atlas.

:func:`sample_levels` samples every layer of a Laplacian texture at each
of a step's UV pyramid levels and sums over the layers, with both
directions as hand-written kernels on the card: K1 (:func:`gather_levels`,
one launch for all levels and layers) and K2 (:func:`splat_levels`, one
zero fill per layer and one launch that splats every level's cotangent
into it). :func:`sample_layers`, :func:`gather_layers` and
:func:`splat_layers` are their one-level case. :func:`gather_each` is K1's
per-view form: each grid samples its own image, one launch for up to
``MAX_LEVELS`` of them (the eval's warps). The plain versions sit
beside them and serve tensors that lie on the CPU; a CUDA tensor launches
the kernel or raises.

Conventions: texture layers ``[H, W, C]`` channel-last float32; grids
``[..., 2]`` with ``(x, y)`` in ``[-1, 1]``, where -1 maps to pixel 0 and
+1 to pixel ``size - 1``.

``compute`` selects the kernels' numerics, as ``sample_texture(...,
compute=)`` of the JAX package does for its planned TPU kernels:

- ``"f32"``: the exact float32 function;
- ``"bf16"``: the TPU kernels' bf16 mode (``splat_pallas.py``). Both 1-D
  bilinear weights are the float32 tent ``max(1 - |p - i|, 0)`` rounded to
  bf16. The gather rounds the texel values to bf16 and takes products and
  sums in float32; the splat rounds the cotangent and ``row_w * g`` to bf16
  too, and accumulates in float32. The JAX package rounds only the pixels
  inside its planned windows; the port has no planner, so it rounds every
  pixel except the background pixels at grid exactly ``(-1, -1)``, which
  stay exact float32 there as here.

Atlas-sharded training splits every layer into row bands, one per rank.
:func:`sample_levels_banded` gives one rank's partial renders: the banded
K1 (:func:`gather_levels_banded`) and K2 (:func:`splat_levels_banded`)
take the corner indices and weights of the whole layer and keep the
corners whose texel row lies in the rank's band, in either mode. The JAX
package reaches the same function through ``grid_sample_banded_cf`` with
``row0`` and ``include_background=False``.
"""

import ctypes
import functools

import torch

from stylemesh_tpu_torch import kernels

MAX_LAYERS = 8  # SM_MAX_LAYERS in kernels/csrc/sample.cu
MAX_LEVELS = 8  # SM_MAX_LEVELS
COMPUTE_MODES = ("f32", "bf16")


def _clamped_pixel(grid, h, w):
    """The align_corners=True pixel coordinates of ``grid``, clamped to the
    layer (border padding). A NaN coordinate becomes 0, as the kernels'
    ``fminf(fmaxf(p, 0), size - 1)`` makes it; ``torch.clamp`` alone keeps
    NaN, and the integer index of NaN is undefined."""
    px = (grid[..., 0] + 1.0) * 0.5 * (w - 1)
    py = (grid[..., 1] + 1.0) * 0.5 * (h - 1)
    px = torch.clamp(torch.nan_to_num(px, nan=0.0), 0.0, w - 1)
    py = torch.clamp(torch.nan_to_num(py, nan=0.0), 0.0, h - 1)
    return px, py


def _corner_indices_weights(grid, h, w):
    """Clamped corner indices and the x1/y1 bilinear weights of an
    align_corners=True, border-padded sample."""
    px, py = _clamped_pixel(grid, h, w)
    ix0 = torch.floor(px).long()
    iy0 = torch.floor(py).long()
    ix1 = torch.clamp(ix0 + 1, max=w - 1)
    iy1 = torch.clamp(iy0 + 1, max=h - 1)
    wx1 = px - ix0.to(px.dtype)
    wy1 = py - iy0.to(py.dtype)
    return iy0, iy1, ix0, ix1, wy1, wx1


def _gather_plain(texture, grid):
    h, w, c = texture.shape
    iy0, iy1, ix0, ix1, wy1, wx1 = _corner_indices_weights(grid, h, w)
    flat = texture.reshape(h * w, c)

    def pix(iy, ix):
        idx = iy * w + ix
        return flat[idx.reshape(-1)].reshape(idx.shape + (c,))

    wy1e, wx1e = wy1[..., None], wx1[..., None]
    top = pix(iy0, ix0) * (1.0 - wx1e) + pix(iy0, ix1) * wx1e
    bot = pix(iy1, ix0) * (1.0 - wx1e) + pix(iy1, ix1) * wx1e
    return top * (1.0 - wy1e) + bot * wy1e


def _splat_plain(g, grid, h, w):
    c = g.shape[-1]
    iy0, iy1, ix0, ix1, wy1, wx1 = _corner_indices_weights(grid, h, w)
    g2 = g.reshape(-1, c)
    wy1f, wx1f = wy1.reshape(-1, 1), wx1.reshape(-1, 1)
    dtex = torch.zeros((h * w, c), dtype=g.dtype, device=g.device)
    for iy, ix, contrib in (
            (iy0, ix0, g2 * (1.0 - wy1f) * (1.0 - wx1f)),
            (iy0, ix1, g2 * (1.0 - wy1f) * wx1f),
            (iy1, ix0, g2 * wy1f * (1.0 - wx1f)),
            (iy1, ix1, g2 * wy1f * wx1f)):
        dtex.index_add_(0, (iy * w + ix).reshape(-1), contrib)
    return dtex.reshape(h, w, c)


def _bf16r(x):
    return x.to(torch.bfloat16).float()


def _tent_bf16(frac):
    """bf16 mode: the lower / upper corner weights, the float32 tent
    ``max(1 - |p - i|, 0)`` at ``i = floor(p)`` and ``floor(p) + 1``, each
    rounded to bf16."""
    u = 1.0 - frac
    return _bf16r(u), _bf16r(1.0 - u)


def _background(grid):
    """``[...]`` bool: pixels at grid exactly (-1, -1)."""
    return (grid[..., 0] == -1.0) & (grid[..., 1] == -1.0)


def _gather_plain_bf16(texture, grid):
    h, w, c = texture.shape
    iy0, iy1, ix0, ix1, wy1, wx1 = _corner_indices_weights(grid, h, w)
    flat = _bf16r(texture).reshape(h * w, c)

    def pix(iy, ix):
        idx = iy * w + ix
        return flat[idx.reshape(-1)].reshape(idx.shape + (c,))

    ux, wx = (t[..., None] for t in _tent_bf16(wx1))
    uy, wy = (t[..., None] for t in _tent_bf16(wy1))
    top = pix(iy0, ix0) * ux + pix(iy0, ix1) * wx
    bot = pix(iy1, ix0) * ux + pix(iy1, ix1) * wx
    out = top * uy + bot * wy
    return torch.where(_background(grid)[..., None],
                       _gather_plain(texture, grid), out)


def _splat_plain_bf16(g, grid, h, w):
    c = g.shape[-1]
    iy0, iy1, ix0, ix1, wy1, wx1 = _corner_indices_weights(grid, h, w)
    bg = _background(grid).reshape(-1, 1)
    g2 = g.reshape(-1, c)
    gb = _bf16r(g2)
    ux, wx = (t.reshape(-1, 1) for t in _tent_bf16(wx1))
    uy, wy = (t.reshape(-1, 1) for t in _tent_bf16(wy1))
    wy1f, wx1f = wy1.reshape(-1, 1), wx1.reshape(-1, 1)
    dtex = torch.zeros((h * w, c), dtype=g.dtype, device=g.device)
    for iy, ix, exact, row_w, col_w in (
            (iy0, ix0, g2 * (1.0 - wy1f) * (1.0 - wx1f), uy, ux),
            (iy0, ix1, g2 * (1.0 - wy1f) * wx1f, uy, wx),
            (iy1, ix0, g2 * wy1f * (1.0 - wx1f), wy, ux),
            (iy1, ix1, g2 * wy1f * wx1f, wy, wx)):
        contrib = torch.where(bg, exact, _bf16r(row_w * gb) * col_w)
        dtex.index_add_(0, (iy * w + ix).reshape(-1), contrib)
    return dtex.reshape(h, w, c)


def gather_layers_plain(layers, grid):
    """Plain version of K1 (f32 mode): sum over layers of the bilinear
    sample."""
    out = None
    for layer in layers:
        y = _gather_plain(layer, grid)
        out = y if out is None else out + y
    return out


def gather_layers_plain_bf16(layers, grid):
    """Plain version of K1's bf16 mode."""
    out = None
    for layer in layers:
        y = _gather_plain_bf16(layer, grid)
        out = y if out is None else out + y
    return out


def splat_layers_plain(g, grid, shapes):
    """Plain version of K2 (f32 mode): per-layer scatter-add of the
    cotangent ``g``."""
    return [_splat_plain(g, grid, h, w) for (h, w) in shapes]


def splat_layers_plain_bf16(g, grid, shapes):
    """Plain version of K2's bf16 mode."""
    return [_splat_plain_bf16(g, grid, h, w) for (h, w) in shapes]


def _band_corner(iy, ix, row0, band_h, w):
    """Band-local flat texel index of a corner at global row ``iy`` (0 where
    the row lies outside ``[row0, row0 + band_h)``) and its in-band flag."""
    local = iy - row0
    inside = (local >= 0) & (local < band_h)
    return torch.where(inside, local, torch.zeros_like(local)) * w + ix, inside


def _gather_plain_banded(band, grid, row0, h, bf16):
    """One layer's band ``[band_h, W, C]`` of a texture ``h`` rows high: the
    corners whose texel row lies in the band, read at their band-local row;
    the others contribute nothing."""
    band_h, w, c = band.shape
    iy0, iy1, ix0, ix1, wy1, wx1 = _corner_indices_weights(grid, h, w)
    flat = (_bf16r(band) if bf16 else band).reshape(band_h * w, c)

    def pix(iy, ix):
        idx, inside = _band_corner(iy, ix, row0, band_h, w)
        v = flat[idx.reshape(-1)].reshape(idx.shape + (c,))
        return torch.where(inside[..., None], v, torch.zeros((), dtype=v.dtype))

    if bf16:
        ux, wx = (t[..., None] for t in _tent_bf16(wx1))
        uy, wy = (t[..., None] for t in _tent_bf16(wy1))
    else:
        wx, wy = wx1[..., None], wy1[..., None]
        ux, uy = 1.0 - wx, 1.0 - wy
    top = pix(iy0, ix0) * ux + pix(iy0, ix1) * wx
    bot = pix(iy1, ix0) * ux + pix(iy1, ix1) * wx
    out = top * uy + bot * wy
    if bf16:  # background pixels stay exact float32
        out = torch.where(_background(grid)[..., None],
                          _gather_plain_banded(band, grid, row0, h, False), out)
    return out


def _splat_plain_banded(g, grid, band_hw, row0, h, bf16):
    """One layer's band gradient: the scatter-add of :func:`_splat_plain`
    (or its bf16 twin) restricted to the corners whose row lies in the
    band."""
    band_h, w = band_hw
    c = g.shape[-1]
    iy0, iy1, ix0, ix1, wy1, wx1 = _corner_indices_weights(grid, h, w)
    g2 = g.reshape(-1, c)
    wy1f, wx1f = wy1.reshape(-1, 1), wx1.reshape(-1, 1)
    exact = ((iy0, ix0, g2 * (1.0 - wy1f) * (1.0 - wx1f)),
             (iy0, ix1, g2 * (1.0 - wy1f) * wx1f),
             (iy1, ix0, g2 * wy1f * (1.0 - wx1f)),
             (iy1, ix1, g2 * wy1f * wx1f))
    if bf16:
        bg = _background(grid).reshape(-1, 1)
        gb = _bf16r(g2)
        ux, wx = (t.reshape(-1, 1) for t in _tent_bf16(wx1))
        uy, wy = (t.reshape(-1, 1) for t in _tent_bf16(wy1))
        exact = [(iy, ix, torch.where(bg, e, _bf16r(row_w * gb) * col_w))
                 for (iy, ix, e), row_w, col_w in zip(
                     exact, (uy, uy, wy, wy), (ux, wx, ux, wx))]
    dtex = torch.zeros((band_h * w, c), dtype=g.dtype, device=g.device)
    for iy, ix, contrib in exact:
        idx, inside = _band_corner(iy, ix, row0, band_h, w)
        contrib = torch.where(inside.reshape(-1, 1), contrib,
                              torch.zeros((), dtype=contrib.dtype))
        dtex.index_add_(0, idx.reshape(-1), contrib)
    return dtex.reshape(band_h, w, c)


def gather_layers_banded_plain(bands, grid, row0s, heights, compute="f32"):
    """Plain version of the banded K1 (either mode): the sum over layers of
    :func:`_gather_plain_banded`."""
    _check_compute(compute)
    out = None
    for band, row0, h in zip(bands, row0s, heights):
        y = _gather_plain_banded(band, grid, row0, h, compute == "bf16")
        out = y if out is None else out + y
    return out


def splat_layers_banded_plain(g, grid, band_shapes, row0s, heights,
                              compute="f32"):
    """Plain version of the banded K2 (either mode)."""
    _check_compute(compute)
    return [_splat_plain_banded(g, grid, hw, row0, h, compute == "bf16")
            for hw, row0, h in zip(band_shapes, row0s, heights)]


def gather_levels_plain(layers, grids, compute="f32"):
    """Plain version of K1 over a level table: one render per grid."""
    _check_compute(compute)
    gather = gather_layers_plain_bf16 if compute == "bf16" else gather_layers_plain
    return [gather(layers, grid) for grid in grids]


def gather_each_plain(images, grids):
    """Plain version of K1's per-view form: ``images[k]`` sampled at
    ``grids[k]``, stacked."""
    return torch.stack([_gather_plain(image, grid)
                        for image, grid in zip(images, grids)])


def splat_levels_plain(cots, grids, shapes, compute="f32"):
    """Plain version of K2 over a level table: the per-level splats of
    ``cots[k]`` at ``grids[k]``, summed into one gradient per layer in level
    order."""
    _check_compute(compute)
    splat = splat_layers_plain_bf16 if compute == "bf16" else splat_layers_plain
    return _sum_levels(splat(g, grid, shapes) for g, grid in zip(cots, grids))


def gather_levels_banded_plain(bands, grids, row0s, heights, compute="f32"):
    """Plain version of the banded K1 over a level table."""
    return [gather_layers_banded_plain(bands, grid, row0s, heights, compute)
            for grid in grids]


def splat_levels_banded_plain(cots, grids, band_shapes, row0s, heights,
                              compute="f32"):
    """Plain version of the banded K2 over a level table: the per-level band
    splats summed into one gradient per band in level order."""
    return _sum_levels(
        splat_layers_banded_plain(g, grid, band_shapes, row0s, heights, compute)
        for g, grid in zip(cots, grids))


def _sum_levels(per_level):
    """The levels' gradient lists summed per layer, in level order."""
    return functools.reduce(lambda a, b: [x + y for x, y in zip(a, b)],
                            per_level)


def _check_compute(compute):
    if compute not in COMPUTE_MODES:
        raise ValueError(f"compute must be one of {COMPUTE_MODES}, got {compute!r}")


def _on_cpu(grids):
    """Whether the grids lie on the CPU (the plain versions' inputs); raises
    for a level count the kernels do not take, on any device."""
    if not 1 <= len(grids) <= MAX_LEVELS:
        raise ValueError(f"1..{MAX_LEVELS} levels, got {len(grids)}")
    return grids[0].device.type == "cpu"


def _check_levels(layers, grids):
    if not 1 <= len(layers) <= MAX_LAYERS:
        raise ValueError(f"1..{MAX_LAYERS} layers, got {len(layers)}")
    if not 1 <= len(grids) <= MAX_LEVELS:
        raise ValueError(f"1..{MAX_LEVELS} levels, got {len(grids)}")
    for grid in grids:
        if grid.shape[-1] != 2:
            raise ValueError(f"grid must end in 2, got {tuple(grid.shape)}")
        if grid.numel() // 2 >= 2 ** 31:
            raise ValueError(f"more than 2^31 pixels in a grid {tuple(grid.shape)}")
    for layer in layers:
        if layer.dim() != 3 or layer.shape[-1] != 3:
            raise ValueError(f"layers must be [H, W, 3], got {tuple(layer.shape)}")
    kernels.require_cuda(*grids, *layers, dtype=torch.float32)


def _check_bands(band_shapes, row0s, heights):
    if not len(band_shapes) == len(row0s) == len(heights):
        raise ValueError("one row0 and one height per band")
    for (band_h, _), row0, h in zip(band_shapes, row0s, heights):
        if not (0 <= row0 and row0 + band_h <= h):
            raise ValueError(f"band rows [{row0}, {row0 + band_h}) outside "
                             f"a layer of {h} rows")


def _level_table(grids, pixels):
    """The C level table: grid and per-pixel array (output or cotangent)
    pointers, and the pixel count of each level."""
    n = len(grids)
    return ((ctypes.c_void_p * n)(*[g.data_ptr() for g in grids]),
            (ctypes.c_void_p * n)(*[p.data_ptr() for p in pixels]),
            (ctypes.c_int * n)(*[g.numel() // 2 for g in grids]))


def _layer_table(tensors):
    n = len(tensors)
    ptrs = (ctypes.c_void_p * n)(*[t.data_ptr() for t in tensors])
    hs = (ctypes.c_int * n)(*[t.shape[0] for t in tensors])
    ws = (ctypes.c_int * n)(*[t.shape[1] for t in tensors])
    return ptrs, hs, ws


def _band_table(band):
    """h_globals and row0s of the C entries: NULL unbanded."""
    if band is None:
        return None, None
    row0s, heights = band
    n = len(row0s)
    return (ctypes.c_int * n)(*heights), (ctypes.c_int * n)(*row0s)


def _count(wrapper, compute, prefix=""):
    attr = prefix + ("bf16_launches" if compute == "bf16" else "launches")
    setattr(wrapper, attr, getattr(wrapper, attr) + 1)


def _gather(layers, grids, compute, band=None):
    """One K1 launch over the level table; (outputs, whether it launched)."""
    _check_levels(layers, grids)
    if band is not None:
        _check_bands([tuple(b.shape[:2]) for b in layers], *band)
    outs = [torch.empty(g.shape[:-1] + (3,), dtype=torch.float32,
                        device=g.device) for g in grids]
    if not any(g.numel() for g in grids):
        return outs, False
    kernels.launch("stylemesh_gather", grids[0].device,
                   *_level_table(grids, outs), len(grids),
                   *_layer_table(layers),
                   *_band_table(band), len(layers), int(compute == "bf16"))
    return outs, True


def _splat(cots, grids, shapes, compute, band=None):
    """One zero fill per layer (or band) and one K2 launch over the level
    table; (gradients, whether it launched)."""
    if not 1 <= len(shapes) <= MAX_LAYERS:
        raise ValueError(f"1..{MAX_LAYERS} layers, got {len(shapes)}")
    if len(cots) != len(grids):
        raise ValueError(f"{len(cots)} cotangents for {len(grids)} grids")
    for g, grid in zip(cots, grids):
        if g.shape != grid.shape[:-1] + (3,):
            raise ValueError(f"cotangent {tuple(g.shape)} vs grid "
                             f"{tuple(grid.shape)}")
    if band is not None:
        _check_bands(shapes, *band)
    kernels.require_cuda(*grids, *cots, dtype=torch.float32)
    grads = [torch.zeros((h, w, 3), dtype=torch.float32, device=grids[0].device)
             for (h, w) in shapes]
    _check_levels(grads, grids)
    if not any(g.numel() for g in grids):
        return grads, False
    kernels.launch("stylemesh_splat", grids[0].device,
                   *_level_table(grids, cots), len(grids),
                   *_layer_table(grads),
                   *_band_table(band), len(grads), int(compute == "bf16"))
    return grads, True


def gather_levels(layers, grids, compute="f32"):
    """K1 over a level table: for each grid ``[..., 2]`` of ``grids`` (at
    most ``MAX_LEVELS``), ``sum_l bilinear(layers[l], grid)`` ->
    ``grid.shape[:-1] + (3,)``.

    CPU tensors take :func:`gather_levels_plain`; CUDA tensors launch the
    kernel (one launch for all grids and layers) or raise. Counts its
    launches in ``.launches`` (f32) and ``.bf16_launches``.
    """
    _check_compute(compute)
    if _on_cpu(grids):
        return gather_levels_plain(layers, grids, compute)
    outs, launched = _gather(layers, grids, compute)
    if launched:
        _count(gather_levels, compute)
    return outs


gather_levels.launches = 0
gather_levels.bf16_launches = 0


def _pair_aligned_rows(t):
    """``t`` ``[K, ...]`` float32 as ``[K, m]`` rows whose starts are 8-byte
    aligned, as K1 reads and writes float pairs: a view of ``t`` when ``m``
    is even, else rows of ``m`` inside an uninitialised buffer of rows of
    ``m + 1`` (the caller copies in or out)."""
    k = t.shape[0]
    flat = t.reshape(k, -1)
    m = flat.shape[1]
    if m % 2 == 0:
        return flat
    return torch.empty((k, m + 1), dtype=t.dtype, device=t.device)[:, :m]


def _row_pointers(rows):
    """The start of every row of ``rows``, as a C array of pointers."""
    k, step = rows.shape[0], rows.stride(0) * rows.element_size()
    base = rows.data_ptr()
    return (ctypes.c_void_p * k)(*[base + i * step for i in range(k)])


def gather_each(images, grids):
    """K1's per-view form: ``images`` ``[K, H, W, 3]`` float32 and ``grids``
    ``[K, ..., 2]`` -> ``[K, ..., 3]``, where view ``k`` is ``images[k]``
    bilinearly sampled at ``grids[k]``, with no sum over the images; at most
    ``MAX_LEVELS`` views.

    CPU tensors take :func:`gather_each_plain`; CUDA tensors launch the
    kernel (one launch for all views) or raise. The kernel takes each view
    as a level of its level table and its image as that level's layer.
    Where a view's image or output holds an odd number of floats, the
    views go through a buffer of padded rows (a copy). Counts its launches
    in ``.launches``.
    """
    k = images.shape[0]
    if images.dim() != 4 or images.shape[-1] != 3 or 0 in images.shape[1:3]:
        raise ValueError(f"images must be [K, H, W, 3], got {tuple(images.shape)}")
    if grids.shape[0] != k or grids.shape[-1] != 2:
        raise ValueError(f"grids {tuple(grids.shape)} for images "
                         f"{tuple(images.shape)}")
    if not 1 <= k <= MAX_LEVELS:
        raise ValueError(f"1..{MAX_LEVELS} views, got {k}")
    if grids.device.type == "cpu":
        return gather_each_plain(images, grids)
    kernels.require_cuda(images, grids, dtype=torch.float32)
    npx = grids.numel() // (2 * k)
    if npx >= 2 ** 31:
        raise ValueError(f"more than 2^31 pixels in a grid {tuple(grids.shape)}")
    out = torch.empty(grids.shape[:-1] + (3,), dtype=torch.float32,
                      device=grids.device)
    if npx == 0:
        return out
    src = _pair_aligned_rows(images)
    if src.data_ptr() != images.data_ptr():
        src.copy_(images.reshape(k, -1))
    dst = _pair_aligned_rows(out)
    kernels.launch("stylemesh_gather_each", grids.device,
                   _row_pointers(grids.reshape(k, -1)), _row_pointers(dst),
                   (ctypes.c_int * k)(*[npx] * k), k, _row_pointers(src),
                   (ctypes.c_int * k)(*[images.shape[1]] * k),
                   (ctypes.c_int * k)(*[images.shape[2]] * k))
    gather_each.launches += 1
    if dst.data_ptr() != out.data_ptr():
        out.reshape(k, -1).copy_(dst)
    return out


gather_each.launches = 0


def splat_levels(cots, grids, shapes, compute="f32"):
    """K2 over a level table: the atlas gradients of :func:`gather_levels`
    for the cotangents ``cots[k]`` of its renders, every level splatted into
    one zero-initialised float32 ``[H_l, W_l, 3]`` per ``shapes[l]``.

    CPU tensors take :func:`splat_levels_plain`; CUDA tensors launch the
    kernel (one fill per layer, one launch for all grids and layers) or
    raise. Equal to the sequential scatter-add up to summation order.
    Counts its launches in ``.launches`` (f32) and ``.bf16_launches``.
    """
    _check_compute(compute)
    if _on_cpu(grids):
        return splat_levels_plain(cots, grids, shapes, compute)
    grads, launched = _splat(cots, grids, shapes, compute)
    if launched:
        _count(splat_levels, compute)
    return grads


splat_levels.launches = 0
splat_levels.bf16_launches = 0


def gather_levels_banded(bands, grids, row0s, heights, compute="f32"):
    """The banded K1 over a level table: this rank's share of
    :func:`gather_levels` when every layer ``l`` of the texture
    (``heights[l]`` rows) is split into row bands and this rank holds rows
    ``[row0s[l], row0s[l] + bands[l].shape[0])`` of it. The corner indices
    and weights are those of the whole layer; a corner adds its texel only
    when the texel's row lies in the band. Summed over the bands of every
    rank, the partials are :func:`gather_levels`: the background pixels at
    grid (-1, -1) read texel (0, 0) with weight 1 and so belong to the band
    holding row 0.

    CPU tensors take :func:`gather_levels_banded_plain`; CUDA tensors launch
    the kernel (one launch for all grids and bands) or raise. Counts its
    launches in ``.banded_launches`` (f32) and ``.banded_bf16_launches``.
    """
    _check_compute(compute)
    if _on_cpu(grids):
        return gather_levels_banded_plain(bands, grids, row0s, heights, compute)
    outs, launched = _gather(bands, grids, compute, (row0s, heights))
    if launched:
        _count(gather_levels_banded, compute, "banded_")
    return outs


gather_levels_banded.banded_launches = 0
gather_levels_banded.banded_bf16_launches = 0


def splat_levels_banded(cots, grids, band_shapes, row0s, heights,
                        compute="f32"):
    """The banded K2 over a level table: the gradients of
    :func:`gather_levels_banded` for the cotangents ``cots[k]``, every level
    splatted into one zero-initialised float32 ``[band_h, W, 3]`` per
    ``band_shapes[l]``: the scatter-add of :func:`splat_levels` restricted
    to the corners whose row lies in the band.

    CPU tensors take :func:`splat_levels_banded_plain`; CUDA tensors launch
    the kernel (one launch for all grids and bands) or raise. Counts its
    launches in ``.banded_launches`` (f32) and ``.banded_bf16_launches``.
    """
    _check_compute(compute)
    if _on_cpu(grids):
        return splat_levels_banded_plain(cots, grids, band_shapes, row0s,
                                         heights, compute)
    grads, launched = _splat(cots, grids, band_shapes, compute,
                             (row0s, heights))
    if launched:
        _count(splat_levels_banded, compute, "banded_")
    return grads


splat_levels_banded.banded_launches = 0
splat_levels_banded.banded_bf16_launches = 0


def gather_layers(layers, grid, compute="f32"):
    """K1 at one grid: :func:`gather_levels` of one level."""
    return gather_levels(layers, [grid], compute)[0]


def splat_layers(g, grid, shapes, compute="f32"):
    """K2 at one grid: :func:`splat_levels` of one level."""
    return splat_levels([g], [grid], shapes, compute)


def gather_layers_banded(bands, grid, row0s, heights, compute="f32"):
    """The banded K1 at one grid: :func:`gather_levels_banded` of one
    level."""
    return gather_levels_banded(bands, [grid], row0s, heights, compute)[0]


def splat_layers_banded(g, grid, band_shapes, row0s, heights, compute="f32"):
    """The banded K2 at one grid: :func:`splat_levels_banded` of one
    level."""
    return splat_levels_banded([g], [grid], band_shapes, row0s, heights,
                               compute)


class _SampleLevels(torch.autograd.Function):
    """For each grid, the sum of bilinear samples of every layer, or with
    ``band = (row0s, heights)`` this rank's partial over its row bands;
    differentiable w.r.t. the layers only (UV grids are baked batch
    constants). The backward splats only the renders that get a gradient:
    a detached render's cotangent is None and its level stays out of the
    K2 launch."""

    @staticmethod
    def forward(ctx, compute, band, n_grids, *tensors):
        grids, layers = tensors[:n_grids], tensors[n_grids:]
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*grids)
        ctx.shapes = [tuple(l.shape[:2]) for l in layers]
        ctx.compute, ctx.band = compute, band
        if band is None:
            return tuple(gather_levels(layers, grids, compute))
        return tuple(gather_levels_banded(layers, grids, *band, compute))

    @staticmethod
    def backward(ctx, *cots):
        grids = ctx.saved_tensors
        live = [k for k, g in enumerate(cots) if g is not None]
        grads = [None] * len(ctx.shapes)
        if live:
            args = ([cots[k].contiguous() for k in live],
                    [grids[k] for k in live], ctx.shapes)
            if ctx.band is None:
                grads = splat_levels(*args, ctx.compute)
            else:
                grads = splat_levels_banded(*args, *ctx.band, ctx.compute)
        return (None, None, None, *[None] * len(grids), *grads)


def sample_levels(layers, grids, compute="f32"):
    """For each grid of ``grids``, ``sum_l grid_sample(layers[l], grid)``,
    with the K1/K2 autograd pair in the given ``compute`` mode: one K1
    launch renders every grid, one K2 launch splats every render's
    gradient into one gradient per layer."""
    if not grids:
        return []
    return list(_SampleLevels.apply(compute, None, len(grids),
                                    *[g.contiguous() for g in grids],
                                    *[l.contiguous() for l in layers]))


def sample_levels_banded(bands, grids, row0s, heights, compute="f32"):
    """This rank's partial renders from its row bands, one per grid, with
    the banded K1/K2 autograd pair (``row0s`` / ``heights``: each band's
    first row and its layer's full height)."""
    if not grids:
        return []
    return list(_SampleLevels.apply(compute, (tuple(row0s), tuple(heights)),
                                    len(grids),
                                    *[g.contiguous() for g in grids],
                                    *[b.contiguous() for b in bands]))


def sample_layers(layers, grid, compute="f32"):
    """``sum_l grid_sample(layers[l], grid)``: :func:`sample_levels` of one
    grid."""
    return sample_levels(layers, [grid], compute)[0]


def sample_layers_banded(bands, grid, row0s, heights, compute="f32"):
    """This rank's partial render at one grid: :func:`sample_levels_banded`
    of one grid."""
    return sample_levels_banded(bands, [grid], row0s, heights, compute)[0]


def launch_counts():
    """The launch counts of the sampling kernels, by kernel and mode."""
    return {"gather": gather_levels.launches,
            "gather_bf16": gather_levels.bf16_launches,
            "gather_each": gather_each.launches,
            "splat": splat_levels.launches,
            "splat_bf16": splat_levels.bf16_launches,
            "gather_banded": gather_levels_banded.banded_launches,
            "gather_banded_bf16": gather_levels_banded.banded_bf16_launches,
            "splat_banded": splat_levels_banded.banded_launches,
            "splat_banded_bf16": splat_levels_banded.banded_bf16_launches}


def grid_sample(texture, grid):
    """Bilinear sample of ``texture [H, W, C]`` at ``grid [..., 2]``: torch
    ``grid_sample(mode='bilinear', padding_mode='border',
    align_corners=True)`` with the texture broadcast over the batch."""
    return sample_layers([texture], grid)


def nearest_indices(grid, h, w):
    """Flat texel indices ``iy * w + ix`` of a nearest-neighbour sample of
    an ``h x w`` layer at ``grid [..., 2]`` (border padding,
    align_corners=True); rounds half to even like torch's
    ``grid_sample(mode='nearest')``."""
    px, py = _clamped_pixel(grid, h, w)
    ix = torch.clamp(torch.round(px).long(), 0, w - 1)
    iy = torch.clamp(torch.round(py).long(), 0, h - 1)
    return iy * w + ix


def grid_sample_nearest(texture, grid):
    """Nearest-neighbour sample of ``texture [H, W, C]`` at ``grid [..., 2]``
    (:func:`nearest_indices`). Not differentiable (depth lookups)."""
    h, w, c = texture.shape
    idx = nearest_indices(grid, h, w)
    return texture.reshape(h * w, c)[idx.reshape(-1)].reshape(idx.shape + (c,))
