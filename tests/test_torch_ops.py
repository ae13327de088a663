"""Port parity: small ops and data (color, resizes, erosion, pyramid, Gram
ops, depth levels, synthetic batches) against the JAX package on the CPU.

Tolerances: float32 ops that compute the same arithmetic agree to 1e-5
relative (rounding of differently ordered float32 sums); data generators
and integer-valued maps must agree exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylemesh_tpu.data import depth_level as jdepth
from stylemesh_tpu.data.synthetic import synthetic_view_batch as jsynth
from stylemesh_tpu.ops import color as jcolor
from stylemesh_tpu.ops import erosion as jerosion
from stylemesh_tpu.ops import gram as jgram
from stylemesh_tpu.ops import pyramid as jpyramid
from stylemesh_tpu.ops import resize as jresize
from stylemesh_tpu_torch.data import depth_level as tdepth
from stylemesh_tpu_torch.data.synthetic import synthetic_view_batch as tsynth
from stylemesh_tpu_torch.ops import color as tcolor
from stylemesh_tpu_torch.ops import erosion as terosion
from stylemesh_tpu_torch.ops import gram as tgram
from stylemesh_tpu_torch.ops import pyramid as tpyramid
from stylemesh_tpu_torch.ops import resize as tresize

RNG = np.random.default_rng(5)
F32 = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return np.asarray(x.detach().float() if torch.is_tensor(x) else x,
                      dtype=np.float32)


def test_gatys_pre_post():
    rgb = RNG.random((2, 5, 7, 3), dtype=np.float32)
    pre = tcolor.gatys_pre(torch.from_numpy(rgb))
    np.testing.assert_allclose(_np(pre), _np(jcolor.gatys_pre(jnp.asarray(rgb))),
                               **F32)
    np.testing.assert_allclose(_np(tcolor.gatys_post(pre)), rgb, atol=1e-5)
    assert (tcolor.GATYS_MIN, tcolor.GATYS_MAX) == (jcolor.GATYS_MIN,
                                                      jcolor.GATYS_MAX)


@pytest.mark.parametrize("src,dst", [((12, 17), (5, 7)), ((5, 7), (12, 17)),
                                     ((9, 16), (9, 5)), ((8, 8), (8, 8))])
def test_resizes(src, dst):
    img = RNG.normal(size=(2,) + src + (3,)).astype(np.float32)
    for tfn, jfn in ((tresize.resize_bilinear, jresize.resize_bilinear),
                     (tresize.resize_nearest, jresize.resize_nearest)):
        got = tfn(torch.from_numpy(img), dst)
        want = jfn(jnp.asarray(img), dst)
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_erode():
    m = (RNG.random((2, 11, 13, 1)) < 0.8).astype(np.float32)
    np.testing.assert_array_equal(
        _np(terosion.erode(torch.from_numpy(m))),
        _np(jerosion.erode(jnp.asarray(m))))


@pytest.mark.parametrize("reverse", [False, True])
def test_image_pyramid(reverse):
    img = RNG.normal(size=(1, 40, 53, 3)).astype(np.float32)
    levels = list(range(5))
    assert (tpyramid.pyramid_shapes(40, 53, levels, 16)
            == jpyramid.pyramid_shapes(40, 53, levels, 16))
    got = tpyramid.image_pyramid(torch.from_numpy(img), levels, reverse, 16)
    want = jpyramid.image_pyramid(jnp.asarray(img), levels, reverse, 16)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gram_ops(dtype):
    """bf16 features: the products are exact in float32 in both packages,
    so the bf16 path is held to the float32 tolerance too."""
    f = RNG.normal(size=(2, 6, 7, 16)).astype(np.float32)
    g = RNG.normal(size=(2, 6, 7, 16)).astype(np.float32)
    m = (RNG.random((2, 6, 7, 1)) < 0.5).astype(np.float32)
    m[1] = 0.0  # an empty mask gives a zero Gram and a zero MSE
    tdt = getattr(torch, dtype)
    tf = torch.from_numpy(f).to(tdt)
    jf = jnp.asarray(f).astype(getattr(jnp, dtype))
    tm, jm = torch.from_numpy(m), jnp.asarray(m)
    pairs = [
        (tgram.gram_matrix(tf), jgram.gram_matrix(jf)),
        (tgram.masked_gram(tf, tm), jgram.masked_gram(jf, jm)),
        (tgram.masked_mse(tf, torch.from_numpy(g), tm),
         jgram.masked_mse(jf, jnp.asarray(g), jm)),
        (tgram.mse(tf, torch.from_numpy(g)), jgram.mse(jf, jnp.asarray(g))),
    ]
    for got, want in pairs:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), _np(want), **F32)
    assert float(tgram.masked_gram(tf, tm)[1].abs().max()) == 0.0


def test_depth_level_and_synthetic_batch():
    depth = (RNG.random((9, 13)) * 6.0 + 0.05).astype(np.float32)
    levels = [256.0, 432.0, 608.0, 784.0]
    for a, b in zip(tdepth.calculate_depth_level(depth, levels),
                    jdepth.calculate_depth_level(depth, levels)):
        np.testing.assert_array_equal(a, b)
    kw = dict(num_views=2, content_hw=(10, 13), level_heights=(10, 16), seed=3,
              depth_range=(0.2, 0.5))
    got = tsynth(numpy_arrays=True, **kw)
    want = jsynth(jnp_arrays=False, **kw)
    for name in got._fields:
        a, b = getattr(got, name), getattr(want, name)
        if isinstance(a, tuple):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_array_equal(a, b)
    tensors = tsynth(device="cpu", **kw)
    assert tensors.rgb.dtype == torch.float32 and len(tensors.uv) == 2
    np.testing.assert_array_equal(tensors.uv[1].numpy(), want.uv[1])


def test_jax_runs_on_cpu():
    assert jax.default_backend() == "cpu"
