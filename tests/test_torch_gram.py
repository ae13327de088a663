"""Port parity: the fused masked-Gram sums and their gradient (the plain
versions of kernels K3/K4) against the TPU kernels themselves,
``gram_pallas.masked_gram_sums(..., interpret=True)``, on the CPU.

Tolerances: the forward products are exact in float32 in both, so the sums
differ only in order: 1e-5 relative to the largest Gram entry. The gradient
is rounded to bf16 by both after a float32 sum in another order: one bf16
ulp, 2^-8 relative to the largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylemesh_tpu.ops import gram_pallas
from stylemesh_tpu_torch.ops import gram_kernels

RNG = np.random.default_rng(23)


def _inputs(v, h, w, c, k):
    f = RNG.normal(size=(v, h, w, c)).astype(np.float32)
    f = np.array(jnp.asarray(f).astype(jnp.bfloat16).astype(jnp.float32))
    masks = (RNG.random((k, v, h, w)) < 0.6).astype(np.float32)
    ct = RNG.normal(size=(v, k, c, c)).astype(np.float32)
    return f, masks, ct


def _jax(f, masks, ct):
    mt = gram_pallas.stack_masks(jnp.asarray(masks))
    fb = jnp.asarray(f).astype(jnp.bfloat16)
    sums, vjp = jax.vjp(
        lambda x: gram_pallas.fused_masked_grams(x, mt, True), fb)
    (df,) = vjp(jnp.asarray(ct))
    return (np.asarray(sums, np.float32),
            np.asarray(df.astype(jnp.float32)).reshape(f.shape))


def _torch(f, masks, ct):
    fb = torch.from_numpy(f).to(torch.bfloat16).requires_grad_()
    mt = gram_kernels.stack_masks(torch.from_numpy(masks))
    sums = gram_kernels.fused_masked_grams(fb, mt)
    (df,) = torch.autograd.grad(sums, [fb], torch.from_numpy(ct))
    assert sums.dtype == torch.float32 and df.dtype == torch.bfloat16
    return sums.detach().numpy(), df.float().numpy()


@pytest.mark.parametrize("c", [64, 128])
@pytest.mark.parametrize("k", [1, 2])
def test_fused_masked_grams_match_pallas_kernel(c, k):
    f, masks, ct = _inputs(v=2, h=48, w=61, c=c, k=k)  # P = 2928
    if k == 2:
        masks[1, 1] = 0.0  # one empty mask variant: a zero Gram
    want_sums, want_df = _jax(f, masks, ct)
    got_sums, got_df = _torch(f, masks, ct)
    np.testing.assert_allclose(got_sums, want_sums, rtol=0,
                               atol=1e-5 * np.abs(want_sums).max())
    np.testing.assert_allclose(got_df, want_df, rtol=0,
                               atol=2 ** -8 * np.abs(want_df).max())
    if k == 2:
        assert np.abs(got_sums[1, 1]).max() == 0.0


def test_stack_masks_layout():
    masks = (RNG.random((2, 3, 4, 5)) < 0.5).astype(np.float32)
    got = gram_kernels.stack_masks(torch.from_numpy(masks))
    want = gram_pallas.stack_masks(jnp.asarray(masks))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (3, 2, 20)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32)[..., :20])
    assert gram_kernels.MIN_PX == 50000
