"""Port parity: ``ContentAndStyleLoss`` (single and multi style pyramid),
values and gradients with respect to the prediction pyramid, against the
JAX package on the CPU.

Tolerances: float32 against JAX ``Precision.HIGHEST`` — 1e-4 relative on
the losses and 1e-3 of the largest gradient entry (float32 sums in another
order through the VGG and its backward). bf16 with the fused-Gram routing
on in both packages — 2e-2 relative on the losses and the Gram targets, and
1e-1 normwise relative on the gradients: the VGG activations are rounded to
bf16 at every layer in both packages after differently ordered sums, a
rounding can flip a relu or a pool's argmax, and within either package the
bf16 gradient of this test already differs from its float32 gradient by
10-16% normwise. In bf16 the JAX side runs the accelerator branch of its
VGG trunk (Pallas kernels in interpret mode, composed in
``test_torch_vgg.py``): the port's bf16 trunk computes that branch's
numerics (float32 bias added before the one bf16 rounding), not those of
the JAX package's CPU path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylemesh_tpu.data.synthetic import synthetic_view_batch
from stylemesh_tpu.models import losses as jlosses
from stylemesh_tpu.models import vgg as jvgg
from stylemesh_tpu.models.pipeline import depth_pyramid_masks
from stylemesh_tpu.ops import gram_pallas
from stylemesh_tpu_torch.models import losses as tlosses
from stylemesh_tpu_torch.models import vgg as tvgg
from stylemesh_tpu_torch.ops import gram_kernels
from test_torch_vgg import _jax_accelerator_features

LEVELS = ((24, 32), (36, 48))


def _setup():
    rng = np.random.default_rng(31)
    batch = synthetic_view_batch(num_views=2, content_hw=(24, 32),
                                 level_heights=(24, 36), seed=2,
                                 depth_range=(0.15, 0.35))
    masks = [np.array(m) for m in depth_pyramid_masks(batch, LEVELS)]
    assert all(m.sum() > 0 for m in masks)
    preds = [((rng.random((2,) + hw + (3,), dtype=np.float32) - 0.45) * 255.0)
             for hw in LEVELS]
    style = (rng.random((1, 48, 64, 3), dtype=np.float32) - 0.45) * 255.0
    return (preds, np.array(batch.rgb), masks,
            np.array(batch.angle_degrees), style)


def _run(mode, bf16):
    preds, rgb, masks, angles, style = _setup()
    # four style layers reach the multi mode's smaller-style term (li > 2)
    # and stop the trunk at r42
    kw = dict(style_pyramid_mode=mode, angle_threshold=30.0, style_min_size=16,
              style_layers=("r11", "r21", "r31", "r41"),
              style_weights=tuple(1e3 / n ** 2 for n in (64, 128, 256, 512)))
    jloss = jlosses.ContentAndStyleLoss(
        remat=False,
        compute_dtype=jnp.bfloat16 if bf16 else None,
        precision=jax.lax.Precision.DEFAULT if bf16 else jax.lax.Precision.HIGHEST,
        **kw)
    tloss = tlosses.ContentAndStyleLoss(
        remat=False,
        compute_dtype=torch.bfloat16 if bf16 else None,
        precision="default" if bf16 else "highest", **kw)
    jp = jvgg.init_vgg_params(rng=5, he=True)
    tp = tvgg.init_vgg_params(rng=5, he=True, device="cpu")

    jtargets = jloss.set_style_image(jp, jnp.asarray(style))
    ttargets = tloss.set_style_image(tp, torch.from_numpy(style))

    def jfn(ps):
        s, c, _ = jloss(jp, jtargets, ps, jnp.asarray(rgb),
                        [jnp.asarray(m) for m in masks], jnp.asarray(angles))
        return s + 1e-3 * c, (s, c)

    jgrads, (js, jc) = jax.jit(jax.grad(jfn, has_aux=True))(
        [jnp.asarray(p) for p in preds])
    tps = [torch.from_numpy(p).requires_grad_() for p in preds]
    tmasks = [torch.from_numpy(m) for m in masks]
    aux = tloss.precompute_aux(tp, LEVELS, torch.from_numpy(rgb), tmasks,
                               torch.from_numpy(angles))
    ts, tc, _ = tloss(tp, ttargets, tps, torch.from_numpy(rgb), tmasks,
                      torch.from_numpy(angles), aux=aux)
    tgrads = torch.autograd.grad(ts + 1e-3 * tc, tps)
    return dict(jtargets=jtargets, ttargets=ttargets, j=(js, jc), t=(ts, tc),
                jgrads=jgrads, tgrads=tgrads, aux=aux)


def _check(r, loss_rel, grad_rel, target_rel, normwise=False):
    for k, jg in r["jtargets"].grams.items():
        jg = np.asarray(jg)
        np.testing.assert_allclose(r["ttargets"].grams[k].numpy(), jg, rtol=0,
                                   atol=target_rel * np.abs(jg).max(), err_msg=k)
    for tv, jv in zip(r["t"], r["j"]):
        np.testing.assert_allclose(tv.item(), float(jv), rtol=loss_rel)
    for tg, jg in zip(r["tgrads"], r["jgrads"]):
        jg = np.asarray(jg)
        assert np.abs(jg).max() > 0
        if normwise:
            err = np.linalg.norm(tg.numpy() - jg) / np.linalg.norm(jg)
            assert err < grad_rel, err
        else:
            np.testing.assert_allclose(tg.numpy(), jg, rtol=0,
                                       atol=grad_rel * np.abs(jg).max())


@pytest.mark.parametrize("mode", ["single", "multi"])
def test_loss_float32(mode):
    r = _run(mode, bf16=False)
    assert not any(r["aux"]["gram_masks"])  # float32 stays on the plain Gram
    _check(r, 1e-4, 1e-3, 1e-4)


@pytest.mark.parametrize("mode", ["single", "multi"])
def test_loss_bf16_fused_gram_routing(mode, monkeypatch):
    """Layers of >= MIN_PX pixels go to the fused Gram in both packages:
    the Pallas kernel in interpret mode in JAX, the K3/K4 plain versions
    here. MIN_PX is lowered so that the small test layers qualify. The JAX
    loss encodes with its accelerator-branch trunk, as the port does."""
    monkeypatch.setattr(jlosses, "vgg_features",
                        lambda params, x, keys, **kw: _jax_accelerator_features(
                            params, x, list(keys)))
    monkeypatch.setattr(gram_pallas, "MIN_PX", 100)
    monkeypatch.setattr(gram_kernels, "MIN_PX", 100)
    r = _run(mode, bf16=True)
    fused = r["aux"]["gram_masks"]
    assert set(fused[0]) == {"r11", "r21"} and set(fused[1]) == {"r11", "r21", "r31"}
    assert all(m.shape[1] == (2 if mode == "multi" else 1)
               for level in fused for m in level.values())
    _check(r, 2e-2, 1e-1, 2e-2, normwise=True)
