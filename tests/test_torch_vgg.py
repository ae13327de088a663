"""Port parity: the VGG-16 trunk, its weights and loaders, against the JAX
package on the CPU.

Tolerances: float32 against JAX ``Precision.HIGHEST`` — 1e-4 of each
activation's largest value (differently ordered float32 sums through up to
16 convolutions). bf16: both packages round every activation to bf16 but
their convolutions accumulate in different orders, so a value can land one
bf16 rounding apart and the difference compounds through the trunk; 5e-2 of
each activation's largest value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylemesh_tpu.models import vgg as jvgg
from stylemesh_tpu_torch.convert import vgg_params_from_jax
from stylemesh_tpu_torch.models import vgg as tvgg

RNG = np.random.default_rng(29)
ALL = list(jvgg.VGG_LAYER_CHANNELS)


def _params(seed=3):
    jp = jvgg.init_vgg_params(rng=seed, he=True)
    return jp, tvgg.init_vgg_params(rng=seed, he=True, device="cpu")


def _image(h=36, w=44):
    return ((RNG.random((2, h, w, 3), dtype=np.float32) - 0.45) * 255.0)


def test_init_vgg_params_matches_jax():
    for he in (False, True):
        jp = jvgg.init_vgg_params(rng=7, he=he)
        tp = tvgg.init_vgg_params(rng=7, he=he, device="cpu")
        for name, cin, cout in jvgg.VGG_CONVS:
            w = tp[name]["weight"].numpy()
            assert w.shape == (cout, cin, 3, 3)
            np.testing.assert_array_equal(
                w.transpose(2, 3, 1, 0), np.asarray(jp[name]["kernel"]))
            np.testing.assert_array_equal(tp[name]["bias"].numpy(),
                                          np.asarray(jp[name]["bias"]))
    assert tvgg.VGG_LAYER_CHANNELS == jvgg.VGG_LAYER_CHANNELS
    assert tvgg.VGG_CONVS == jvgg.VGG_CONVS


def test_loaders(tmp_path):
    jp = jvgg.init_vgg_params(rng=11)
    path = tmp_path / "vgg.npz"
    jvgg.save_vgg_params(jp, str(path))
    from_npz = tvgg.load_vgg_params(str(path), device="cpu")
    state_dict = {}
    for name, _, _ in jvgg.VGG_CONVS:
        state_dict[f"{name}.weight"] = torch.from_numpy(
            np.asarray(jp[name]["kernel"]).transpose(3, 2, 0, 1).copy())
        state_dict[f"{name}.bias"] = torch.from_numpy(np.array(jp[name]["bias"]))
    from_sd = tvgg.convert_torch_state_dict(state_dict, device="cpu")
    from_jax = vgg_params_from_jax(
        {k: {n: np.asarray(a) for n, a in v.items()} for k, v in jp.items()},
        device="cpu")
    jsd = jvgg.convert_torch_state_dict(
        {k: v.numpy() for k, v in state_dict.items()})
    for name, _, _ in jvgg.VGG_CONVS:
        for p in (from_sd, from_jax):
            for key in ("weight", "bias"):
                np.testing.assert_array_equal(p[name][key].numpy(),
                                              from_npz[name][key].numpy())
        np.testing.assert_array_equal(
            from_npz[name]["weight"].numpy().transpose(2, 3, 1, 0),
            np.asarray(jsd[name]["kernel"]))


@pytest.mark.parametrize("dtype,rel", [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_all_activations(dtype, rel):
    jp, tp = _params()
    x = _image()
    if dtype == "float32":
        want = jvgg.vgg_features(jp, jnp.asarray(x), ALL,
                                 precision=jax.lax.Precision.HIGHEST)
        got = tvgg.vgg_features(tp, torch.from_numpy(x), ALL)
    else:
        want = jvgg.vgg_features(jp, jnp.asarray(x), ALL,
                                 compute_dtype=jnp.bfloat16,
                                 precision=jax.lax.Precision.DEFAULT)
        got = tvgg.vgg_features(tp, torch.from_numpy(x), ALL,
                                compute_dtype=torch.bfloat16,
                                precision="default")
    for name in ALL:
        g = got[name]
        w = np.asarray(want[name].astype(jnp.float32))
        assert g.dtype == getattr(torch, dtype), name
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=rel * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("pool", ["max", "avg"])
def test_input_gradient(pool):
    """The frozen-VGG backward (flipped-kernel convolution, relu mask from
    the output, first-max pool routing) against JAX's VJP, float32."""
    jp, tp = _params()
    x = _image(24, 28)
    keys = ["r12", "r22", "r31"]
    cts = {k: RNG.normal(size=(2, 24 >> i, 28 >> i, c)).astype(np.float32)
           for i, (k, c) in enumerate(zip(keys, (64, 128, 256)))}

    def jloss(xx):
        out = jvgg.vgg_features(jp, xx, keys, pool=pool,
                                precision=jax.lax.Precision.HIGHEST)
        return sum(jnp.sum(out[k] * cts[k]) for k in keys)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    out = tvgg.vgg_features(tp, xt, keys, pool=pool)
    loss = sum((out[k] * torch.from_numpy(cts[k])).sum() for k in keys)
    (got,) = torch.autograd.grad(loss, [xt])
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    assert not any(p.requires_grad for c in tp.values() for p in c.values())
