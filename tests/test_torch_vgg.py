"""Port parity: the VGG-16 trunk, its weights and loaders, against the JAX
package on the CPU.

Tolerances: float32 against JAX ``Precision.HIGHEST`` — 1e-4 of each
activation's largest value (differently ordered float32 sums through up to
16 convolutions). bf16: both packages round every activation to bf16 but
their convolutions accumulate in different orders, so a value can land one
bf16 rounding apart and the difference compounds through the trunk; 5e-2 of
each activation's largest value. The bf16 trunk on the port's kernels
against the JAX package's accelerator branch: the same 5e-2, and 1e-1
normwise on its input gradient (see that test).
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


def _jax_accelerator_features(jp, x, keys):
    """The JAX package's accelerator branch of ``vgg_features`` (bf16,
    default precision), composed here because its gates route only on a
    TPU: ``conv3x3_im2col`` for conv1_1, ``_conv3x3_relu_v2`` for the other
    convs and ``_conv_relu_pool_frozen`` for the block tails whose conv
    activation is not requested, all in interpret mode; the other pools
    ``_maxpool2_raw``."""
    from stylemesh_tpu.ops.conv_im2col import conv3x3_im2col

    wanted = set(keys)
    last = max(i for i, (name, _) in enumerate(jvgg._TRUNK) if name in wanted)
    h, outs, skip_pool = x.astype(jnp.bfloat16), {}, False
    for i, (name, conv) in enumerate(jvgg._TRUNK):
        if conv is not None:
            k = jp[conv]["kernel"].astype(jnp.bfloat16)
            b = jp[conv]["bias"]
            if (i + 1 <= last and jvgg._TRUNK[i + 1][1] is None
                    and name not in wanted and h.shape[-1] == k.shape[-1]
                    and h.shape[-1] in (64, 128)):
                h = jvgg._conv_relu_pool_frozen(h, k, b.astype(jnp.float32), True)
                skip_pool = True
                continue
            if h.shape[-1] < 32:
                h = conv3x3_im2col(h, k, b, relu=True)
            else:
                h = jvgg._conv3x3_relu_v2(h, k, b.astype(jnp.float32), True)
        elif skip_pool:
            skip_pool = False
        else:
            h = jvgg._maxpool2_raw(h)
        if name in wanted:
            outs[name] = h
        if i == last:
            break
    return {k: outs[k] for k in keys}


DEFAULT_LAYERS = ["r11", "r21", "r31", "r41", "r51", "r42"]


@pytest.mark.parametrize("keys", [ALL, DEFAULT_LAYERS], ids=["all", "default"])
def test_kernel_trunk_matches_jax_accelerator_branch(keys):
    """The bf16 / default-precision trunk (im2col, K5, and with the default
    layers the fused K6 / K7 / K8 block tails; their plain versions here)
    against the JAX accelerator branch in interpret mode: every activation
    within 5e-2 of its largest value, and the input gradient of a random
    linear function of the activations within 1e-1 normwise. Both sides
    round every activation to bf16 once after float32 sums taken in
    different orders; a rounding that lands on the other side of a relu or
    of a pool's tie moves a gradient entry, and the move compounds through
    the backward of up to 13 convs, so the gradient is compared normwise
    (0.5-5.3% over five input draws)."""
    jp, tp = _params()
    rng = np.random.default_rng(17)
    x = ((rng.random((1, 32, 40, 3), dtype=np.float32) - 0.45) * 255.0)
    xt = torch.from_numpy(x).requires_grad_()
    got = tvgg.vgg_features(tp, xt, keys, compute_dtype=torch.bfloat16,
                            precision="default")
    cts = {k: rng.normal(size=tuple(got[k].shape)).astype(np.float32)
           for k in keys}

    @jax.jit
    def forward_and_grad(t, c):
        out, vjp = jax.vjp(lambda u: _jax_accelerator_features(jp, u, keys), t)
        return out, vjp({k: v.astype(jnp.bfloat16) for k, v in c.items()})[0]

    want, want_grad = forward_and_grad(jnp.asarray(x), cts)
    for name in keys:
        w = np.asarray(want[name].astype(jnp.float32))
        assert got[name].dtype == torch.bfloat16, name
        assert tuple(got[name].shape) == w.shape, name
        np.testing.assert_allclose(got[name].detach().float().numpy(), w,
                                   rtol=0, atol=5e-2 * np.abs(w).max(),
                                   err_msg=name)
    (grad,) = torch.autograd.grad(
        [got[k] for k in keys],
        [xt], [torch.from_numpy(cts[k]).to(torch.bfloat16) for k in keys])
    want_grad = np.asarray(want_grad, np.float32)
    err = (np.linalg.norm(grad.float().numpy() - want_grad)
           / np.linalg.norm(want_grad))
    assert err < 1e-1, err


def test_kernel_layout_matches_jax_kernels():
    """The kernel route's weights, from ``convert.vgg_params_from_jax``,
    equal the JAX package's ``kernel.reshape(9 * Cin, Cout)`` and
    ``flip(kernel, (0, 1)).transpose(0, 1, 3, 2)`` in bf16 bit for bit,
    and are built once per parameter set."""
    jp = jvgg.init_vgg_params(rng=13, he=True)
    tp = vgg_params_from_jax(
        {k: {n: np.asarray(a) for n, a in v.items()} for k, v in jp.items()},
        device="cpu")
    for name, cin, cout in jvgg.VGG_CONVS:
        kernel = jp[name]["kernel"].astype(jnp.bfloat16)
        w9, w9t, bias = tvgg.kernel_layout(tp[name])
        assert w9.dtype == w9t.dtype == torch.bfloat16
        assert bias.dtype == torch.float32
        np.testing.assert_array_equal(
            w9.float().numpy(),
            np.asarray(kernel.reshape(9 * cin, cout).astype(jnp.float32)))
        kt = jnp.flip(kernel, (0, 1)).transpose(0, 1, 3, 2)
        np.testing.assert_array_equal(
            w9t.float().numpy(),
            np.asarray(kt.reshape(9 * cout, cin).astype(jnp.float32)))
        np.testing.assert_array_equal(bias.numpy(), np.asarray(jp[name]["bias"]))
        assert tvgg.kernel_layout(tp[name])[0] is w9


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unfused_trunk_matches_jax(monkeypatch, dtype):
    """``STYLEMESH_CONV_FLIPVJP=0 STYLEMESH_FAST_CONV=1``, read at call time
    by both packages: every conv ``relu(conv + b)`` with autograd's relu,
    plain pools; in bf16 every conv with Cin >= 64 on K9 (the JAX package
    runs ``conv3x3_frozen`` in interpret mode on the CPU by itself) and
    conv1_1 on the library conv. Against JAX ``vgg_features`` under the same
    settings: float32 1e-4 of each activation's largest value and of the
    input gradient's; bf16 5e-2 of each activation's largest value and 1e-1
    normwise on the input gradient (the bounds of the kernel-trunk test
    above, for the same reasons)."""
    monkeypatch.setenv("STYLEMESH_CONV_FLIPVJP", "0")
    monkeypatch.setenv("STYLEMESH_FAST_CONV", "1")
    bf16 = dtype == "bfloat16"
    jp, tp = _params()
    rng = np.random.default_rng(41)
    x = ((rng.random((1, 24, 32, 3), dtype=np.float32) - 0.45) * 255.0)
    keys = DEFAULT_LAYERS
    xt = torch.from_numpy(x).requires_grad_()
    got = tvgg.vgg_features(tp, xt, keys,
                            compute_dtype=torch.bfloat16 if bf16 else None,
                            precision="default" if bf16 else "highest")
    cts = {k: rng.normal(size=tuple(got[k].shape)).astype(np.float32)
           for k in keys}

    def jfeatures(u):
        return jvgg.vgg_features(
            jp, u, keys, compute_dtype=jnp.bfloat16 if bf16 else None,
            precision=(jax.lax.Precision.DEFAULT if bf16
                       else jax.lax.Precision.HIGHEST))

    want, vjp = jax.vjp(jfeatures, jnp.asarray(x))
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    (want_grad,) = vjp({k: jnp.asarray(v, jdt) for k, v in cts.items()})
    rel = 5e-2 if bf16 else 1e-4
    for name in keys:
        w = np.asarray(want[name].astype(jnp.float32))
        assert got[name].dtype == getattr(torch, dtype), name
        np.testing.assert_allclose(got[name].detach().float().numpy(), w,
                                   rtol=0, atol=rel * np.abs(w).max(),
                                   err_msg=name)
    (grad,) = torch.autograd.grad(
        [got[k] for k in keys], [xt],
        [torch.from_numpy(cts[k]).to(got[k].dtype) for k in keys])
    want_grad = np.asarray(want_grad, np.float32)
    grad = grad.float().numpy()
    if bf16:
        err = np.linalg.norm(grad - want_grad) / np.linalg.norm(want_grad)
        assert err < 1e-1, err
    else:
        np.testing.assert_allclose(grad, want_grad, rtol=0,
                                   atol=1e-4 * np.abs(want_grad).max())


def test_unfused_trunk_routes(monkeypatch):
    """Which convs take K9: with both variables set, every bf16 conv but
    conv1_1; without ``STYLEMESH_FAST_CONV``, none; the variables are read
    at each call, and unset they leave the default kernel trunk."""
    _, tp = _params()
    x = torch.from_numpy(_image(16, 20))
    calls = []
    real = tvgg.conv_kernels._ConvFrozen.apply
    monkeypatch.setattr(tvgg.conv_kernels._ConvFrozen, "apply",
                        lambda *a: calls.append(a[0].shape[-1]) or real(*a))
    kw = dict(compute_dtype=torch.bfloat16, precision="default")
    monkeypatch.setenv("STYLEMESH_CONV_FLIPVJP", "0")
    monkeypatch.setenv("STYLEMESH_FAST_CONV", "1")
    tvgg.vgg_features(tp, x, ["r51"], **kw)
    # conv1_2 .. conv5_1 by input width
    assert calls == [64, 64, 128, 128, 256, 256, 256, 256, 512, 512, 512, 512]
    calls.clear()
    tvgg.vgg_features(tp, x, ["r51"])  # float32: no K9
    monkeypatch.setenv("STYLEMESH_FAST_CONV", "0")
    tvgg.vgg_features(tp, x, ["r51"], **kw)
    monkeypatch.delenv("STYLEMESH_CONV_FLIPVJP")
    monkeypatch.delenv("STYLEMESH_FAST_CONV")
    default = tvgg.vgg_features(tp, x, ["r51"], **kw)
    assert calls == []
    monkeypatch.setattr(tvgg, "_unfused_trunk", None)  # never reached
    again = tvgg.vgg_features(tp, x, ["r51"], **kw)
    assert torch.equal(default["r51"], again["r51"])


class _PerLayerConvReLU(torch.autograd.Function):
    """The trunk's conv before its input gradients finished their input's
    cotangent: the relu mask as its own pass, then K5 (a copy)."""

    @staticmethod
    def forward(ctx, x, w9, w9_flipped, bias):
        y = tvgg.conv_kernels.conv3x3(x, w9, bias, relu=True)
        ctx.save_for_backward(y, w9_flipped)
        return y

    @staticmethod
    def backward(ctx, g):
        y, w9_flipped = ctx.saved_tensors
        g = torch.where(y > 0, g, torch.zeros((), dtype=g.dtype))
        g = g.to(torch.bfloat16).contiguous()
        return tvgg.conv_kernels.conv3x3(g, w9_flipped), None, None, None


class _PerLayerConvReLUPool(torch.autograd.Function):
    """The fused block tail before K5 / K8 took the tap's cotangent (a
    copy): K8 at 64 channels, pool routing then K5 at 128."""

    @staticmethod
    def forward(ctx, x, w9, w9_flipped, bias):
        ctx.fused_backward = x.shape[-1] == 64
        if ctx.fused_backward:
            pooled, codes = tvgg.head_kernels.conv_relu_pool(
                x, w9, bias, with_codes=True)
            ctx.save_for_backward(codes, w9_flipped)
            ctx.hw = tuple(x.shape[1:3])
            return pooled
        pooled, pre = tvgg.head_kernels.conv_relu_pool(x, w9, bias, with_pre=True)
        ctx.save_for_backward(pre, w9_flipped)
        return pooled

    @staticmethod
    def backward(ctx, g):
        g = g.to(torch.bfloat16).contiguous()
        if ctx.fused_backward:
            codes, w9_flipped = ctx.saved_tensors
            dx = tvgg.head_kernels.conv_relu_pool_bwd(codes, g, w9_flipped,
                                                      ctx.hw)
        else:
            pre, w9_flipped = ctx.saved_tensors
            dx = tvgg.conv_kernels.conv3x3(
                tvgg.head_kernels.pool_route(pre, g), w9_flipped)
        return dx, None, None, None


def _per_layer_trunk(params, x, keys):
    """The kernel trunk as each layer's backward composed it before: every
    conv's own relu mask, autograd's sum where a relu output is both a tap
    and the next conv's input."""
    wanted = set(keys)
    last = max(i for i, (name, _) in enumerate(tvgg._TRUNK) if name in wanted)
    outs, h, skip_pool = {}, x, False
    for i, (name, conv) in enumerate(tvgg._TRUNK[:last + 1]):
        if conv is not None:
            w9, w9t, bias = tvgg.kernel_layout(params[conv])
            if (i + 1 <= last and tvgg._TRUNK[i + 1][1] is None
                    and tvgg._fused_pool_wanted(h.shape, w9.shape[1], "max",
                                                name in wanted)):
                h = _PerLayerConvReLUPool.apply(h, w9, w9t, bias)
                skip_pool = True
                continue
            if h.shape[-1] < tvgg.conv_kernels.CIN_STEP:
                h = tvgg.conv3x3_im2col(h, w9, bias, relu=True)
            else:
                h = _PerLayerConvReLU.apply(h, w9, w9t, bias)
        elif skip_pool:
            skip_pool = False
        else:
            h = tvgg._pool_nhwc(h, "max")
        if name in wanted:
            outs[name] = h
    return outs


@pytest.mark.parametrize("keys,epilogues,masks", [
    (DEFAULT_LAYERS, 8, 3),
    (ALL, 11, 5),
    (["r12", "r22", "r31", "r42"], 6, 4),
    (["r11", "r21", "r31", "r43"], 7, 2),
], ids=["default", "all", "r12_r22", "to_r43"])
def test_kernel_trunk_finishes_cotangents_as_per_layer(keys, epilogues, masks,
                                                       monkeypatch):
    """The kernel trunk's input gradients finish their input's cotangent
    (the relu mask and the tap's cotangent in K5's or K8's epilogue; their
    plain versions here): the activations and the input gradient of a
    random linear function of them equal, bit for bit, the trunk in which
    each conv masks its own cotangent and autograd sums a tap's with the
    next conv's. Counted: input gradients that finish their input's
    cotangent, and relu masks left as their own pass."""
    _, tp = _params()
    rng = np.random.default_rng(23)
    x = torch.from_numpy(
        ((rng.random((2, 32, 40, 3), dtype=np.float32) - 0.45) * 255.0))
    xb = x.to(torch.bfloat16)
    want_in = xb.clone().requires_grad_()
    want = _per_layer_trunk(tp, want_in, keys)
    cts = [torch.from_numpy(rng.normal(size=tuple(want[k].shape)).astype(
        np.float32)).to(torch.bfloat16) for k in keys]
    (want_grad,) = torch.autograd.grad([want[k] for k in keys], [want_in], cts)

    calls = {"epilogues": 0, "masks": 0}
    masked, k8, mask = (tvgg.conv_kernels.conv3x3_masked,
                        tvgg.head_kernels.conv_relu_pool_bwd, tvgg.relu_mask)

    def masked_spy(*a, **kw):
        calls["epilogues"] += 1
        return masked(*a, **kw)

    def k8_spy(codes, g, w9_flipped, hw, tap=None):
        calls["epilogues"] += tap is not None
        return k8(codes, g, w9_flipped, hw, tap)

    def mask_spy(g, y):
        calls["masks"] += 1
        return mask(g, y)

    monkeypatch.setattr(tvgg.conv_kernels, "conv3x3_masked", masked_spy)
    monkeypatch.setattr(tvgg.head_kernels, "conv_relu_pool_bwd", k8_spy)
    monkeypatch.setattr(tvgg, "relu_mask", mask_spy)
    got_in = xb.clone().requires_grad_()
    got = tvgg.vgg_features(tp, got_in, keys, compute_dtype=torch.bfloat16,
                            precision="default")
    (got_grad,) = torch.autograd.grad([got[k] for k in keys], [got_in], cts)
    for k in keys:
        assert torch.equal(got[k], want[k]), k
    assert got_grad.abs().max() > 0
    assert torch.equal(got_grad, want_grad)
    assert calls == {"epilogues": epilogues, "masks": masks}
