"""The StyleMesh training step in plain PyTorch (float32, TF32 off), on
``[N, C, H, W]`` tensors: render, VGG-19 trunk, masked Grams, content and
style losses with the angle split and the depth pyramid, the gradient
weights, the texture regularizer, Adam and the clamp.

A view's losses and gradient are computed one view at a time (the step's
loss is the mean over its views, so their gradients add), which bounds the
memory to one view's graph.
"""

import contextlib

import torch
import torch.nn.functional as F

VGG_CONVS = [
    ("conv1_1", 3, 64), ("conv1_2", 64, 64),
    ("conv2_1", 64, 128), ("conv2_2", 128, 128),
    ("conv3_1", 128, 256), ("conv3_2", 256, 256), ("conv3_3", 256, 256),
    ("conv3_4", 256, 256),
    ("conv4_1", 256, 512), ("conv4_2", 512, 512), ("conv4_3", 512, 512),
    ("conv4_4", 512, 512),
    ("conv5_1", 512, 512), ("conv5_2", 512, 512), ("conv5_3", 512, 512),
    ("conv5_4", 512, 512),
]
TRUNK = [
    ("r11", "conv1_1"), ("r12", "conv1_2"), ("p1", None),
    ("r21", "conv2_1"), ("r22", "conv2_2"), ("p2", None),
    ("r31", "conv3_1"), ("r32", "conv3_2"), ("r33", "conv3_3"),
    ("r34", "conv3_4"), ("p3", None),
    ("r41", "conv4_1"), ("r42", "conv4_2"), ("r43", "conv4_3"),
    ("r44", "conv4_4"), ("p4", None),
    ("r51", "conv5_1"), ("r52", "conv5_2"), ("r53", "conv5_3"),
    ("r54", "conv5_4"), ("p5", None),
]
GATYS_MIN, GATYS_MAX = -123.6800, 151.0610
GRAM_CACHE_DEPTH = 10
FP8_MAX = 448.0  # largest float8 e4m3 value


def fp8(x):
    """``x`` rounded to float8 e4m3 under a per-tensor scale that maps its
    largest magnitude to the format's largest value."""
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


class _Fp8(torch.autograd.Function):
    """:func:`fp8` on the value and on its gradient."""

    @staticmethod
    def forward(ctx, x):
        return fp8(x)

    @staticmethod
    def backward(ctx, g):
        return fp8(g)


@contextlib.contextmanager
def full_float32():
    """float32 matmuls and convolutions without TF32 for the duration."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved


def nearest(x, hw):
    return x if tuple(x.shape[-2:]) == tuple(hw) else F.interpolate(
        x, size=tuple(hw), mode="nearest")


def bilinear(x, hw):
    return x if tuple(x.shape[-2:]) == tuple(hw) else F.interpolate(
        x, size=tuple(hw), mode="bilinear", align_corners=False)


def erode(x):
    """A 0/1 mask eroded by a 3x3 box (zero padding)."""
    ones = torch.ones((1, 1, 3, 3), dtype=x.dtype, device=x.device)
    resp = torch.clamp(F.conv2d(x, ones, padding=1) / 9.0, 0.0, 1.0)
    return x * (resp == 1.0).to(x.dtype)


def layer_hw(name, hw):
    """The feature resolution of activation ``name`` for an ``hw`` input."""
    pools = int(name[1]) - 1
    return (hw[0] // 2 ** pools, hw[1] // 2 ** pools)


def level_masks(b, shapes, use_depth_scaling):
    """Per level ``[V, 1, h, w]`` 0/1 loss masks: the pixels whose nearest
    or second-nearest depth level is the level, eroded, inside the mask;
    without depth scaling the last level alone, with the whole mask."""
    out = []
    for i, hw in enumerate(shapes):
        if use_depth_scaling:
            m = erode(((b["rounded"] == i).float() + (b["other"] == i).float())
                      * b["mask"])
        elif i == len(shapes) - 1:
            m = b["mask"]
        else:
            m = torch.zeros_like(b["mask"])
        out.append((nearest(m, hw) > 0).float())
    return out


def grad_weights(b, shapes, use_angle_weight, use_depth_scaling):
    """Per level ``[V, 1, h, w]`` gradient weights (the upstream's backward
    hooks), or None when neither is on."""
    if not (use_angle_weight or use_depth_scaling):
        return None
    out = []
    for i, hw in enumerate(shapes):
        w = torch.ones((), device=b["mask"].device)
        if use_angle_weight:
            w = bilinear(b["angle_guidance"], hw)
        if use_depth_scaling:
            m1 = erode((b["rounded"] == i).float() * b["mask"])
            m2 = erode((b["other"] == i).float() * b["mask"])
            w = w * nearest(m1 * b["weight"] + m2 * (1.0 - b["weight"]), hw)
        out.append(w)
    return out


def gram(f, m=None):
    """``[C, h, w]`` features -> ``[C, C]`` Gram over the pixels of the 0/1
    mask ``m`` ``[h, w]`` (all pixels without one), divided by their
    count; zeros for an empty mask."""
    c = f.shape[0]
    f = f.reshape(c, -1)
    if m is None:
        return f @ f.t() / f.shape[1]
    m = m.reshape(1, -1)
    fm = f * m
    return fm @ fm.t() / torch.clamp(m.sum(), min=1.0)


def mse(a, b):
    return ((a - b) ** 2).mean()


def masked_mse(a, b, m):
    """MSE over the ``C * n`` elements of the ``n`` masked pixels."""
    d = ((a - b) ** 2 * m).sum()
    n = m.sum() * a.shape[0]
    return torch.where(n > 0, d / torch.clamp(n, min=1.0), torch.zeros_like(d))


def image_pyramid(img, levels, minimum_size):
    """The upstream's reversed style pyramid of ``img`` ``[1, 3, H, W]``."""
    h, w = img.shape[-2:]
    pyramid, min_entry, min_index = [], None, len(levels)
    for i, level in enumerate(levels):
        if level == 0:
            pyramid.append(img)
            continue
        hd, wd = int(h / 2 ** level), int(w / 2 ** level)
        if hd < minimum_size or wd < minimum_size:
            if min_entry is None:
                if w > h:
                    size = (minimum_size, int(w * minimum_size / h))
                else:
                    size = (int(h * minimum_size / w), minimum_size)
                min_entry = bilinear(img, size)
                min_index = i
            pyramid.append(min_entry)
        else:
            pyramid.append(bilinear(img, (hd, wd)))
    rev = pyramid[:min_index + 1][::-1]
    while len(rev) < len(pyramid):
        rev.append(img)
    return rev


class Reference:
    """One cell's training run in plain PyTorch.

    Args:
        cfg: the configuration file's ``pipeline`` block, with
            ``steps_per_epoch``, ``skip_levels`` and ``stop_grad_levels`` as
            the run resolved them.
        adam: ``{"b1", "b2", "eps"}``.
        vgg: ``{conv: {"weight": OIHW, "bias": [C]}}`` float32.
        style: ``[1, H, W, 3]`` Gatys style image (numpy).
        quant: None, or ``"fp8"`` for the control.
    """

    def __init__(self, cfg, adam, vgg, style, device, quant=None):
        if quant not in (None, "fp8"):
            raise ValueError(f"quant {quant!r}")
        self.cfg = cfg
        self.adam = adam
        self.device = torch.device(device)
        self.q = _Fp8.apply if quant else (lambda x: x)
        self.vgg = {n: (self.q(p["weight"].to(self.device, torch.float32)),
                        p["bias"].to(self.device, torch.float32))
                    for n, p in vgg.items()}
        self.style_layers = list(cfg["style_layers"])
        self.content_layers = list(cfg["content_layers"])
        with torch.no_grad(), full_float32():
            img = torch.as_tensor(style, device=self.device).permute(0, 3, 1, 2)
            pyr = image_pyramid(img.float(), list(range(cfg["num_style_levels"])),
                                cfg["style_min_size"])
            encs = [self.features(p, self.style_layers) for p in pyr]
            self.targets = {k: [gram(e[k][0]) for e in encs]
                            for k in self.style_layers}
        self.layers = None
        self.gram_cache = {k: [] for k in self.style_layers}

    # ---------------------------------------------------------- model

    def features(self, x, keys):
        """The requested VGG activations of ``x`` ``[N, 3, H, W]``."""
        keys = set(keys)
        last = max(i for i, (n, _) in enumerate(TRUNK) if n in keys)
        outs = {}
        h = self.q(x)
        for i, (name, conv) in enumerate(TRUNK[:last + 1]):
            if conv is None:
                h = F.max_pool2d(h, 2)
            else:
                w, b = self.vgg[conv]
                h = self.q(F.relu(F.conv2d(h, w, b, padding=1)))
            if name in keys:
                outs[name] = h
        return outs

    def init(self):
        """Zero texture layers (clamped) and zero Adam moments."""
        c = self.cfg
        n = c["hierarchical_layers"]
        self.layers = [torch.zeros((c["texture_height"] // 2 ** i,
                                    c["texture_width"] // 2 ** i, 3),
                                   device=self.device).clamp_(GATYS_MIN, GATYS_MAX)
                       for i in range(n)]
        self.mu = [torch.zeros_like(l) for l in self.layers]
        self.nu = [torch.zeros_like(l) for l in self.layers]
        self.count = 0

    def batch(self, views):
        """The arrays of ``reference.data.load_views`` as ``[V, C, H, W]``
        tensors on the device (the UV grids stay ``[V, h, w, 2]``)."""
        b = {k: torch.as_tensor(v, device=self.device).permute(0, 3, 1, 2)
             for k, v in views.items() if k != "uv"}
        b["uv"] = [torch.as_tensor(u, device=self.device) for u in views["uv"]]
        return b

    def learning_rate(self):
        c = self.cfg
        decay_every = c["decay_step_size"] * c["steps_per_epoch"]
        return c["learning_rate"] * c["decay_gamma"] ** (self.count // decay_every)

    # ---------------------------------------------------------- step

    def step(self, views):
        """One step on ``views``: the loss terms (floats) and the
        gradient of every layer as Adam receives it."""
        c = self.cfg
        with full_float32():
            b = self.batch(views)
            v = b["rgb"].shape[0]
            shapes = [tuple(u.shape[1:3]) for u in b["uv"]]
            live = [i for i in range(len(shapes)) if i not in c["skip_levels"]]
            with torch.no_grad():
                masks = level_masks(b, shapes, c["use_depth_scaling"])
                weights = grad_weights(b, shapes, c["use_angle_weight"],
                                       c["use_depth_scaling"])
                content = self.features(b["rgb"], self.content_layers)
            params = [l.clone().requires_grad_(True) for l in self.layers]
            sums = {"content": 0.0, "style": 0.0}
            for vi in range(v):
                cl, sl = self._view_loss(params, b, vi, shapes, live, masks,
                                         weights, content)
                ((c["content_weight"] * cl + c["style_weight"] * sl) / v).backward()
                sums["content"] += float(cl.detach()) / v
                sums["style"] += float(sl.detach()) / v
            reg = torch.zeros((), device=self.device)
            if c["tex_reg_weight"] > 0:
                reg = sum(torch.mean(p ** 2) * w for p, w in
                          zip(params, self.tex_reg_weights()))
                (c["tex_reg_weight"] * reg).backward()
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in params]
            self._adam(grads)
        losses = {"content": c["content_weight"] * sums["content"],
                  "style": c["style_weight"] * sums["style"],
                  "tex_reg": c["tex_reg_weight"] * float(reg.detach())}
        losses["total"] = losses["content"] + losses["style"] + losses["tex_reg"]
        return losses, grads

    def content_targets(self, views):
        """The content targets of ``views`` (``reference.data.load_views``)
        as :meth:`step`'s loss takes them: ``{(level, layer): [V, h, w,
        C]}`` for each live level and content layer."""
        c = self.cfg
        out = {}
        with torch.no_grad(), full_float32():
            b = self.batch(views)
            content = self.features(b["rgb"], self.content_layers)
            for i, u in enumerate(b["uv"]):
                if i in c["skip_levels"]:
                    continue
                for k in self.content_layers:
                    fhw = layer_hw(k, tuple(u.shape[1:3]))
                    out[(i, k)] = torch.cat([
                        self.q(bilinear(content[k][v:v + 1], fhw))
                        for v in range(content[k].shape[0])]).permute(
                            0, 2, 3, 1)
        return out

    def tex_reg_weights(self):
        c = self.cfg
        if c["tex_reg_weights"] is not None:
            return list(c["tex_reg_weights"])
        n = c["hierarchical_layers"]
        return [2.0 ** (n - i - 1) if i < n - 1 else 0.0 for i in range(n)]

    @torch.no_grad()
    def _adam(self, grads):
        b1, b2, eps = self.adam["b1"], self.adam["b2"], self.adam["eps"]
        lr = self.learning_rate()
        t = self.count + 1
        for p, g, mu, nu in zip(self.layers, grads, self.mu, self.nu):
            mu.mul_(b1).add_(g, alpha=1.0 - b1)
            nu.mul_(b2).add_(g * g, alpha=1.0 - b2)
            p.sub_(lr * (mu / (1.0 - b1 ** t))
                   / ((nu / (1.0 - b2 ** t)).sqrt() + eps))
            p.clamp_(GATYS_MIN, GATYS_MAX)
        self.count = t

    def _render(self, params, uv):
        """The layers sampled at ``uv`` ``[1, h, w, 2]`` and summed."""
        return sum(F.grid_sample(p.permute(2, 0, 1)[None], uv, mode="bilinear",
                                 padding_mode="border", align_corners=True)
                   for p in params)

    def _view_loss(self, params, b, vi, shapes, live, masks, weights, content):
        """View ``vi``'s (content, style) losses, before their weights."""
        c = self.cfg
        multi = c["style_pyramid_mode"] == "multi"
        average = c["gram_mode"] == "average"
        layers = self.style_layers + self.content_layers
        sl = slice(vi, vi + 1)
        encs, lm = {}, {}
        for i in live:
            p = self._render(params, b["uv"][i][sl])
            if i in c["stop_grad_levels"]:
                p = p.detach()
            elif weights is not None:
                p.register_hook(lambda g, w=weights[i][sl]: g * w)
            encs[i] = self.features(p, layers)
        # masks and level factors at each layer's resolution
        with torch.no_grad():
            for i in live:
                mask = masks[i][sl]
                passed = (bilinear(b["angle_degrees"][sl], shapes[i])
                          < c["angle_threshold"]).float()
                lm[i] = {}
                for k in layers:
                    fhw = layer_hw(k, shapes[i])
                    lm[i][k] = (nearest(mask, fhw)[0, 0],
                                nearest(mask * passed, fhw)[0, 0],
                                nearest(mask * (1.0 - passed), fhw)[0, 0])
            factors = {}
            for k in layers:
                f = {i: lm[i][k][0].mean() for i in live}
                total = sum(f.values())
                factors[k] = {i: torch.where(total > 0, f[i] / torch.where(
                    total > 0, total, torch.ones_like(total)),
                    torch.zeros_like(total)) for i in live}
        style = torch.zeros((), device=self.device)
        content_loss = torch.zeros((), device=self.device)
        for i in live:
            nonempty = bool(masks[i][sl].sum() > 0)
            mixed = {}
            for li, k in enumerate(self.style_layers):
                m, mp, mf = lm[i][k]
                feat = encs[i][k][0]
                y_hat = gram(feat, mp if multi else m)
                if average:
                    hist = self.gram_cache[k][:GRAM_CACHE_DEPTH - 1]
                    mixed[k] = y_hat
                    y_hat = (y_hat + sum(hist)) / (len(hist) + 1)
                w, f = c["style_weights"][li], factors[k][i]
                y = self.targets[k][2 if multi else 0]
                l = w * f * mse(y, y_hat)
                if multi:
                    if mf.sum() > 0:
                        l = l + w * f * mse(y, gram(feat, mf))
                    if li > 2:
                        l = l + w * f * mse(self.targets[k][0], y_hat)
                style = style + l
            if average and nonempty:
                for k, g in mixed.items():
                    self.gram_cache[k] = ([g.detach()] + self.gram_cache[k])[
                        :GRAM_CACHE_DEPTH]
            for li, k in enumerate(self.content_layers):
                m = lm[i][k][0]
                fhw = m.shape
                target = self.q(bilinear(content[k][sl], fhw))[0]
                content_loss = content_loss + (
                    c["content_weights"][li] * factors[k][i]
                    * masked_mse(target, encs[i][k][0], m))
        return content_loss, style
