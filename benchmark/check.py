"""The comparison that decides ``correct``: the program's first steps of the
run against the plain reference's (``reference/``) on the same scene files,
VGG weights and style image.

Three numbers are compared, each with the cell's limit
(``limits/<cell>.json``):

- ``loss_gap``: the largest relative gap of a loss term (content, style,
  total) over the first three steps. The regularizer's own term is left
  out: after two Adam steps it hangs on the signs of gradient elements that
  are nought to rounding, which move their texels by a whole step either
  way; the texture it is a function of is compared by ``change_gap``;
- ``change_gap``: each texture layer's change over the three steps: the
  largest gap between the program's and the reference's norm of it, over
  the larger of the reference's norm of that layer and of the median layer;
- ``content_gap``: the content targets that the program's
  ``prepare_batch`` encoded for the chunk of those steps (the VGG trunk on
  the chunk's photos, resized to each live level), against the reference's
  of the same photos: the largest norm of their difference over the norm
  of the reference's, over levels and content layers. Unlike the sums
  above, it is compared element by element, so a lower precision's
  rounding cannot cancel out in it.

``grad_gap``, the same of the first step's gradient as Adam received it
(read from its first moment after one step), is worked out and logged but
not compared: the first step renders the zero texture, so every interior
pixel of a view feeds the VGG trunk the same input, and a channel whose
pre-activation lies near zero switches its relu for the whole image at
once under rounding. Its gap swings from seed to seed by two orders of magnitude.

A layer whose reference gradient norm is under a thousandth of the median
layer's moves by round-off alone and is left out of ``change_gap``.
"""

import statistics

import torch

from benchmark.reference.data import load_style, load_views
from benchmark.reference.step import Reference

LOSS_TERMS = ("content", "style", "total")
NUMBERS = ("loss_gap", "change_gap", "content_gap")  # grad_gap is logged
DEAD_LEAF = 1e-3


def reference_numbers(session, resolved_cfg, quant=None):
    """The reference's numbers over the session's first steps: the same
    structure as ``Session.numbers``, the content targets on the host."""
    cell = session.cell
    ref = Reference(resolved_cfg, cell.config["adam"], session.vgg,
                    load_style(session.style_path), session.device, quant)
    ref.init()
    before = [l.clone() for l in ref.layers]
    losses, grad = [], None
    views = {}
    for chunk in session.first_chunks:
        key = tuple(chunk)
        if key not in views:
            views[key] = load_views(session.scene_dir, chunk, session.levels,
                                    session.run.resize_size,
                                    session.run.min_pyramid_depth)
        step_losses, grads = ref.step(views[key])
        losses.append(step_losses)
        if grad is None:
            grad = [float(g.norm()) for g in grads]
    change = [float((l - b).double().norm())
              for l, b in zip(ref.layers, before)]
    content = {k: t.cpu() for k, t in ref.content_targets(
        views[tuple(session.content_chunk)]).items()}
    del ref
    if session.device.type == "cuda":
        torch.cuda.empty_cache()
    return {"losses": losses, "grad_norms": grad, "change_norms": change,
            "content": content}


def printable(numbers):
    """``numbers`` without the content targets."""
    return {k: v for k, v in numbers.items() if k != "content"}


def _rel(p, r):
    if r == 0:
        return 0.0 if p == 0 else float("inf")
    return abs(p - r) / abs(r)


def gaps(program, reference):
    """``loss_gap``, ``grad_gap``, ``change_gap`` and ``content_gap`` of
    ``program`` against ``reference``."""
    loss = max(_rel(p[k], r[k]) for p, r in zip(program["losses"],
                                                 reference["losses"])
               for k in LOSS_TERMS)
    ref_grad = reference["grad_norms"]
    median = statistics.median(ref_grad)
    counted = [i for i, n in enumerate(ref_grad) if n >= DEAD_LEAF * median]

    def worst(name):
        p, r = program[name], reference[name]
        scale = statistics.median(r)
        return max(abs(p[i] - r[i]) / max(r[i], scale, 1e-30)
                   for i in counted)

    def content_gap(p, r):
        if p.shape != r.shape:
            return float("inf")
        return float((p.double() - r.double()).norm() / r.double().norm())

    p, r = program["content"], reference["content"]
    content = (max(content_gap(p[k], r[k]) for k in r) if set(p) == set(r)
               else float("inf"))
    return {"loss_gap": loss, "grad_gap": worst("grad_norms"),
            "change_gap": worst("change_norms"), "content_gap": content}


def verdict(numbers, limits):
    """True when every number is finite and within its limit."""
    return all(numbers[k] == numbers[k] and numbers[k] <= limits[k]
               for k in NUMBERS)
