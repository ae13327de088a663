"""The texture's one-pass update (``ops/adam_kernels.py``) on the CPU.

- The wrapper on CPU tensors is its plain version, bit for bit (p, m and
  v), over several steps with zero gradients and values beyond both clamp
  bounds, at layer sizes whose element counts are and are not multiples of
  four;
- it refuses what the kernel does not take, on the CPU too: a strided
  layer, a float64 one, tensors of two shapes, lists of two lengths, a
  scalars tensor of another size;
- it launches nothing on the CPU: its counter stays 0.

The kernel itself is held to the plain version on a card in
``tests/test_torch_kernels_cuda.py``.
"""

import pytest
import torch

from stylemesh_tpu_torch.ops import adam_kernels
from stylemesh_tpu_torch.ops.adam_kernels import (
    ADAM_B1,
    ADAM_B2,
    adam_clamp_,
    adam_clamp_plain_,
)
from stylemesh_tpu_torch.ops.color import GATYS_MAX, GATYS_MIN


def _state(shapes, seed):
    gen = torch.Generator().manual_seed(seed)
    layers = [torch.rand(s, generator=gen) * (GATYS_MAX - GATYS_MIN + 20)
              + (GATYS_MIN - 10) for s in shapes]
    mus = [torch.randn(s, generator=gen) for s in shapes]
    nus = [torch.rand(s, generator=gen) for s in shapes]
    return layers, mus, nus


def _grads(shapes, gen):
    """Gradients over six decades, a third of them exactly zero."""
    out = []
    for s in shapes:
        g = torch.randn(s, generator=gen) * 10.0 ** (
            torch.rand(s, generator=gen) * 6 - 3)
        out.append(g * (torch.rand(s, generator=gen) > 1 / 3))
    return out


def _scalars(step, lr=1.0):
    return torch.tensor([lr, 1.0 - ADAM_B1 ** (step + 1),
                         1.0 - ADAM_B2 ** (step + 1)], dtype=torch.float32)


def _clones(ts):
    return [t.clone() for t in ts]


@pytest.mark.parametrize("shapes", [[(16, 16, 3), (8, 8, 3)],
                                    [(5, 7, 3)],
                                    [(33, 17, 3), (16, 8, 3), (8, 4, 3),
                                     (4, 2, 3)]])
def test_wrapper_is_the_plain_version_on_the_cpu(shapes):
    layers, mus, nus = _state(shapes, seed=len(shapes))
    want_p, want_m, want_v = (_clones(ts) for ts in (layers, mus, nus))
    gen = torch.Generator().manual_seed(7)
    for step in range(5):
        grads = _grads(shapes, gen)
        scalars = _scalars(step, lr=10.0 if step < 3 else 1.0)
        adam_clamp_(layers, grads, mus, nus, scalars)
        adam_clamp_plain_(want_p, grads, want_m, want_v, scalars)
    for got, ref in zip((layers, mus, nus), (want_p, want_m, want_v)):
        for g, w in zip(got, ref):
            assert torch.equal(g, w)
    # both bounds were reached, and held
    flat = torch.cat([l.flatten() for l in layers])
    assert float(flat.min()) == pytest.approx(GATYS_MIN)
    assert float(flat.max()) == pytest.approx(GATYS_MAX)


def _bad_inputs(which):
    layers, mus, nus = _state([(8, 8, 3), (4, 4, 3)], seed=0)
    grads = [torch.zeros_like(l) for l in layers]
    scalars = _scalars(0)
    if which == "strided":
        layers[1] = torch.zeros(4, 4, 3).transpose(0, 1)
    elif which == "float64":
        layers[0] = layers[0].double()
    elif which == "shapes":
        grads[1] = torch.zeros(4, 5, 3)
    elif which == "lengths":
        nus = nus[:1]
    elif which == "scalars":
        scalars = scalars[:2]
    return layers, grads, mus, nus, scalars


@pytest.mark.parametrize("which,error,match", [
    ("strided", ValueError, "contiguous"),
    ("float64", TypeError, "float32"),
    ("shapes", ValueError, "shape"),
    ("lengths", ValueError, "moments"),
    ("scalars", ValueError, "scalars")])
def test_wrapper_refuses_bad_inputs(which, error, match):
    args = _bad_inputs(which)
    before = [t.clone() for t in args[0] + args[2]]
    with pytest.raises(error, match=match):
        adam_clamp_(*args)
    # nothing was updated
    assert all(torch.equal(a, b) for a, b in zip(args[0] + args[2], before))


def test_no_launch_on_the_cpu():
    shapes = [(16, 16, 3), (8, 8, 3)]
    layers, mus, nus = _state(shapes, seed=3)
    before = adam_kernels.adam_clamp_.launches
    adam_clamp_(layers, _grads(shapes, torch.Generator().manual_seed(0)),
                mus, nus, _scalars(0))
    assert adam_kernels.adam_clamp_.launches == before == 0
