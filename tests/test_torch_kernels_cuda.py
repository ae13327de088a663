"""The hand-written kernels against their plain versions on a CUDA card, at
edge shapes the main path does not reach (one mask, ragged pixel counts,
one to eight texture layers, all-zero cotangents).

Needs a Hopper card (the kernels are built for sm_90a); skips elsewhere.
On the card, without JAX installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q

Tolerances, relative to the plain output's largest value: sampling 1e-5
(float32, fused multiply-adds), splat 1e-5 (float32 atomics order), Gram
sums 1e-4 (float32 sums in another order), Gram gradient two bf16 ulps.
"""

import pytest
import torch

from stylemesh_tpu_torch.ops import gram_kernels
from stylemesh_tpu_torch.ops import grid_sample as gs

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
    _close(gs.gather_layers(layers, grid), gs.gather_layers_plain(layers, grid),
           1e-5)
    g = torch.randn((2, 13, 17, 3), generator=gen, device=cuda)
    g[:, 5:] = 0.0  # skipped pixels
    shapes = [tuple(l.shape[:2]) for l in layers]
    _close(gs.splat_layers(g, grid, shapes),
           gs.splat_layers_plain(g, grid, shapes), 1e-5)
    zero = gs.splat_layers(torch.zeros_like(g), grid, shapes)
    assert all(z.abs().max().item() == 0.0 for z in zero)


def test_sampling_autograd_matches_cpu(cuda):
    gen = torch.Generator().manual_seed(0)
    layers = [torch.randn((32 >> l, 48 >> l, 3), generator=gen) for l in range(3)]
    grid = torch.rand((2, 9, 11, 2), generator=gen) * 2 - 1
    ct = torch.randn((2, 9, 11, 3), generator=gen)
    results = []
    for device in ("cpu", cuda):
        ls = [l.to(device).requires_grad_() for l in layers]
        out = gs.sample_layers(ls, grid.to(device))
        grads = torch.autograd.grad(out, ls, ct.to(device))
        results.append([out.cpu()] + [x.cpu() for x in grads])
    _close(results[1], results[0], 1e-5)


@pytest.mark.parametrize("c,k,p", [(64, 1, 1000), (128, 2, 4097),
                                   (256, 2, 33), (64, 2, 100003)])
def test_masked_gram_sums_and_grad(cuda, c, k, p):
    gen = torch.Generator(device=cuda).manual_seed(c + k + p)
    f = torch.randn((3, p, c), generator=gen, device=cuda).to(torch.bfloat16)
    m = (torch.rand((3, k, p), generator=gen, device=cuda) < 0.5).to(torch.bfloat16)
    m[1] = 0.0  # empty masks: zero Grams, zero gradient rows
    _close(gram_kernels.masked_gram_sums(f, m),
           gram_kernels.masked_gram_sums_plain(f, m), 1e-4)
    assert gram_kernels.masked_gram_sums(f, m)[1].abs().max().item() == 0.0
    dg = torch.randn((3, k, c, c), generator=gen, device=cuda)
    s = dg + dg.transpose(-1, -2)
    _close(gram_kernels.masked_gram_sums_grad(f, m, s),
           gram_kernels.masked_gram_sums_grad_plain(f, m, s), 2 ** -7)


def test_wrappers_refuse_bad_inputs(cuda):
    grid = torch.zeros((1, 4, 4, 2), device=cuda)
    with pytest.raises(TypeError):
        gs.gather_layers([torch.zeros((8, 8, 3), device=cuda,
                                      dtype=torch.float64)], grid)
    with pytest.raises(ValueError):
        gs.gather_layers([torch.zeros((8, 8, 3), device=cuda)] * 9, grid)
    f = torch.zeros((1, 16, 48), dtype=torch.bfloat16, device=cuda)
    m = torch.zeros((1, 1, 16), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="multiple of 64"):
        gram_kernels.masked_gram_sums(f, m)
