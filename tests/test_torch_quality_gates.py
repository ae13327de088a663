"""The two quality gates of ``tests/test_quality_gates.py`` through the
port on the card: self-reproduction PSNR and the circle-uniformity
separation of the paper's Tab. 2, at that file's scene sizes, texture
sizes, steps, configuration and thresholds (``chip_smoke.py`` phase 7
step 4 runs the same functions).

They need no pretrained weights: the objectives' optimum is known with
random VGG weights. Needs a CUDA card; skips elsewhere (on the CPU the
JAX package's own gates, slow-marked, are the reference)::

    python -m pytest --noconftest -m cuda tests/test_torch_quality_gates.py -q
"""

import pytest
import torch

import chip_smoke

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the gates train on K1-K8")
    return "cuda"


def test_self_reproduction_psnr_gate(tmp_path, cuda):
    """Rendered views converge from under 16 dB (gray start) to over 24 dB,
    a gain of more than 9 dB."""
    init_psnr, final_psnr = chip_smoke.self_reproduction_gate(tmp_path, cuda)
    assert init_psnr < 16.0, init_psnr
    assert final_psnr > 24.0, final_psnr
    assert final_psnr > init_psnr + 9.0


def test_circle_uniformity_full_vs_only2d(tmp_path, cuda):
    """Texture-space (3-D uniform) circles against screen-space (2-D
    uniform) ones through optimize, styled render and the circle metric."""
    full, only2d = chip_smoke.circle_gate(tmp_path, cuda)
    assert full["n_circles"] >= 40, full
    assert only2d["n_circles"] >= 60, only2d
    assert full["corr_depth_3D"] < -0.1, full
    assert only2d["corr_depth_3D"] > 0.35, only2d
    assert only2d["corr_depth_3D"] - full["corr_depth_3D"] > 0.7
    assert full["corr_depth_2D"] < -0.4, full
    assert only2d["corr_depth_2D"] > -0.1, only2d
