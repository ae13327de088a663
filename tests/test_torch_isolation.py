"""The port stands alone and never quietly leaves the card.

- An ``ast`` scan of every file of ``stylemesh_tpu_torch/`` (its
  ``tools/`` included) and of ``chip_smoke.py`` finds no import of jax,
  optax, flax or stylemesh_tpu (``sys.modules`` cannot show this: the test
  process imports jax; ``tests/test_torch_tools.py`` runs the tools where
  ``import jax`` fails).
- Entry points default to CUDA and raise when it is absent; the plain
  versions serve CPU tensors only, and a tensor on any other device goes to
  the kernel path, which checks its inputs and raises instead of falling back.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from stylemesh_tpu_torch import kernels, resolve_device
from stylemesh_tpu_torch.convert import batch_from_numpy
from stylemesh_tpu_torch.data.synthetic import synthetic_view_batch
from stylemesh_tpu_torch.models.pipeline import PipelineConfig, TexturePipeline
from stylemesh_tpu_torch.models.texture import Texture
from stylemesh_tpu_torch.models.vgg import init_vgg_params
from stylemesh_tpu_torch.ops import conv_kernels, gram_kernels, head_kernels
from stylemesh_tpu_torch.ops import grid_sample as gs

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "optax", "flax", "stylemesh_tpu"}


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_port_imports_no_jax():
    files = sorted((ROOT / "stylemesh_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    # the command-line tools, which a user runs where there is no JAX
    assert {"convert_vgg.py", "convert_lpips.py", "make_demo_scene.py"} <= {
        p.name for p in files if p.parent.name == "tools"}
    for path in files:
        bad = FORBIDDEN.intersection(_imported_roots(path))
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_kernel_sources_present():
    sources = sorted(p.name for p in kernels.CSRC.glob("*.cu"))
    assert sources == ["adam.cu", "conv_gemm.cu", "conv_pool_bwd.cu",
                       "conv_stem.cu", "gram.cu", "sample.cu"]
    headers = sorted(p.name for p in kernels.CSRC.glob("*.cuh"))
    assert headers == ["conv_core.cuh"]
    assert "-gencode=arch=compute_90a,code=sm_90a" in kernels.CUDA_FLAGS


def test_trunk_kernels_on_the_wgmma_core():
    """The trunk's conv kernels (K5-K9) share conv_core.cuh's wgmma
    mainloop; none uses the legacy WMMA fragments."""
    for name in ("conv_core.cuh", "conv_gemm.cu", "conv_pool_bwd.cu"):
        text = (kernels.CSRC / name).read_text()
        assert "wmma" not in text and "mma.h" not in text, name
        assert "wgmma.mma_async" in text or '#include "conv_core.cuh"' in text


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(monkeypatch):
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        synthetic_view_batch()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_vgg_params()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Texture.create(8, 8)
    batch = synthetic_view_batch(numpy_arrays=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        batch_from_numpy(batch)
    cfg = PipelineConfig(steps_per_epoch=1, texture_width=8, texture_height=8,
                         hierarchical_layers=1)
    vgg = init_vgg_params(device="cpu")
    style = torch.zeros((1, 16, 16, 3))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TexturePipeline(cfg, vgg, style)
    assert resolve_device("cpu") == torch.device("cpu")


def _launch_counts():
    return (gs.gather_levels.launches, gs.splat_levels.launches,
            gram_kernels.masked_gram_sums.launches,
            gram_kernels.masked_gram_sums_grad.launches,
            conv_kernels.conv3x3.launches, head_kernels.conv_relu_pool.launches,
            head_kernels.conv_relu_pool.dual_launches,
            head_kernels.conv_relu_pool.switch_launches,
            head_kernels.conv_relu_pool_bwd.launches)


def _conv_inputs(device, c=64, h=6, w=7):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(1, h, w, c)).astype(np.float32))
    weight = torch.from_numpy(rng.normal(0, 0.05, (c, c, 3, 3)).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 0.05, (c,)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(1, h // 2, w // 2, c)).astype(np.float32))
    return (x.to(device, torch.bfloat16),
            conv_kernels.w9_from_oihw(weight).to(device),
            conv_kernels.flipped_w9_from_oihw(weight).to(device), b.to(device),
            g.to(device, torch.bfloat16))


def test_non_cpu_tensors_never_take_the_plain_version():
    """A tensor that is not on the CPU goes to the kernel path, whose input
    checks refuse anything but CUDA tensors; no launch is counted."""
    before = _launch_counts()
    meta = torch.device("meta")
    grid = torch.zeros((1, 4, 4, 2), device=meta)
    layer = torch.zeros((8, 8, 3), device=meta)
    with pytest.raises(ValueError, match="CUDA"):
        gs.gather_levels([layer], [grid])
    with pytest.raises(ValueError, match="CUDA"):
        gs.splat_levels([torch.zeros((1, 4, 4, 3), device=meta)], [grid],
                        [(8, 8)])
    f = torch.zeros((1, 16, 64), dtype=torch.bfloat16, device=meta)
    m = torch.zeros((1, 2, 16), dtype=torch.bfloat16, device=meta)
    with pytest.raises(ValueError, match="CUDA"):
        gram_kernels.masked_gram_sums(f, m)
    with pytest.raises(ValueError, match="CUDA"):
        gram_kernels.masked_gram_sums_grad(f, m, torch.zeros((1, 2, 64, 64),
                                                             device=meta))
    x, w9, w9t, b, g = _conv_inputs(meta)
    with pytest.raises(ValueError, match="CUDA"):
        conv_kernels.conv3x3(x, w9, b, relu=True)
    with pytest.raises(ValueError, match="CUDA"):
        head_kernels.conv_relu_pool(x, w9, b)
    with pytest.raises(ValueError, match="CUDA"):
        head_kernels.conv_relu_pool(x, w9, b, with_pre=True)
    with pytest.raises(ValueError, match="CUDA"):
        head_kernels.conv_relu_pool(x, w9, b, with_codes=True)
    codes = torch.zeros(g.shape[:3] + (8,), dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="CUDA"):
        head_kernels.conv_relu_pool_bwd(codes, g, w9t, x.shape[1:3])
    assert _launch_counts() == before


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(0)
    layers = [torch.from_numpy(rng.normal(size=(8, 8, 3)).astype(np.float32))]
    grid = torch.from_numpy(rng.uniform(-1, 1, (1, 3, 3, 2)).astype(np.float32))
    before = _launch_counts()
    torch.testing.assert_close(gs.gather_levels(layers, [grid]),
                               gs.gather_levels_plain(layers, [grid]))
    x, w9, w9t, b, g = _conv_inputs("cpu")
    for relu in (True, False):
        assert torch.equal(conv_kernels.conv3x3(x, w9, b, relu=relu),
                           conv_kernels.conv3x3_plain(x, w9, b, relu))
    assert torch.equal(head_kernels.conv_relu_pool(x, w9, b),
                       head_kernels.conv_relu_pool_plain(x, w9, b))
    for got, want in zip(head_kernels.conv_relu_pool(x, w9, b, with_pre=True),
                         head_kernels.conv_relu_pool_plain(x, w9, b, True)):
        assert torch.equal(got, want)
    pooled, codes = head_kernels.conv_relu_pool(x, w9, b, with_codes=True)
    for got, want in zip((pooled, codes),
                         head_kernels.conv_relu_pool_plain(x, w9, b,
                                                           with_codes=True)):
        assert torch.equal(got, want)
    hw = tuple(x.shape[1:3])
    assert torch.equal(head_kernels.conv_relu_pool_bwd(codes, g, w9t, hw),
                       head_kernels.conv_relu_pool_bwd_plain(codes, g, w9t, hw))
    assert _launch_counts() == before


def test_slice3_entry_points_stay_on_the_card(monkeypatch, tmp_path):
    """The run loop and the CLI default to CUDA and raise without it before
    writing anything; the bf16 mode of K1/K2 and K9 refuse tensors that are
    not on the CPU or a card, counting no launch; the multi-device modes
    (ported since) refuse the JAX package's exclusive combinations before
    anything starts."""
    from stylemesh_tpu_torch import cli, optimize

    before = (gs.gather_levels.bf16_launches, gs.splat_levels.bf16_launches,
              conv_kernels.conv3x3_mxu.launches)
    meta = torch.device("meta")
    grid = torch.zeros((1, 4, 4, 2), device=meta)
    with pytest.raises(ValueError, match="CUDA"):
        gs.gather_levels([torch.zeros((8, 8, 3), device=meta)], [grid], "bf16")
    with pytest.raises(ValueError, match="CUDA"):
        gs.splat_levels([torch.zeros((1, 4, 4, 3), device=meta)], [grid],
                        [(8, 8)], "bf16")
    x, w9, _, _, _ = _conv_inputs(meta)
    with pytest.raises(ValueError, match="CUDA"):
        conv_kernels.conv3x3_mxu(x, w9)
    assert (gs.gather_levels.bf16_launches, gs.splat_levels.bf16_launches,
            conv_kernels.conv3x3_mxu.launches) == before

    with pytest.raises(ValueError, match="exclusive"):
        optimize._check_modes(optimize.RunConfig(data_parallel=True,
                                                 shard_atlas=True))
    with pytest.raises(ValueError, match="style axis"):
        optimize._check_modes(optimize.RunConfig(
            shard_atlas=True, extra_style_paths=("b.jpg",)))
    optimize._check_modes(optimize.RunConfig(data_parallel=True))

    _no_cuda(monkeypatch)
    log_dir = tmp_path / "runs"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        optimize.run_training(optimize.RunConfig(log_dir=str(log_dir)),
                              PipelineConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--no_post_steps", "--log_dir", str(log_dir)])
    assert not log_dir.exists()


def test_parallel_entry_points_stay_on_the_card(monkeypatch):
    """The banded K1/K2 refuse tensors that are neither on the CPU nor on a
    card, counting no launch; a torchrun rank asks for a card unless told
    to use the CPU, and raises without one; the modules of ``parallel/``
    are among the files the import scan covers."""
    from stylemesh_tpu_torch.parallel import mesh

    names = {p.relative_to(ROOT / "stylemesh_tpu_torch").as_posix()
             for p in (ROOT / "stylemesh_tpu_torch").rglob("*.py")}
    assert {"parallel/__init__.py", "parallel/mesh.py", "parallel/atlas.py",
            "parallel/train.py", "parallel/multistyle.py"} <= names
    before = gs.launch_counts()
    meta = torch.device("meta")
    grid = torch.zeros((1, 4, 4, 2), device=meta)
    for compute in ("f32", "bf16"):
        with pytest.raises(ValueError, match="CUDA"):
            gs.gather_levels([torch.zeros((4, 8, 3), device=meta)], [grid],
                             compute, band=([4], [8]))
        with pytest.raises(ValueError, match="CUDA"):
            gs.splat_levels([torch.zeros((1, 4, 4, 3), device=meta)], [grid],
                            [(4, 8)], compute, band=([4], [8]))
    assert gs.launch_counts() == before
    assert mesh.init_from_env("cpu").device == torch.device("cpu")
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh.init_from_env()
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh.init_from_env()


def test_post_chain_entry_points_stay_on_the_card(monkeypatch, tmp_path):
    """The post chain's and the tools' entry points default to CUDA and
    raise without it before writing anything; their modules are among the
    files the import scan covers."""
    import importlib

    from stylemesh_tpu_torch import optimize
    from stylemesh_tpu_torch.eval import circles, reprojection

    mask_texture = importlib.import_module(
        "stylemesh_tpu_torch.texturing.mask_texture")
    names = {p.relative_to(ROOT / "stylemesh_tpu_torch").as_posix()
             for p in (ROOT / "stylemesh_tpu_torch").rglob("*.py")}
    assert {"geometry/project.py", "eval/lpips.py", "eval/reprojection.py",
            "eval/__main__.py", "eval/circles.py", "texturing/video.py",
            "texturing/mask_texture.py", "texturing/mask_image.py",
            "utils/tb_events.py"} <= names
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        optimize.build_lpips()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        reprojection.eval_reprojection_consistency(None, str(tmp_path / "s"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        circles.measure_circles_for_scene(None, str(tmp_path / "s"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mask_texture.compute_texture_mask([], [], (4, 4))
    assert not (tmp_path / "s").exists()


def test_preprocess_entry_points_stay_on_the_card(monkeypatch, tmp_path):
    """The preprocessing and capture modules are among the files the import
    scan covers; the torch rasterizer and the torch bake default to CUDA and
    raise without it before writing anything; an unknown backend raises
    instead of falling back to another rasterizer; the native library is
    built under build/native."""
    from stylemesh_tpu_torch import preprocess
    from stylemesh_tpu_torch.geometry import native, rasterize

    names = {p.relative_to(ROOT / "stylemesh_tpu_torch").as_posix()
             for p in (ROOT / "stylemesh_tpu_torch").rglob("*.py")}
    assert {"geometry/mesh_io.py", "geometry/trajectories.py",
            "geometry/native.py", "geometry/rasterize.py",
            "geometry/unwrap.py", "geometry/segmentation.py",
            "preprocess.py", "capture.py", "create_uvs.py",
            "data/demo_scene.py", "data/matterport_house.py", "data/sens.py",
            "data/filters.py"} <= names
    assert native.BUILD_DIR == ROOT / "build" / "native"
    quad = (np.zeros((3, 3), np.float32), np.array([[0, 1, 2]], np.int32),
            np.zeros((3, 2), np.float32), np.zeros((3, 3), np.float32),
            np.eye(4, dtype=np.float32), np.eye(3, dtype=np.float32), (4, 4))
    with pytest.raises(ValueError, match="unknown rasterizer backend"):
        preprocess.bake_view(None, quad[4], quad[5], quad[6], backend="jax")
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rasterize.rasterize_mesh(*quad)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        preprocess.bake_scene(str(tmp_path / "m.ply"), str(tmp_path),
                              np.eye(3), (4, 4), str(tmp_path / "out"),
                              backend="torch")
    assert not (tmp_path / "out").exists()
