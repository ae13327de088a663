"""Port parity: the port's command-line tools (``stylemesh_tpu_torch/tools``)
against the repository's JAX tools (``tools/convert_vgg.py``,
``tools/convert_lpips.py``, ``tools/make_demo_scene.py``) on the same
inputs.

- ``convert_vgg`` (the reference's Gatys ``vgg_conv.pth`` schema, and
  torchvision's vgg16 schema with ``--torchvision``) and ``convert_lpips``
  run on synthetic state dicts written in the test, with the real files'
  keys, shapes and dtypes (nothing is downloaded): the two tools' ``.npz``
  files are byte-equal, and each package's loader reads them;
- ``make_demo_scene`` at 2 views and one UV height of 32: equal scene
  trees, JPEG frames included;
- every tool runs as ``python -m stylemesh_tpu_torch.tools.<name>`` in a
  process where importing JAX or the JAX package fails.
"""

import runpy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from stylemesh_tpu.eval.lpips import LPIPS_LAYERS as JAX_LPIPS_LAYERS
from stylemesh_tpu.models import vgg as jvgg
from stylemesh_tpu_torch.eval.lpips import LPIPS_LAYERS, LPIPSDistance
from stylemesh_tpu_torch.models import vgg as tvgg
from stylemesh_tpu_torch.tools import convert_lpips, convert_vgg, make_demo_scene
from tests.test_torch_preprocess import assert_same_tree

REPO = Path(__file__).resolve().parents[1]
# torchvision vgg16: 'features' index and (cout, cin) of its 13 convs
TORCHVISION_CONVS = [(0, 64, 3), (2, 64, 64), (5, 128, 64), (7, 128, 128),
                     (10, 256, 128), (12, 256, 256), (14, 256, 256),
                     (17, 512, 256), (19, 512, 512), (21, 512, 512),
                     (24, 512, 512), (26, 512, 512), (28, 512, 512)]
LPIPS_CHANNELS = (64, 128, 256, 512, 512)  # lin0..lin4
NO_JAX = ("import sys; sys.modules.update(dict.fromkeys(('jax', 'jaxlib', "
          "'optax', 'flax', 'stylemesh_tpu'), None)); import runpy; "
          "sys.argv = sys.argv[1:]; "
          "runpy.run_module(sys.argv[0], run_name='__main__', alter_sys=True)")


def _gatys_state_dict(path, seed=0):
    """A state dict shaped as the reference's ``vgg_conv.pth``."""
    rng = np.random.default_rng(seed)
    sd = {}
    for name, cin, cout in tvgg.VGG_CONVS:
        sd[f"{name}.weight"] = torch.from_numpy(rng.normal(
            0, np.sqrt(2.0 / (9 * cin)), (cout, cin, 3, 3)).astype(np.float32))
        sd[f"{name}.bias"] = torch.from_numpy(
            rng.normal(0, 0.05, (cout,)).astype(np.float32))
    torch.save(sd, path)
    return sd


def _torchvision_state_dict(path, seed=1):
    """A state dict shaped as torchvision's vgg16 checkpoint (its
    classifier left out: the converter reads only ``features``)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for idx, cout, cin in TORCHVISION_CONVS:
        sd[f"features.{idx}.weight"] = torch.from_numpy(rng.normal(
            0, 0.05, (cout, cin, 3, 3)).astype(np.float32))
        sd[f"features.{idx}.bias"] = torch.from_numpy(
            rng.normal(0, 0.05, (cout,)).astype(np.float32))
    torch.save(sd, path)
    return sd


def _lpips_state_dict(path, seed=2):
    """The pip lpips package's lin weights: ``lin{i}.model.1.weight``
    ``[1, C, 1, 1]``."""
    rng = np.random.default_rng(seed)
    sd = {f"lin{i}.model.1.weight": torch.from_numpy(
        rng.random((1, c, 1, 1), dtype=np.float32))
        for i, c in enumerate(LPIPS_CHANNELS)}
    torch.save(sd, path)
    return sd


def _run_jax_tool(monkeypatch, name, *args):
    """``python tools/<name> args`` in this process (the tool puts ``.``
    on ``sys.path``; the test restores it)."""
    monkeypatch.setattr(sys, "argv", [name, *args])
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.chdir(REPO)
    runpy.run_path(str(REPO / "tools" / name), run_name="__main__")


@pytest.mark.parametrize("torchvision", [False, True],
                         ids=["gatys", "torchvision"])
def test_convert_vgg_matches_jax_tool(tmp_path, monkeypatch, torchvision):
    """Both modes: byte-equal ``.npz`` files; the port's ``load_vgg_params``
    reads the JAX tool's file as the JAX loader does, OIHW weights
    transposed to HWIO and not scrambled; with ``--torchvision`` the
    ``conv*_4`` layers are copies of ``conv*_3``."""
    src = str(tmp_path / "src.pth")
    sd = (_torchvision_state_dict if torchvision else _gatys_state_dict)(src)
    flag = ["--torchvision"] if torchvision else []
    _run_jax_tool(monkeypatch, "convert_vgg.py", *flag, src,
                  str(tmp_path / "jax.npz"))
    convert_vgg.main([*flag, src, str(tmp_path / "port.npz")])
    assert ((tmp_path / "port.npz").read_bytes()
            == (tmp_path / "jax.npz").read_bytes())

    port = tvgg.load_vgg_params(str(tmp_path / "jax.npz"), device="cpu")
    jax_params = jvgg.load_vgg_params(str(tmp_path / "jax.npz"))
    gatys = convert_vgg.torchvision_to_gatys(sd) if torchvision else sd
    assert list(port) == [name for name, _, _ in tvgg.VGG_CONVS]
    for name, cin, cout in tvgg.VGG_CONVS:
        w = np.asarray(gatys[f"{name}.weight"])
        np.testing.assert_array_equal(port[name]["weight"].numpy(), w)
        np.testing.assert_array_equal(port[name]["bias"].numpy(),
                                      np.asarray(gatys[f"{name}.bias"]))
        np.testing.assert_array_equal(
            np.asarray(jax_params[name]["kernel"]), w.transpose(2, 3, 1, 0))
    if torchvision:
        for blk in (3, 4, 5):
            for k in ("weight", "bias"):
                assert torch.equal(port[f"conv{blk}_4"][k],
                                   port[f"conv{blk}_3"][k])


def test_save_vgg_params_matches_jax(tmp_path):
    """The port's ``save_vgg_params`` writes the JAX package's file for the
    same weights, and both loaders read it back to the same weights."""
    jax_params = jvgg.init_vgg_params(rng=5, he=True)
    port_params = tvgg.init_vgg_params(rng=5, he=True, device="cpu")
    jvgg.save_vgg_params(jax_params, str(tmp_path / "jax.npz"))
    tvgg.save_vgg_params(port_params, str(tmp_path / "port.npz"))
    assert ((tmp_path / "port.npz").read_bytes()
            == (tmp_path / "jax.npz").read_bytes())
    back = tvgg.load_vgg_params(str(tmp_path / "port.npz"), device="cpu")
    jback = jvgg.load_vgg_params(str(tmp_path / "port.npz"))
    for name, _, _ in tvgg.VGG_CONVS:
        for k in ("weight", "bias"):
            assert torch.equal(back[name][k], port_params[name][k])
        np.testing.assert_array_equal(np.asarray(jback[name]["kernel"]),
                                      np.asarray(jax_params[name]["kernel"]))


def test_convert_lpips_matches_jax_tool(tmp_path, monkeypatch):
    """Byte-equal ``.npz`` files of the five ``[C]`` lin weights, which
    ``LPIPSDistance.load_lin_weights`` reads."""
    src = str(tmp_path / "lpips.pth")
    sd = _lpips_state_dict(src)
    _run_jax_tool(monkeypatch, "convert_lpips.py", src,
                  str(tmp_path / "jax.npz"))
    convert_lpips.main([src, str(tmp_path / "port.npz")])
    assert ((tmp_path / "port.npz").read_bytes()
            == (tmp_path / "jax.npz").read_bytes())
    assert LPIPS_LAYERS == JAX_LPIPS_LAYERS
    lin = LPIPSDistance.load_lin_weights(str(tmp_path / "jax.npz"),
                                         device="cpu")
    for i, k in enumerate(LPIPS_LAYERS):
        np.testing.assert_array_equal(
            lin[k].numpy(), sd[f"lin{i}.model.1.weight"].numpy().reshape(-1))


def test_make_demo_scene_matches_jax_tool(tmp_path, monkeypatch):
    """The two tools' ``main`` at 2 views and one UV height of 32 write
    equal scene trees."""
    monkeypatch.setattr(sys, "path", list(sys.path))
    jax_main = runpy.run_path(str(REPO / "tools" / "make_demo_scene.py"))["main"]
    want = jax_main(str(tmp_path / "j"), n_views=2, pyramid_heights=(32,))
    got = make_demo_scene.main(str(tmp_path / "t"), n_views=2,
                               pyramid_heights=(32,))
    assert Path(got).relative_to(tmp_path / "t") == Path(want).relative_to(
        tmp_path / "j")
    assert_same_tree(tmp_path / "j", tmp_path / "t")


def _no_jax(module, *args):
    subprocess.run([sys.executable, "-c", NO_JAX,
                    f"stylemesh_tpu_torch.tools.{module}", *map(str, args)],
                   check=True, cwd=REPO, capture_output=True)


@pytest.mark.parametrize("tool", ["convert_vgg", "convert_vgg_torchvision",
                                  "convert_lpips", "make_demo_scene"])
def test_tools_run_without_jax(tmp_path, tool):
    """``python -m stylemesh_tpu_torch.tools.<name>`` with its command line
    in a process where ``import jax`` and ``import stylemesh_tpu`` fail;
    its output is the in-process tool's."""
    out = tmp_path / "out.npz"
    if tool == "make_demo_scene":
        _no_jax(tool, tmp_path / "room", 1)
        scene = tmp_path / "room" / "train" / "images" / "scene0900_00"
        assert sorted(p.name for p in (scene / "color").iterdir()) == ["0.jpg"]
        assert (tmp_path / "room" / "room_uvs_blender.ply").is_file()
        return
    src = tmp_path / "src.pth"
    if tool == "convert_lpips":
        _lpips_state_dict(src)
        flags, main = [], convert_lpips.main
    else:
        torchvision = tool.endswith("torchvision")
        (_torchvision_state_dict if torchvision else _gatys_state_dict)(src)
        flags = ["--torchvision"] if torchvision else []
        main = convert_vgg.main
    main([*flags, str(src), str(tmp_path / "in.npz")])
    _no_jax(tool.replace("_torchvision", ""), *flags, src, out)
    assert out.read_bytes() == (tmp_path / "in.npz").read_bytes()
