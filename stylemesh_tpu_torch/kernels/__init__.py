"""Builds and loads the hand-written Hopper kernels of ``kernels/csrc``.

All sources are compiled in one call of ``torch.utils.cpp_extension.load``
for ``sm_90a`` at first use, into ``build/torch_ext`` at the root of the
checkout. The sources expose a plain C interface and include no PyTorch
header (that keeps the build to seconds); they are bound with ``ctypes``:
pointers from ``Tensor.data_ptr()``, the stream from PyTorch's current CUDA
stream. Each C entry point returns the launch's ``cudaGetLastError()`` (or,
for a kernel fed by TMA, minus the ``CUresult`` of a tensor map that could
not be encoded), and :func:`launch` raises when it is not 0.

Nothing here runs at import: the CPU tests import every module.
"""

import ctypes
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_ext"
NAME = "stylemesh_tpu_torch_kernels"
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry point -> argument types (every entry point returns an int status)
_SIGNATURES = {
    # level table (grids, outputs or cotangents, pixel counts), levels,
    # layer table (ptrs, hs, ws, h_globals, row0s; the last two NULL
    # unbanded), layers, bf16
    "stylemesh_gather": [_P] * 3 + [_I] + [_P] * 5 + [_I, _I, _P],
    "stylemesh_splat": [_P] * 3 + [_I] + [_P] * 5 + [_I, _I, _P],
    # level table, views, image table (ptrs, hs, ws): one image per level
    "stylemesh_gather_each": [_P] * 3 + [_I] + [_P] * 3 + [_P],
    "stylemesh_gram_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "stylemesh_gram_bwd": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "stylemesh_conv3x3": [_P, _P, _P, _P] + [_I] * 9 + [_P],
    # (x, w9, m, t, y): t may be NULL
    "stylemesh_conv3x3_masked": [_P] * 5 + [_I] * 8 + [_P],
    "stylemesh_conv_relu_pool": [_P, _P, _P, _P, _P] + [_I] * 9 + [_P],
    # (x, w9, w9t, bias, g, t, dx): t may be NULL
    "stylemesh_conv_relu_pool_bwd": [_P] * 7 + [_I] * 5 + [_P],
    # (r, g, dr), V, H, W, C
    "stylemesh_pool_route": [_P] * 3 + [_I] * 4 + [_P],
    # conv1_1: (x, w9, bias, y) and (g, y, w9, dx); V, H, W, relu
    "stylemesh_stem_fwd": [_P] * 4 + [_I] * 4 + [_P],
    "stylemesh_stem_bwd": [_P] * 4 + [_I] * 4 + [_P],
    # layer table (p, g, m, v, element counts as int64, the regularizer's
    # coefficients as float32), layers, scalars {lr, bc1, bc2} on the
    # device; b1, 1 - b1, b2, 1 - b2, eps, lo, hi
    "stylemesh_adam_clamp": [_P] * 6 + [_I, _P] + [_F] * 7 + [_P],
    # layer table (p, element counts as int64, scales as float64), layers,
    # scratch and its length in doubles, the float32 output
    "stylemesh_tex_reg_value": [_P] * 3 + [_I, _P, _I, _P, _P],
}

_library = None


def build():
    """Compile every source of ``csrc`` (cached by content in BUILD_DIR) and
    return the path of the shared library."""
    from torch.utils.cpp_extension import load

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    load(name=NAME, sources=[str(p) for p in sorted(CSRC.glob("*.cu"))],
         build_directory=str(BUILD_DIR), extra_cuda_cflags=CUDA_FLAGS,
         is_python_module=False)
    return BUILD_DIR / f"{NAME}.so"


def library():
    """The loaded kernel library, built at first use."""
    global _library
    if _library is None:
        lib = ctypes.CDLL(str(build()))
        for fn, argtypes in _SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _library = lib
    return _library


def launch(fn, device, *args):
    """Call C entry point ``fn`` on PyTorch's current stream of ``device``;
    raise on a launch error."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = getattr(lib, fn)(*args, stream)
    if status < 0:
        raise RuntimeError(f"{fn}: encoding a TMA tensor map failed with "
                           f"CUresult {-status}")
    if status != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with error {status}")


def require_cuda(*tensors, dtype=None):
    """Raise unless every tensor is a contiguous CUDA tensor (of ``dtype``)
    on one device, 16-byte aligned."""
    device = tensors[0].device
    for t in tensors:
        if t.device != device or t.device.type != "cuda":
            raise ValueError(f"expected CUDA tensors on {device}, got {t.device}")
        if dtype is not None and t.dtype != dtype:
            raise TypeError(f"expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("expected a contiguous tensor")
        if t.data_ptr() % 16:
            raise ValueError("expected a 16-byte aligned tensor")
