"""PyTorch + CUDA port of ``stylemesh_tpu`` for NVIDIA Hopper (H100).

The package mirrors the JAX package's module names (``data/``, ``ops/``,
``models/``) and keeps its public layouts: images and features channel-last
``[V, H, W, C]``, texture layers ``[H_l, W_l, 3]``, sampling grids
``[V, H, W, 2]`` with ``(x, y)`` in ``[-1, 1]``.

Entry points take an explicit ``device`` that defaults to CUDA and raise when
no card is present (:func:`resolve_device`). The hand-written kernels live in
``kernels/csrc`` and are built at first use; each has a plain PyTorch version
beside it that serves tensors on the CPU only.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` or CUDA; raises when CUDA is asked for and absent (the port
    never moves itself to the CPU — a caller who wants the CPU says so)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "stylemesh_tpu_torch: CUDA is not available; pass device='cpu' "
            "explicitly to run the plain PyTorch versions")
    return device
