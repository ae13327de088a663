"""LPIPS-style perceptual distance (counterpart of
``stylemesh_tpu/eval/lpips.py``).

The reference scores reprojection consistency with ``lpips.LPIPS(net='vgg')``:
RGB in [-1, 1] -> per-channel shift and scale -> VGG-16 features at relu
1_2, 2_2, 3_3, 4_3 and 5_3 -> unit-normalised over channels -> per-channel
learned linear weights -> spatial mean -> sum over the layers.

The trunk is :func:`~stylemesh_tpu_torch.models.vgg.vgg_features` in
float32 at ``precision="highest"`` (on the card cuDNN with TF32 off), as
the JAX package runs it at ``HIGHEST`` outside its TPU kernels; the bf16
kernel trunk would compute another function. Calibrated lin weights load
from an ``.npz`` of the JAX package's layout (:meth:`load_lin_weights`);
without them the distance uses uniform ``1/C`` weights (structurally the
same, uncalibrated, ``calibrated`` False).
"""

from typing import Optional

import numpy as np
import torch

from stylemesh_tpu_torch import resolve_device
from stylemesh_tpu_torch.models.vgg import vgg_features

# LPIPS scaling layer constants (shift/scale on [-1,1] RGB inputs)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# VGG16 activations used by LPIPS, in our layer naming (second conv of each
# block before the pool: relu1_2, 2_2, 3_3, 4_3, 5_3)
LPIPS_LAYERS = ("r12", "r22", "r33", "r43", "r53")


def _unit_normalize(x, eps=1e-10):
    norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    return x / (norm + eps)


class LPIPSDistance:
    """Callable ``d(a, b) -> [B]`` on ``[B, H, W, 3]`` RGB in [0, 1] (numpy
    arrays or tensors), computed on the device of ``vgg_params``.

    Args:
        vgg_params: VGG-16 params (``models/vgg.py``).
        lin_weights: optional dict layer -> ``[C]`` calibrated weights.
    """

    def __init__(self, vgg_params, lin_weights: Optional[dict] = None):
        self.vgg_params = vgg_params
        self.lin_weights = lin_weights
        self.calibrated = lin_weights is not None
        self.device = vgg_params["conv1_1"]["weight"].device

    @staticmethod
    def load_lin_weights(path, device=None):
        data = np.load(path)
        device = resolve_device(device)
        return {k: torch.as_tensor(np.asarray(data[k], np.float32)).to(device)
                for k in LPIPS_LAYERS}

    def _input(self, x):
        x = torch.as_tensor(x, dtype=torch.float32).to(self.device)
        x = x * 2.0 - 1.0  # [0, 1] -> [-1, 1]
        shift = torch.tensor(_SHIFT, device=self.device)
        scale = torch.tensor(_SCALE, device=self.device)
        return (x - shift) / scale

    @torch.no_grad()
    def __call__(self, a, b):
        fa = vgg_features(self.vgg_params, self._input(a), LPIPS_LAYERS,
                          precision="highest")
        fb = vgg_features(self.vgg_params, self._input(b), LPIPS_LAYERS,
                          precision="highest")
        total = 0.0
        for k in LPIPS_LAYERS:
            diff = (_unit_normalize(fa[k]) - _unit_normalize(fb[k])) ** 2
            if self.lin_weights is not None:
                layer_d = torch.mean(torch.sum(diff * self.lin_weights[k],
                                               dim=-1), dim=(1, 2))
            else:  # uncalibrated: uniform 1/C weights
                layer_d = torch.mean(torch.mean(diff, dim=-1), dim=(1, 2))
            total = total + layer_d
        return total  # [B]
