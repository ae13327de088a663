"""Convert the pip ``lpips`` package's calibrated linear weights (vgg
variant) to the ``.npz`` that ``eval/lpips.py::LPIPSDistance.
load_lin_weights`` reads (counterpart of ``tools/convert_lpips.py``, with
its arguments and output).

    python -m stylemesh_tpu_torch.tools.convert_lpips <lpips_vgg.pth> out.npz

The state dict keys are ``lin{0..4}.model.1.weight`` with shapes
``[1, C, 1, 1]``.
"""

import argparse

import numpy as np

from stylemesh_tpu_torch.eval.lpips import LPIPS_LAYERS


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("src", help="lpips state dict (.pth)")
    p.add_argument("dst")
    args = p.parse_args(argv)

    import torch

    sd = torch.load(args.src, map_location="cpu", weights_only=True)
    out = {}
    for i, layer in enumerate(LPIPS_LAYERS):
        w = sd[f"lin{i}.model.1.weight"].numpy()
        out[layer] = np.squeeze(w).astype(np.float32)  # [C]
    np.savez(args.dst, **out)
    print(f"wrote {args.dst}: " + ", ".join(
        f"{k}[{v.shape[0]}]" for k, v in out.items()))


if __name__ == "__main__":
    main()
