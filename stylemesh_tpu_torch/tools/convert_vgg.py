"""Convert the reference's Gatys VGG weights (``vgg_conv.pth``, a torch
state dict of 16 convs), or torchvision's vgg16 checkpoint, to the ``.npz``
that both packages' ``load_vgg_params`` read (counterpart of
``tools/convert_vgg.py``, with its arguments and output).

    python -m stylemesh_tpu_torch.tools.convert_vgg vgg_conv.pth vgg_conv.npz
    python -m stylemesh_tpu_torch.tools.convert_vgg --torchvision vgg16-*.pth vgg16.npz
"""

import argparse

from stylemesh_tpu_torch.models.vgg import (
    convert_torch_state_dict,
    save_vgg_params,
)

# torchvision vgg16 'features' indices of the 13 convs, in trunk order
_TORCHVISION_CONV_IDX = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
_GATYS_NAMES_13 = [
    "conv1_1", "conv1_2", "conv2_1", "conv2_2",
    "conv3_1", "conv3_2", "conv3_3",
    "conv4_1", "conv4_2", "conv4_3",
    "conv5_1", "conv5_2", "conv5_3",
]


def torchvision_to_gatys(sd):
    """A torchvision vgg16 state dict as the Gatys net's 16 convs: the 13
    convs by name, and ``conv*_4`` copied from ``conv*_3`` (vgg16 has none),
    so the trunk stays runnable; losses should then select no ``*_4``
    layer."""
    mapped = {}
    for name, idx in zip(_GATYS_NAMES_13, _TORCHVISION_CONV_IDX):
        mapped[f"{name}.weight"] = sd[f"features.{idx}.weight"].numpy()
        mapped[f"{name}.bias"] = sd[f"features.{idx}.bias"].numpy()
    for blk in (3, 4, 5):
        mapped[f"conv{blk}_4.weight"] = mapped[f"conv{blk}_3.weight"]
        mapped[f"conv{blk}_4.bias"] = mapped[f"conv{blk}_3.bias"]
    return mapped


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--torchvision", action="store_true",
                   help="src is a torchvision vgg16 state dict (13 convs; "
                        "the Gatys net's conv*_4 layers are absent and get "
                        "copied from conv*_3 — only use the first three convs "
                        "per block for losses in that case)")
    args = p.parse_args(argv)

    import torch

    sd = torch.load(args.src, map_location="cpu", weights_only=True)
    if args.torchvision:
        sd = torchvision_to_gatys(sd)
    save_vgg_params(convert_torch_state_dict(sd, device="cpu"), args.dst)
    print(f"wrote {args.dst}")


if __name__ == "__main__":
    main()
