"""Image masking (counterpart of ``stylemesh_tpu/texturing/mask_image.py``):
the UV-validity mask applied to styled frames gives RGBA images whose
pixels without a UV mapping are transparent. Host code only.

    # one image and its uv map
    python -m stylemesh_tpu_torch.texturing.mask_image --image f.png --uv f.npy
    # every styled frame of a scene
    python -m stylemesh_tpu_torch.texturing.mask_image --root_path R \\
        --scene scene0000_00 --styled DIR --out DIR_masked
"""

import os
from os.path import join

import numpy as np


def mask_image(image, mask):
    """RGB [H, W, 3] (uint8 or [0,1] float) + mask [H, W] -> RGBA PIL image."""
    from PIL import Image

    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0, 1) * 255 + 0.5).astype(np.uint8)
    alpha = (np.asarray(mask) > 0).astype(np.uint8) * 255
    rgba = np.concatenate([arr, alpha[..., None]], axis=-1)
    return Image.fromarray(rgba, mode="RGBA")


def _fit(img, mask):
    """``img`` resized (bilinear) to the mask's size where they differ."""
    from PIL import Image

    if img.size != (mask.shape[1], mask.shape[0]):
        img = img.resize((mask.shape[1], mask.shape[0]),
                         Image.Resampling.BILINEAR)
    return np.asarray(img)


def mask_images_for_scene(scene_cache, styled_dir, out_dir):
    """Mask every styled frame of a scene with its UV-validity mask."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    b = scene_cache._batch_all
    paths = []
    for p, idx in enumerate(scene_cache.indices):
        img = Image.open(join(styled_dir, f"{idx}.png")).convert("RGB")
        mask = np.asarray(b.mask[p])[..., 0]
        path = join(out_dir, f"{idx}_masked.png")
        mask_image(_fit(img, mask), mask).save(path)
        paths.append(path)
    return paths


def main(argv=None):
    import argparse

    from PIL import Image

    p = argparse.ArgumentParser(description="mask images to RGBA by UV validity")
    p.add_argument("--image", help="single RGB image to mask")
    p.add_argument("--uv", help="uv .npy for --image (channels 0/1 = uv)")
    p.add_argument("--root_path", help="dataset root (scene mode)")
    p.add_argument("--dataset", default="scannet",
                   choices=["scannet", "matterport"])
    p.add_argument("--scene", default="")
    p.add_argument("--styled", help="folder of styled frames (scene mode)")
    p.add_argument("--out", help="output folder (scene mode)")
    p.add_argument("--resize_size", type=int, default=256)
    a = p.parse_args(argv)

    if a.image:
        if not a.uv:
            p.error("--image needs --uv")
        uv = np.load(a.uv)
        mask = (uv[..., 0] != 0) | (uv[..., 1] != 0)
        img = Image.open(a.image).convert("RGB")
        out_path = a.image.rsplit(".", 1)[0] + "_masked.png"
        mask_image(_fit(img, mask), mask).save(out_path)
        print(f"wrote {out_path}")
        return

    if not (a.root_path and a.styled and a.out):
        p.error("scene mode needs --root_path --styled --out")
    from stylemesh_tpu_torch.data.loading import SceneCache
    from stylemesh_tpu_torch.optimize import RunConfig, discover_scene

    run = RunConfig(root_path=a.root_path, dataset=a.dataset, scene=a.scene,
                    min_images=1, resize_size=a.resize_size)
    cache = SceneCache(discover_scene(run), resize_size=a.resize_size)
    paths = mask_images_for_scene(cache, a.styled, a.out)
    print(f"wrote {len(paths)} masked frames to {a.out}")


if __name__ == "__main__":
    main()
