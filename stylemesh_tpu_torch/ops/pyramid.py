"""Image pyramids for the style targets (counterpart of
``stylemesh_tpu/ops/pyramid.py``).

Level ``l`` is the image bilinearly downsampled by ``2**l``, floored at a
minimum size (aspect-preserving); ``reverse`` flips the pyramid up to the
first minimum entry and fills the remaining slots with the original image.
"""

from stylemesh_tpu_torch.ops.resize import resize_bilinear


def pyramid_shapes(h, w, levels, minimum_size=256):
    """Shape plan: list of (h, w) per level plus the min-entry index."""
    shapes = []
    min_shape = None
    min_index = len(levels)
    for i, level in enumerate(levels):
        if level == 0:
            shapes.append((h, w))
            continue
        h_down = int(h / 2 ** level)
        w_down = int(w / 2 ** level)
        if h_down < minimum_size or w_down < minimum_size:
            if min_shape is None:
                if w > h:
                    min_shape = (minimum_size, int(w * minimum_size / h))
                else:
                    min_shape = (int(h * minimum_size / w), minimum_size)
                min_index = i
            shapes.append(min_shape)
        else:
            shapes.append((h_down, w_down))
    return shapes, min_index


def image_pyramid(img, levels, reverse=False, minimum_size=256):
    """Build the pyramid as a list of tensors (``img``: ``[B, H, W, C]``)."""
    h, w = img.shape[-3], img.shape[-2]
    shapes, min_index = pyramid_shapes(h, w, levels, minimum_size)
    pyramid = []
    cache = {}
    for i, level in enumerate(levels):
        if level == 0:
            pyramid.append(img)
        else:
            shape = shapes[i]
            if shape not in cache:
                cache[shape] = resize_bilinear(img, shape)
            pyramid.append(cache[shape])
    if reverse:
        rev = pyramid[: min_index + 1][::-1]
        while len(rev) < len(pyramid):
            rev.append(img)
        pyramid = rev
    return pyramid
