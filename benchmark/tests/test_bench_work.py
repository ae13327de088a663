"""The operation and byte counts of ``work.py`` against hand counts."""

import numpy as np
import torch

from benchmark import work


def test_trunk_flops_by_hand():
    # conv1_1 alone at 4x6: 2 * 9 * 3 * 64 a pixel
    assert work.trunk_flops((4, 6), ["r11"]) == 2 * 9 * 3 * 64 * 24
    # through r21: conv1_1, conv1_2 at 4x6, then conv2_1 at 2x3
    want = (2 * 9 * 3 * 64 + 2 * 9 * 64 * 64) * 24 + 2 * 9 * 64 * 128 * 6
    assert work.trunk_flops((4, 6), ["r11", "r21"]) == want
    # odd sizes floor at each pool
    assert work.trunk_flops((5, 7), ["r21"]) == (
        (2 * 9 * 3 * 64 + 2 * 9 * 64 * 64) * 35 + 2 * 9 * 64 * 128 * 6)


def _views(v=2, h=8, w=8, levels=((8, 8),)):
    ones = torch.ones((v, 1, h, w))
    return {"mask": ones, "rounded": torch.zeros((v, 1, h, w)),
            "other": torch.zeros((v, 1, h, w)),
            "angle_degrees": torch.zeros((v, 1, h, w)),
            "uv": [np.zeros((v,) + lv + (2,), np.float32) for lv in levels],
            "content_hw": (h, w)}


CFG = {"skip_levels": [], "stop_grad_levels": [], "style_layers": ["r11"],
       "content_layers": ["r11"], "style_pyramid_mode": "single",
       "use_depth_scaling": False, "angle_threshold": 30.0}


def test_gram_counts_by_hand():
    cw = work.ChunkWork(_views(), CFG, [(4, 4)])
    (fops, fbytes), (bops, bbytes) = cw.gram_calls()
    live = 2 * 64  # two views of 8x8, every pixel live, one mask
    assert fops == bops == 2 * 64 * 64 * live
    assert fbytes == live * 64 * 2 + 2 * 64 * 2 + 2 * 64 * 64 * 4
    assert bbytes == (live * 64 * 2 + 2 * 64 * 2 + 2 * 64 * 64 * 2
                      + 2 * 64 * 64 * 2)
    # trunk: forward and input gradient at the one level; encode: forward
    assert cw.trunk_step() == 2 * 2 * work.trunk_flops((8, 8), ["r11"])
    assert cw.trunk_chunk() == 2 * work.trunk_flops((8, 8), ["r11"])


def test_render_bytes_by_hand():
    views = _views(v=1, h=2, w=2, levels=((2, 2),))
    # four pixels at the corners of a 3x3 layer: each reads its lower
    # corner texel and the next ones, clamped at the border: (0, 0) reads
    # the 2x2 block at the origin, (0, 2) and (2, 0) a pair each, (2, 2)
    # itself; 9 texels in all
    views["uv"][0][0] = np.array([[[-1, -1], [1, -1]], [[-1, 1], [1, 1]]],
                                 np.float32)
    cw = work.ChunkWork(views, CFG, [(3, 3)])
    assert cw.touched_texels() == 9
    px = 4
    assert cw.render_bytes() == 2 * (px * 5 * 4 + 9 * 12)


def test_bound_takes_the_larger():
    peaks = {"bf16_flop_per_s": 1e12, "hbm_bytes_per_s": 1e9}
    assert work.bound_s(2e12, 1e9, peaks) == 2.0
    assert work.bound_s(1e12, 3e9, peaks) == 3.0
