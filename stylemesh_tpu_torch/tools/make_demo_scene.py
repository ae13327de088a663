"""Build the synthetic demo room in ScanNet layout for end-to-end runs
(counterpart of ``tools/make_demo_scene.py``, with its arguments): a thin
command over :func:`stylemesh_tpu_torch.data.demo_scene.build_demo_scene`,
which renders the frames and bakes the UV pyramid with the native
rasterizer on the host.

    python -m stylemesh_tpu_torch.tools.make_demo_scene <out_root> [n_views]

Defaults: ``/tmp/demo_room`` and 24 views.
"""

import sys

from stylemesh_tpu_torch.data.demo_scene import build_demo_scene


def main(out_root, n_views=24, pyramid_heights=None):
    return build_demo_scene(out_root, n_views=n_views,
                            pyramid_heights=pyramid_heights)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "/tmp/demo_room",
         int(sys.argv[2]) if len(sys.argv) > 2 else 24)
