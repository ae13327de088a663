"""Camera geometry and meshes: pinhole un/re-projection (``project.py``),
the PyTorch rasterizer (``rasterize.py``), mesh I/O, trajectories, unwrap,
segmentation and the native rasterizer's loader."""

from stylemesh_tpu_torch.geometry.project import reproject, unproject
from stylemesh_tpu_torch.geometry.rasterize import rasterize_mesh

__all__ = ["unproject", "reproject", "rasterize_mesh"]
