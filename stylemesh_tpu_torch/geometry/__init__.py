"""Camera geometry: pinhole un/re-projection (``project.py``)."""

from stylemesh_tpu_torch.geometry.project import reproject, unproject

__all__ = ["unproject", "reproject"]
