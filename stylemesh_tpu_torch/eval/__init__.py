"""The paper's evaluations: reprojection consistency with LPIPS
(``reprojection.py``, ``lpips.py``; the folder CLI ``python -m
stylemesh_tpu_torch.eval``) and the circle-uniformity metric
(``circles.py``)."""

from stylemesh_tpu_torch.eval.lpips import LPIPSDistance
from stylemesh_tpu_torch.eval.reprojection import eval_reprojection_consistency

__all__ = ["eval_reprojection_consistency", "LPIPSDistance"]
