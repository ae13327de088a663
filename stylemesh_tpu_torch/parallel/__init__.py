from stylemesh_tpu_torch.parallel.mesh import (
    make_mesh,
    replicate_sharding,
    view_batch_sharding,
)
from stylemesh_tpu_torch.parallel.train import ShardedTexturePipeline

__all__ = [
    "make_mesh",
    "replicate_sharding",
    "view_batch_sharding",
    "ShardedTexturePipeline",
]
