from .mesh import BATCH_KEY_KINDS, Mesh, make_ray_mesh, make_train_mesh, shard_batch
from .pipeline import RenderPipeline

__all__ = ["BATCH_KEY_KINDS", "Mesh", "RenderPipeline", "make_ray_mesh", "make_train_mesh",
           "shard_batch"]
