"""Data parallelism over `torch.distributed` (port of
`deepof_tpu/parallel/`): the JAX (data, spatial, time) mesh as a world of
ranks, one device a rank. Spatial and temporal context parallelism
(`deepof_tpu/parallel/spatial.py`) is not ported: ROADMAP Queue A
item 10."""

from .mesh import World, build_mesh, current_world, init_distributed

__all__ = ["World", "build_mesh", "current_world", "init_distributed"]
