"""Parallelism over `torch.distributed` (port of `deepof_tpu/parallel/`):
the JAX (data, spatial, time) mesh as a world of ranks, one device a rank
(`mesh.py`), and spatial and temporal context parallelism with its
explicit halo exchange (`spatial.py`)."""

from .mesh import World, build_mesh, current_world, init_distributed

__all__ = ["World", "build_mesh", "current_world", "init_distributed"]
