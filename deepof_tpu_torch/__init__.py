"""deepof_tpu_torch: the PyTorch/CUDA port of deepof_tpu.

The JAX package `deepof_tpu` stays beside it as the reference each part
of the port is tested against. This package imports neither JAX nor
anything of `deepof_tpu`. Importing it loads nothing heavy; the CUDA
kernels are built at first use (`ops/cuda/build.py`).
"""

__version__ = "0.1.0"
