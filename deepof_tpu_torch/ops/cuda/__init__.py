"""CUDA kernels: build helper and one ctypes wrapper per kernel."""
