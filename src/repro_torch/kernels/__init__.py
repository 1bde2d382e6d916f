"""Hand-written Hopper kernels of the serving path and their dispatch.

Per kernel: ``<name>.py`` holds the plain PyTorch version and the ctypes
launcher of ``csrc/<name>.cu``; ``ops.py`` is the public API that picks one
by device; ``_build.py`` compiles the CUDA sources with nvcc at first use.
"""
