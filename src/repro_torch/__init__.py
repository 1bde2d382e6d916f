"""PyTorch/CUDA port of the ``repro`` serving path for NVIDIA Hopper.

The package mirrors ``repro``'s layout (configs / kernels / models / core /
runtime / launch) so each module's counterpart is easy to find.  It imports
``torch``, numpy and the standard library only — never ``jax`` and never
``repro`` — so it runs where JAX is absent.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; the attention kernels are
hand-written CUDA C++ for ``sm_90a`` (``kernels/csrc``), built with nvcc at
first use.  See ``README.md`` in this directory.
"""
