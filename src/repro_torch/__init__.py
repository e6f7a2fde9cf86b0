"""PyTorch / CUDA port of the ``repro`` package, written for one NVIDIA H100.

Same sub-package layout and function names as the JAX package, so a reader
finds each counterpart.  Imports ``torch``, numpy and the standard library
only; hand-written CUDA kernels live in ``kernels/csrc`` and are built at
first use.
"""
