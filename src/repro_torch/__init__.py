"""ColRel in PyTorch: the port of the JAX package ``repro`` to PyTorch and
CUDA on an NVIDIA H100.

The module layout follows ``repro``'s, so each module's counterpart is found
under the same name.  This package imports neither ``jax`` nor ``repro``.
The relay hot spot runs through hand-written CUDA kernels
(``kernels/csrc/``); entry points run on the GPU unless the caller passes
``device="cpu"``.
"""
