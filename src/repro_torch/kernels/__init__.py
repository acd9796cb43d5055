"""Kernels of the port: plain PyTorch versions (``ref``), the Hopper CUDA
kernels' wrappers (``bitmap_intersect``, ``compact``, built by
``_build`` from ``csrc/``) and the device-dispatching entry points
(``ops``)."""
