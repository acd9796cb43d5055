"""Kernels of the port: plain PyTorch versions (``ref``), the Hopper CUDA
kernels' wrappers (``bitmap_intersect``, ``bitmap_diff``, ``compact``,
``suffix_table``, ``nlist_merge``, ``flash_attention``, ``segment_embed``,
built by ``_build`` from ``csrc/``) and the device-dispatching entry points
(``ops``)."""
