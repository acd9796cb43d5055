"""PyTorch + CUDA port of the early-stopping bitmap miner.

The JAX package ``repro`` is the reference; this package mirrors its
module layout (``repro_torch.core.eclat`` <-> ``repro.core.eclat`` and
so on) and holds itself to it bit for bit.  Entry points run on the
CUDA device unless the caller passes ``device="cpu"``; on the card the
mining hot path goes through the hand-written Hopper kernels under
``csrc/`` (built at first use by ``kernels._build``), on the CPU through
their plain PyTorch versions in ``kernels.ref``.

Nothing here imports ``jax`` or ``repro``.
"""
