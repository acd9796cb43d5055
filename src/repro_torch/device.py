"""Device selection for the port's entry points.

The port runs on the CUDA device by default.  The CPU is used only when
the caller asks for it (``device="cpu"``) — tests do, the mining path
never falls back to it on its own.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; otherwise the named device.

    Raises ``RuntimeError`` when a CUDA device is requested (explicitly
    or by default) and none is available, unless a ``FakeTensorMode`` is
    active (the dry-run traces the card's path without a card: fake
    tensors allocate nothing)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available() \
            and not _faking():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _faking() -> bool:
    from torch._guards import detect_fake_mode
    return detect_fake_mode() is not None
